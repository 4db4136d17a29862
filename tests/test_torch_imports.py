"""Import hygiene: senas_torch (every module: the search path's, the fixed
model's train and test paths', K2's, the operations layer's: serving,
checkpoint import, the challenge tools; the PROMISE12 data path's; the
other shipped configs' loaders, with their PNG, TIFF and DICOM readers; the
generic loaders with the JPEG decoder and Pillow's resampling; the long
tail: the legacy blocks, customize, the SOM, visualize, the two user
tools) and chip_smoke.py load nothing of JAX, flax, optax or senas_tpu, and neither
cv2 nor PIL, which the port does not depend on (checked in a fresh
interpreter)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import senas_torch
for m in pkgutil.walk_packages(senas_torch.__path__, "senas_torch."):
    importlib.import_module(m.name)
import chip_smoke  # module-level code only; main() does not run
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "senas_tpu", "cv2", "PIL"))
print("BAD", bad)
print("N", len([m for m in sys.modules if m.startswith("senas_torch.")]))
print("FIXED", sorted(m for m in sys.modules if m in FIXED_PATH))
"""

# the modules of the fixed model's path, K2 and the operations layer, named so
# that a module that stops being importable (or is moved) fails here
FIXED_PATH = ("senas_torch.ops.norm_convs", "senas_torch.models.geno_searched",
              "senas_torch.models.senas_model", "senas_torch.models.factory",
              "senas_torch.runner.train", "senas_torch.runner.test",
              "senas_torch.train_model", "senas_torch.testing_model",
              # the operations layer
              "senas_torch.data.io", "senas_torch.challenge", "senas_torch.challenge.promise12",
              "senas_torch.challenge.nerve", "senas_torch.serve", "senas_torch.export_model",
              "senas_torch.compat", "senas_torch.compat.torch_import",
              "senas_torch.import_torch_checkpoint",
              # the PROMISE12 data path
              "senas_torch.data.imgproc", "senas_torch.data.augment",
              "senas_torch.data.promise12", "senas_torch.data.native",
              "senas_torch.data.native.build", "senas_torch.data.legacy_promise12",
              # the loaders of the other shipped configs
              "senas_torch.data.imfile", "senas_torch.data.dicom",
              "senas_torch.data.png_datasets", "senas_torch.data.msd",
              "senas_torch.data.monusac", "senas_torch.utils.misc",
              # the generic loaders, JPEG and Pillow's resampling
              "senas_torch.data.generic", "senas_torch.data.pilresample",
              # data parallelism
              "senas_torch.parallel", "senas_torch.parallel.mesh",
              "senas_torch.parallel.collectives", "senas_torch.parallel.launch",
              # the long tail
              "senas_torch.som", "senas_torch.ops.resize", "senas_torch.utils.legacy_blocks",
              "senas_torch.utils.customize", "senas_torch.utils.visualize",
              "senas_torch.calc_mean_std", "senas_torch.cell_visualize", "senas_torch._exports")


def test_port_imports_nothing_of_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    probe = f"FIXED_PATH = {FIXED_PATH!r}\n" + _PROBE
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("N ")[1].split()[0])
    assert n >= 86, out.stdout  # every module of the port was imported
    assert f"FIXED {sorted(FIXED_PATH)}" in out.stdout, out.stdout
