"""The port is complete: every module of senas_tpu has its counterpart in
senas_torch, every name a senas_tpu `__init__.py` exports is importable
from the same place in senas_torch, and every public class and function
of the long-tail modules (the legacy blocks, customize, the SOM,
visualize, misc, logging, metrics) exists in the port. The modules left
out are listed below, each with its reason."""

import ast
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys

import pytest

import senas_tpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# senas_tpu module -> the port's module of another name
RENAMED = {"senas_tpu.ops.pallas_kernels": "senas_torch.ops.norm_convs"}
# senas_tpu modules with no counterpart, and why
LEFT_OUT = {
    "senas_tpu.utils.files": "`download` fetches from the network, which the port never uses",
    "senas_tpu.utils.compile_cache": "XLA's persistent compilation cache: JAX-only",
    "senas_tpu.data.native.libsenas_native": "a shared library loaded by ctypes, not a "
                                             "Python module (the port builds its own)",
}
# the long-tail modules whose every public class and function is ported
LONG_TAIL = ("senas_tpu.utils.legacy_blocks", "senas_tpu.utils.customize", "senas_tpu.som",
             "senas_tpu.utils.visualize", "senas_tpu.utils.misc", "senas_tpu.utils.logging",
             "senas_tpu.train.metrics")


def _port_name(name: str) -> str:
    return RENAMED.get(name, "senas_torch" + name[len("senas_tpu"):])


def _jax_modules():
    return sorted(m.name for m in pkgutil.walk_packages(senas_tpu.__path__, "senas_tpu."))


def _packages():
    return ["senas_tpu"] + sorted(m.name for m in pkgutil.walk_packages(
        senas_tpu.__path__, "senas_tpu.") if m.ispkg)


def _init_exports(package: str):
    """The names a package's `__init__.py` imports into it from the package
    (what it exports), read from its source."""
    path = importlib.util.find_spec(package).origin
    names = []
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom) and (node.level or (
                node.module or "").startswith("senas_tpu")):
            names += [a.asname or a.name for a in node.names]
    return names


def test_every_module_has_a_counterpart():
    missing = []
    for name in _jax_modules():
        if name in LEFT_OUT:
            continue
        if importlib.util.find_spec(_port_name(name)) is None:
            missing.append(name)
    assert not missing, missing
    for name in LEFT_OUT:
        assert name in _jax_modules(), f"{name} is left out but no longer exists"
        assert importlib.util.find_spec(_port_name(name)) is None


@pytest.mark.parametrize("package", _packages())
def test_every_init_export_has_a_counterpart(package):
    port = importlib.import_module(_port_name(package))
    names = _init_exports(package)
    assert names or package in ("senas_tpu.data.native",), package
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, (package, missing)
    jax_pkg = importlib.import_module(package)
    for n in names:
        j, t = getattr(jax_pkg, n), getattr(port, n)
        assert inspect.ismodule(j) == inspect.ismodule(t), n
        assert inspect.isclass(j) == inspect.isclass(t), n


@pytest.mark.parametrize("module", LONG_TAIL)
def test_every_long_tail_name_has_a_counterpart(module):
    jax_mod = importlib.import_module(module)
    port = importlib.import_module(_port_name(module))
    public = [k for k, v in vars(jax_mod).items() if not k.startswith("_")
              and (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == module]
    missing = [k for k in public if not hasattr(port, k)]
    assert public and not missing, (module, missing)


def test_lazy_exports_load_nothing_else():
    """Importing a package of the port loads none of the modules its
    exports name until one is used (the import checks in a fresh
    interpreter)."""
    probe = ("import sys, senas_torch, senas_torch.models, senas_torch.utils, "
             "senas_torch.train, senas_torch.search, senas_torch.runner, senas_torch.ops\n"
             "heavy = [m for m in ('senas_torch.models.senas_model', 'senas_torch.runner.train',"
             " 'senas_torch.search.supernet', 'senas_torch.utils.logging', "
             "'senas_torch.ops.primitives') if m in sys.modules]\n"
             "print('LOADED', heavy)\n"
             "from senas_torch.models import SenasModel, geno_searched\n"
             "from senas_torch import Genotype\n"
             "assert isinstance(geno_searched.senas_node_4, Genotype)\n"
             "print('OK', 'senas_torch.models.senas_model' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout and "OK True" in out.stdout, out.stdout


@pytest.mark.parametrize("spec,rank,rows,image_rows", [
    ((2, 1), 1, slice(2, 4), slice(None)),      # the second data index's batch rows
    ((1, 2), 1, slice(None), slice(3, 6)),      # the second spatial index's image rows
    ((2, 2), 2, slice(2, 4), slice(0, 3)),
])
def test_batch_sharding_cuts_a_ranks_part(spec, rank, rows, image_rows):
    """`parallel.batch_sharding` (senas_tpu's export) cuts a global [B, H,
    W, C] batch to a rank's part as `shard_batch` cuts its image."""
    import torch
    from senas_torch.parallel import Mesh, MeshSpec, batch_sharding
    x = torch.arange(4 * 6 * 2).reshape(4, 6, 2, 1)
    mesh = Mesh(spec=MeshSpec(*spec), rank=rank, device=torch.device("cpu"))
    assert torch.equal(batch_sharding(mesh)(x), x[rows][:, image_rows])
    assert torch.equal(batch_sharding(mesh, spatial=False)(x), x[rows])
