"""The port's runners on the other shipped configs, against senas_tpu's,
at a reduced size on phantoms in each dataset's layout, with the loaders
fetching serially:

- one `SearchRunner` epoch of configs/senas/senas_chaos.yml on a CHAOS CT
  phantom (2 cases of 12 DICOM slices at 40 x 48), cut to 32 x 32 crops,
  c 8, depth 3, meta 2, batch 4, arch steps on;
- one `TrainRunner` epoch of configs/senas/senas_heart.yml on an MSD heart
  phantom (2 volumes of 8 slices at 40 x 48, extracted by each package's
  `extract_task`), cut to 32 x 40 crops (heart's crop is not square),
  c 8, depth 3, batch 4;

both from the same weights (and arch tables) through `senas_torch.convert`.
The bounds of tests/test_torch_promise12.py: the epoch's losses and
metrics within rtol 1e-5, the weights, BN running stats and arch tables
within atol 1e-5; the derived genotype identical.
"""

import dataclasses
import functools
import json
import os
import random

import numpy as np
import pytest
import torch

from senas_torch import convert
from senas_torch.core.config import load_config
from senas_torch.data import base as tbase
from senas_torch.data import msd as tmsd
from senas_torch.runner import search as tsearch
from senas_torch.runner import train as ttrain

from torch_port_util import (assert_trees_close, random_variables, write_dicom,
                             write_nifti)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

jbase = pytest.importorskip("senas_tpu.data.base")   # its loaders need cv2 and Pillow
from senas_tpu.data import msd as jmsd  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs", "senas")
STEP_RTOL = 1e-5
STATE_ATOL = 1e-5


def _slice(rs, h, w):
    y, x = np.mgrid[0:h, 0:w]
    cy, cx = h * rs.uniform(0.35, 0.65), w * rs.uniform(0.35, 0.65)
    inside = ((y - cy) / (0.3 * h)) ** 2 + ((x - cx) / (0.25 * w)) ** 2 < 1
    return 100 + 60 * inside + 15 * rs.randn(h, w), inside


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A data root per package: the same CHAOS CT DICOMs and masks, and the
    same heart volumes, which each package extracts itself."""
    from PIL import Image
    tmp = tmp_path_factory.mktemp("m9b_runners")
    rs = np.random.RandomState(0)
    out = {}
    chaos, heart = [], []
    for case in ("1", "2"):
        chaos.append([_slice(rs, 40, 48) for _ in range(12)])
        heart.append([_slice(rs, 40, 48) for _ in range(8)])
    for name, pkg in (("jax", jmsd), ("port", tmsd)):
        root = tmp / name
        for c, case in enumerate(chaos):
            d = root / "CHAOS" / "CT_data_batch" / str(c + 1)
            os.makedirs(d / "DICOM_anon")
            os.makedirs(d / "Ground")
            for i, (img, inside) in enumerate(case):
                write_dicom(str(d / "DICOM_anon" / f"IMG-0001-{i + 1:05d}.dcm"),
                            (img * 5 - 1024).astype(np.int16), intercept=-1024.0)
                Image.fromarray(np.where(inside, 255, 0).astype(np.uint8)).save(
                    d / "Ground" / f"liver_GT_{i:03d}.png")
        task = root / "Task02_Heart"
        for sub in ("imagesTr", "labelsTr"):
            os.makedirs(task / sub)
        for c, case in enumerate(heart):
            write_nifti(str(task / "imagesTr" / f"la_{c:03d}.nii.gz"),
                        np.stack([img * 3 for img, _ in case], -1).astype(np.int16))
            write_nifti(str(task / "labelsTr" / f"la_{c:03d}.nii.gz"),
                        np.stack([m for _, m in case], -1).astype(np.uint8))
        pkg.extract_task(str(task))
        out[name] = str(root)
    return out


class _Serial:
    """A PrefetchLoader that fetches in the consumer's thread, so that the
    two runners draw their augmentations in one fixed order."""

    def __init__(self, loader, depth=2):
        self.loader = loader
        self.waits = []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return iter(self.loader)


@pytest.fixture
def small_crops(monkeypatch):
    for b in (jbase, tbase):
        monkeypatch.setitem(b.SPECS, "chaos",
                            dataclasses.replace(b.SPECS["chaos"], crop_size=(32, 32)))
        monkeypatch.setitem(b.SPECS, "heart",
                            dataclasses.replace(b.SPECS["heart"], crop_size=(32, 40)))
    monkeypatch.setenv("SENAS_LOADER_WORKERS", "0")


def _scalars(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return {row["tag"]: row["value"] for row in map(json.loads, f)}


def _quiet_writer(module, monkeypatch):
    # scalars.jsonl only: TensorBoard's writer would import TensorFlow
    monkeypatch.setattr(module, "ScalarWriter",
                        functools.partial(module.ScalarWriter, use_tensorboard=False))


def test_search_runner_epoch_on_chaos_matches(roots, small_crops, monkeypatch, tmp_path):
    import jax
    from senas_tpu.runner import search as jsearch

    cfg = load_config(os.path.join(CONFIGS, "senas_chaos.yml"))
    cfg["searching"].update(init_channels=8, depth=3, meta_node_num=2, batch_size=4,
                            epoch=1, alpha_begin=0)
    monkeypatch.setattr(jsearch, "PrefetchLoader", _Serial)
    monkeypatch.setattr(tsearch, "PrefetchLoader", _Serial)
    _quiet_writer(jsearch, monkeypatch)
    init = jsearch.SenasSearch.init
    monkeypatch.setattr(jsearch.SenasSearch, "init", lambda self, rngs, *args: random_variables(
        self, np.random.RandomState(0), *args, init=functools.partial(init, self)))
    jr = jsearch.SearchRunner(json.loads(json.dumps(cfg)), data_root=roots["jax"],
                              log_root=str(tmp_path / "j"))
    tr = tsearch.SearchRunner(json.loads(json.dumps(cfg)), data_root=roots["port"],
                              log_root=str(tmp_path / "t"), device="cpu")
    convert.load_variables(tr.state.model, {"params": jax.device_get(jr.state.params),
                                            "batch_stats": jax.device_get(jr.state.batch_stats)})
    with torch.no_grad():
        for k, t in tr.state.arch.items():
            t.copy_(torch.from_numpy(np.array(jr.state.arch[k])))
    assert len(tr.train_queue) == len(jr.train_queue) == 3

    genotypes = []
    for runner in (jr, tr):
        random.seed(5)
        np.random.seed(5)
        genotypes.append(runner.run())
    assert genotypes[0] == genotypes[1]

    scalars = [_scalars(r.run_dir) for r in (jr, tr)]
    for tag in ("Train/Loss", "Val/loss", "Train/dice", "Val/dice", "Val/mIoU", "Val/pixAcc"):
        np.testing.assert_allclose(scalars[1][tag], scalars[0][tag], rtol=STEP_RTOL, err_msg=tag)
    got = convert.state_dict_to_variables(tr.state.model)
    jstate = jax.device_get(jr.state)
    assert_trees_close(got["params"], jstate.params, rtol=0, atol=STATE_ATOL)
    assert_trees_close(got["batch_stats"], jstate.batch_stats, rtol=0, atol=STATE_ATOL)
    arch = convert.arch_to_numpy(tr.state.arch)
    for k, v in jstate.arch.items():
        np.testing.assert_allclose(arch[k], np.asarray(v), rtol=0, atol=STATE_ATOL, err_msg=k)


def test_train_runner_epoch_on_heart_matches(roots, small_crops, monkeypatch, tmp_path):
    import jax
    from senas_tpu.models import senas_model as jmodel
    from senas_tpu.runner import train as jtrain

    cfg = load_config(os.path.join(CONFIGS, "senas_heart.yml"))
    cfg["training"].update(init_channels=8, depth=3, batch_size=4, epoch=1)
    monkeypatch.setattr(jtrain, "PrefetchLoader", _Serial)
    monkeypatch.setattr(ttrain, "PrefetchLoader", _Serial)
    _quiet_writer(jtrain, monkeypatch)
    # flax's initialisers run op by op; numpy fills the tree's shapes instead
    init = jmodel.SenasModel.init
    monkeypatch.setattr(jmodel.SenasModel, "init", lambda self, rngs, *args: random_variables(
        self, np.random.RandomState(0), *args, init=functools.partial(init, self)))
    jr = jtrain.TrainRunner(json.loads(json.dumps(cfg)), data_root=roots["jax"],
                            log_root=str(tmp_path / "j"))
    tr = ttrain.TrainRunner(json.loads(json.dumps(cfg)), data_root=roots["port"],
                            log_root=str(tmp_path / "t"), device="cpu")
    convert.load_variables(tr.model, {"params": jax.device_get(jr.state.params),
                                      "batch_stats": jax.device_get(jr.state.batch_stats)})
    assert len(tr.train_queue) == len(jr.train_queue) == 4
    assert len(tr.valid_queue) == len(jr.valid_queue) == 4

    for runner in (jr, tr):
        random.seed(5)
        np.random.seed(5)
        runner.run()
    scalars = [_scalars(r.run_dir) for r in (jr, tr)]
    for tag in ("Train/Loss", "Train/dice", "Val/loss", "Val/dice", "Val/mIoU", "Val/Acc"):
        np.testing.assert_allclose(scalars[1][tag], scalars[0][tag], rtol=STEP_RTOL, err_msg=tag)
    got = convert.state_dict_to_variables(tr.model)
    jstate = jax.device_get(jr.state)
    assert_trees_close(got["params"], jstate.params, rtol=0, atol=STATE_ATOL)
    assert_trees_close(got["batch_stats"], jstate.batch_stats, rtol=0, atol=STATE_ATOL)
