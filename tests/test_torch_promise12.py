"""The port's PROMISE12 loader (`senas_torch.data.promise12`) against
senas_tpu's (which calls cv2) on a phantom in PROMISE12's layout
(`tools/phantom_promise12.generate`: 6 training cases of 10-16 slices at
96 x 96, so that val case 05 exists, and 1 test case):

- every `npy_image_256` cache file equals senas_tpu's `build_cache`
  output exactly (the port reproduces cv2's CLAHE and resize exactly);
- `Promise12` in train, val and test modes gives exactly the same samples
  under the same seeds (the train mode's augmentation included);
- one `SearchRunner` epoch on the phantom (cut to 32 x 32 crops, c 8,
  depth 3, meta 2, batch 8, arch steps on) through both packages' runners
  from the same weights and arch tables, with the loaders fetching
  serially: the epoch's losses within rtol 1e-5, and the weights, BN
  running stats and arch tables within atol 1e-5, the bounds of
  tests/test_torch_search_step.py; the confusion counts and the derived
  genotype identical.
"""

import dataclasses
import functools
import json
import os
import random
import sys

import numpy as np
import pytest
import torch

from senas_torch import convert
from senas_torch.core.config import load_config
from senas_torch.data import base as tbase
from senas_torch.data import promise12 as T
from senas_torch.runner import search as tsearch

from torch_port_util import assert_trees_close, random_variables
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

J = pytest.importorskip("senas_tpu.data.promise12")  # needs cv2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools.phantom_promise12 import generate  # noqa: E402

CONFIG = os.path.join(ROOT, "configs", "senas", "senas_promise12.yml")
STEP_RTOL = 1e-5
STATE_ATOL = 1e-5


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One phantom; a data root per package, each holding the phantom's
    volumes and its own package's cache at npy_image_256."""
    tmp = tmp_path_factory.mktemp("promise12")
    generate(str(tmp / "phantom"), n_cases=6, n_test=1, size=96, seed=0)
    out = {}
    for name, pkg in (("jax", J), ("port", T)):
        base = tmp / name / "PROMISE2012"
        base.mkdir(parents=True)
        for sub in ("TrainingData", "TestData"):
            os.symlink(tmp / "phantom" / "PROMISE2012" / sub, base / sub)
        pkg.build_cache(str(base), str(base / "npy_image_256"), 256, 256)
        out[name] = str(tmp / name)
    return out


def test_cache_files_match(roots):
    store = lambda r: os.path.join(r, "PROMISE2012", "npy_image_256")
    names = sorted(os.listdir(store(roots["jax"])))
    assert names == sorted(os.listdir(store(roots["port"]))) == [
        "X_test.npy", "X_train.npy", "X_val.npy", "test_n_imgs.npy", "y_train.npy", "y_val.npy"]
    for f in names:
        want = np.load(os.path.join(store(roots["jax"]), f))
        got = np.load(os.path.join(store(roots["port"]), f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    # the val split is case 05 alone; the train split's mean and std
    x_train = np.load(os.path.join(store(roots["port"]), "X_train.npy"))
    assert abs(float(x_train.mean())) < 1e-4 and abs(float(x_train.std()) - 1) < 1e-4


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_samples_match(roots, mode):
    got, want = [], []
    for pkg, root, out in ((J, roots["jax"], want), (T, roots["port"], got)):
        random.seed(11)
        np.random.seed(11)
        ds = pkg.Promise12(root, mode=mode)
        out.extend(ds[i] for i in range(len(ds)))
    assert len(got) == len(want) > 0
    for (ti, tl), (ji, jl) in zip(got, want):
        assert ti.shape == ji.shape == (256, 256, 1) and ti.dtype == ji.dtype == np.float32
        assert tl.dtype == jl.dtype == np.int32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_test_mode_lists_the_cases(roots):
    j, t = J.Promise12(roots["jax"], mode="test"), T.Promise12(roots["port"], mode="test")
    np.testing.assert_array_equal(t.n_imgs, j.n_imgs)
    assert [os.path.basename(p) for p in t.test_file_list] == \
        [os.path.basename(p) for p in j.test_file_list] == ["Case00.mhd"]
    assert int(t.n_imgs.sum()) == len(t) and not t.y.any()


def test_get_dataset_builds_the_cache_and_needs_a_root(roots, tmp_path):
    root = tmp_path / "data"
    (root / "PROMISE2012").mkdir(parents=True)
    for sub in ("TrainingData", "TestData"):
        os.symlink(os.path.join(roots["port"], "PROMISE2012", sub), root / "PROMISE2012" / sub)
    ds = tbase.get_dataset("promise12", path=str(root), mode="val")
    assert os.path.isdir(root / "PROMISE2012" / "npy_image_256") and len(ds) > 0
    with pytest.raises(ValueError, match="data_root"):
        tbase.get_dataset("promise12", path=None)


def test_unknown_mode_or_option_raises(roots):
    with pytest.raises(ValueError, match="mode"):
        T.Promise12(roots["port"], mode="trian")
    with pytest.raises(TypeError):
        tbase.get_dataset("promise12", path=roots["port"], mode="val", hw=64)


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
def small_crop(monkeypatch):
    from senas_tpu.data import base as jbase
    for b in (jbase, tbase):
        monkeypatch.setitem(b.SPECS, "promise12",
                            dataclasses.replace(b.SPECS["promise12"], crop_size=(32, 32)))
    monkeypatch.setenv("SENAS_LOADER_WORKERS", "0")


def test_search_runner_epoch_matches(roots, small_crop, monkeypatch, tmp_path):
    import jax
    from senas_tpu.runner import search as jsearch

    cfg = load_config(CONFIG)
    cfg["searching"].update(init_channels=8, depth=3, meta_node_num=2, batch_size=8,
                            epoch=1, alpha_begin=0)
    monkeypatch.setattr(jsearch, "PrefetchLoader", _Serial)
    # scalars.jsonl only: TensorBoard's writer would import TensorFlow
    monkeypatch.setattr(jsearch, "ScalarWriter",
                        functools.partial(jsearch.ScalarWriter, use_tensorboard=False))
    monkeypatch.setattr(tsearch, "PrefetchLoader", _Serial)
    # flax's initialisers run op by op (~40 s here); the weights are
    # handed to the port anyway, so numpy fills the tree's shapes instead
    init = jsearch.SenasSearch.init
    monkeypatch.setattr(jsearch.SenasSearch, "init", lambda self, rngs, *args: random_variables(
        self, np.random.RandomState(0), *args, init=functools.partial(init, self)))
    jr = jsearch.SearchRunner(json.loads(json.dumps(cfg)), data_root=roots["jax"],
                              log_root=str(tmp_path / "j"))
    tr = tsearch.SearchRunner(json.loads(json.dumps(cfg)), data_root=roots["port"],
                              log_root=str(tmp_path / "t"), device="cpu")
    variables = {"params": jax.device_get(jr.state.params),
                 "batch_stats": jax.device_get(jr.state.batch_stats)}
    convert.load_variables(tr.state.model, variables)
    with torch.no_grad():
        for k, t in tr.state.arch.items():
            t.copy_(torch.from_numpy(np.array(jr.state.arch[k])))
    assert len(tr.train_queue) == len(jr.train_queue) >= 3

    genotypes = []
    for runner in (jr, tr):
        random.seed(5)
        np.random.seed(5)
        genotypes.append(runner.run())
    assert genotypes[0] == genotypes[1]

    scalars = []
    for r in (jr, tr):
        with open(os.path.join(r.run_dir, "scalars.jsonl")) as f:
            scalars.append({row["tag"]: row["value"] for row in map(json.loads, f)})
    for tag in ("Train/Loss", "Val/loss", "Train/dice", "Val/dice", "Val/mIoU", "Val/pixAcc"):
        np.testing.assert_allclose(scalars[1][tag], scalars[0][tag], rtol=STEP_RTOL, err_msg=tag)
    assert 0 <= scalars[1]["Train/prefetch_wait_share"] <= 1
    assert 0 <= scalars[1]["Train/val_fetch_share"] <= 1

    got = convert.state_dict_to_variables(tr.state.model)
    jstate = jax.device_get(jr.state)
    assert_trees_close(got["params"], jstate.params, rtol=0, atol=STATE_ATOL)
    assert_trees_close(got["batch_stats"], jstate.batch_stats, rtol=0, atol=STATE_ATOL)
    arch = convert.arch_to_numpy(tr.state.arch)
    for k, v in jstate.arch.items():
        np.testing.assert_allclose(arch[k], np.asarray(v), rtol=0, atol=STATE_ATOL, err_msg=k)
