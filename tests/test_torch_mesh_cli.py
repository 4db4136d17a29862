"""The port's CLIs over two gloo ranks on the CPU (templates:
tests/test_e2e_cli_mesh.py test_train_cli_mesh_matches_single_device,
test_train_cli_rejects_indivisible_batch): `senas_torch.train_model` with
`multi_gpus: true`, started as two ranks by `senas_torch.parallel.launch`
(each joins through the SENAS_* environment), one epoch on a small
synthetic set (21 samples of 32x32: two train steps of the global batch 8,
val batches of 8, 8 and a trailing 5 that runs whole on each rank), against
the same run in one process; then `testing_model` over two ranks on its
checkpoint against one process. Rank 0 alone prints the run directory and
writes the run (one run directory, its log, checkpoints, images). A
global batch the ranks do not divide fails both ranks and the launch.

Tolerances: the checkpoint's weights within tests/test_mesh.py's f32 step
bound (rtol 2e-2, atol 8e-3; f32 rounding in a BatchNorm's sums moves
single pre-BN weights by O(grad), tests/test_mesh.py:69-85), the val loss
and the evaluation's metrics rtol 5e-4 (tests/test_e2e_cli_mesh.py)."""

import json
import os

import numpy as np
import pytest
import yaml

from senas_torch.core.config import load_config
from senas_torch.parallel.launch import launch
from senas_torch.runner.test import TestRunner
from senas_torch.runner.train import TrainRunner
from senas_torch.train.checkpoint import CheckpointManager

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _config(tmp_path, **training):
    cfg = load_config(CONFIG)
    cfg["data"].update(size=21, hw=32)
    cfg["training"].update({"epoch": 1, "batch_size": 8, "multi_gpus": True, **training})
    path = os.path.join(str(tmp_path), f"cfg{len(os.listdir(str(tmp_path)))}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(_plain(cfg), f)
    return cfg, path


def _run_dirs(log_root, phase):
    base = os.path.join(log_root, "senas", phase, "synthetic")
    return [os.path.join(base, d) for d in sorted(os.listdir(base))]


def _val_loss(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [s["value"] for s in map(json.loads, f) if s["tag"] == "Val/loss"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    cfg, path = _config(tmp)
    one_root, two_root = str(tmp / "one"), str(tmp / "two")
    one = TrainRunner(cfg, config_path=path, log_root=one_root, device="cpu")
    one.run()
    env_before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        rc = launch("senas_torch.train_model", ["--config", path, "--log_root", two_root],
                    2, device_type="cpu", timeout=120)
        two_dirs = _run_dirs(two_root, "train")
        ckpt = os.path.join(two_dirs[0], "ckpt")
        test_rc = launch("senas_torch.testing_model",
                         ["--config", path, "--log_root", two_root, "--resume", ckpt,
                          "--batch_size", "8"], 2, device_type="cpu", timeout=120)
    finally:
        if env_before is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = env_before
    tester = TestRunner(cfg, resume=ckpt, log_root=one_root, batch_size=8, device="cpu")
    return dict(one=one, rc=rc, two_dirs=two_dirs, test_rc=test_rc,
                one_test=tester.run(), two_root=two_root)


def test_train_cli_over_two_ranks_matches_one_process(runs):
    assert runs["rc"] == 0
    assert len(runs["two_dirs"]) == 1, runs["two_dirs"]
    run_dir = runs["two_dirs"][0]
    with open(os.path.join(run_dir, "run.log")) as f:
        log = f.read()
    assert "mesh: {'data': 2, 'spatial': 1} over 2 cpu devices" in log
    assert log.count("Epoch 0 Val loss") == 1
    got = CheckpointManager(os.path.join(run_dir, "ckpt")).restore_raw("last")["model"]
    want = runs["one"].ckpt.restore_raw("last")["model"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-2, atol=8e-3, err_msg=k)
    np.testing.assert_allclose(_val_loss(run_dir), _val_loss(runs["one"].run_dir), rtol=5e-4)


def test_testing_cli_over_two_ranks_matches_one_process(runs):
    assert runs["test_rc"] == 0
    test_dirs = _run_dirs(runs["two_root"], "testing")
    assert len(test_dirs) == 1
    with open(os.path.join(test_dirs[0], "run.log")) as f:
        line = [ln for ln in f if "val loss" in ln]
    assert len(line) == 1
    loss = float(line[0].split("val loss ")[1].split()[0])
    np.testing.assert_allclose(loss, runs["one_test"]["loss"], rtol=5e-4)
    # every mask once: 21 masks and a grid a batch, written by rank 0
    names = sorted(os.listdir(os.path.join(test_dirs[0], "images")))
    assert len([n for n in names if not n.startswith("grid")]) == 21
    assert len([n for n in names if n.startswith("grid")]) == 3


def test_train_cli_rejects_indivisible_batch(tmp_path, capfd):
    _, path = _config(tmp_path, batch_size=5)
    rc = launch("senas_torch.train_model", ["--config", path, "--log_root", str(tmp_path)],
                2, device_type="cpu", timeout=120)
    assert rc != 0
    assert "training.batch_size=5 is not divisible by the mesh data axis (2)" in (
        capfd.readouterr().err)
