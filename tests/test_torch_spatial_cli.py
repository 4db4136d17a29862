"""The port's CLIs with the image rows split over two gloo ranks on the CPU
(`multi_gpus: true, mesh_spatial: 2`: MeshSpec(data=1, spatial=2), each
rank holding every batch row and half of each image's rows), and the
runners' `SENAS_TRACE_DIR` trace (templates: tests/test_torch_mesh_cli.py;
senas_tpu/utils/misc.py:92-136 for the trace):

  * `senas_torch.search_arc` (one epoch of the synthetic set, 14 samples of
    32x32 split 7/7: three bilevel steps of the global batch 2 and the eval
    epoch) and `senas_torch.train_model` (one epoch: seven train steps of
    batch 2, the val epoch), each started as two ranks by
    `senas_torch.parallel.launch`, against the same runs in one process:
    the checkpoint's weights (and arch tables) within tests/test_mesh.py's
    f32 step bound (rtol 2e-2, atol 8e-3), the val loss rtol 5e-4; then
    `testing_model` over two ranks on the train checkpoint against one
    process (its val loss rtol 5e-4, every mask written once, by rank 0);
  * the two-rank train run with SENAS_TRACE_DIR set writes one trace, rank
    0's; the one-process train run with it set writes one; `StepTimer`
    records steps [5, 8) and no others, writes what it recorded when a
    loop ends inside the window, and nothing without the variable;
  * the baseline zoo under the split (M13c): `train_model --model unet`
    over two ranks against one process (the checkpoint's weights within the
    f32 step bound, the val loss rtol 5e-4), and `testing_model --model
    pspnet` over two ranks on a one-process pspnet checkpoint
    against one process (its val loss rtol 5e-4, every mask written once);
    in the CLI a factory model spawns its ranks, and a model name the
    factory does not build raises its KeyError before any rank is
    started."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from senas_torch.core.config import load_config
from senas_torch.parallel.launch import launch
from senas_torch.runner.search import SearchRunner
from senas_torch.runner.test import TestRunner
from senas_torch.runner.train import TrainRunner
from senas_torch.train.checkpoint import CheckpointManager
from senas_torch.utils.misc import StepTimer

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")
LAUNCH_TIMEOUT_S = 240
# a zoo run's val loss against one process, in units of the one-process
# run's own spread over thread counts
F32_SPREAD = 5


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _config(tmp_path):
    cfg = load_config(CONFIG)
    cfg["data"].update(size=14, hw=32)
    split = {"epoch": 1, "batch_size": 2, "multi_gpus": True, "mesh_spatial": 2}
    cfg["training"].update(split)
    cfg["searching"].update(split, alpha_begin=0)
    path = os.path.join(str(tmp_path), "spatial.yml")
    with open(path, "w") as f:
        yaml.safe_dump(_plain(cfg), f)
    return cfg, path


def _run_dirs(log_root, phase, model="senas"):
    base = os.path.join(log_root, model, phase, "synthetic")
    return [os.path.join(base, d) for d in sorted(os.listdir(base))]


def _val_loss(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [s["value"] for s in map(json.loads, f) if s["tag"] == "Val/loss"]


def _env(**env):
    """Set environment variables until the returned function is called."""
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)

    def restore():
        for k, v in before.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    return restore


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    cfg, path = _config(tmp)
    one_root, two_root = str(tmp / "one"), str(tmp / "two")
    one_trace, two_trace = str(tmp / "trace_one"), str(tmp / "trace_two")
    restore = _env(OMP_NUM_THREADS="1", SENAS_TRACE_DIR=two_trace)
    try:
        rc = launch("senas_torch.train_model", ["--config", path, "--log_root", two_root],
                    2, device_type="cpu", timeout=LAUNCH_TIMEOUT_S)
    finally:
        restore()
    two_dirs = _run_dirs(two_root, "train")
    restore = _env(OMP_NUM_THREADS="1")
    try:
        search_rc = launch("senas_torch.search_arc", ["--config", path, "--log_root", two_root],
                           2, device_type="cpu", timeout=LAUNCH_TIMEOUT_S)
        test_rc = launch("senas_torch.testing_model",
                         ["--config", path, "--log_root", two_root, "--resume",
                          os.path.join(two_dirs[0], "ckpt"), "--batch_size", "2"],
                         2, device_type="cpu", timeout=LAUNCH_TIMEOUT_S)
    finally:
        restore()
    restore = _env(SENAS_TRACE_DIR=one_trace)
    try:
        one = TrainRunner(cfg, config_path=path, log_root=one_root, device="cpu")
        one.run()
    finally:
        restore()
    one_search = SearchRunner(cfg, config_path=path, log_root=one_root, device="cpu")
    one_search.run()
    tester = TestRunner(cfg, resume=os.path.join(two_dirs[0], "ckpt"), log_root=one_root,
                        batch_size=2, device="cpu")
    one_test = tester.run()

    # the baseline zoo (depth 3): unet trained, pspnet evaluated over two ranks
    restore = _env(OMP_NUM_THREADS="1")
    try:
        unet_rc = launch("senas_torch.train_model", ["--config", path, "--log_root", two_root,
                                                     "--model", "unet"],
                         2, device_type="cpu", timeout=LAUNCH_TIMEOUT_S)
        psp = TrainRunner(cfg, model_name="pspnet", config_path=path,
                          log_root=one_root, device="cpu")
        psp.run()
        psp_rc = launch("senas_torch.testing_model",
                        ["--config", path, "--log_root", two_root, "--model", "pspnet",
                         "--resume", psp.ckpt.directory, "--batch_size", "2"],
                        2, device_type="cpu", timeout=LAUNCH_TIMEOUT_S)
    finally:
        restore()
    one_unet = TrainRunner(cfg, model_name="unet", config_path=path, log_root=one_root,
                           device="cpu")
    one_unet.run()
    # the same run on three threads: its f32 sums in another order
    threads = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        unet_3 = TrainRunner(cfg, model_name="unet", config_path=path,
                             log_root=str(tmp / "one_3"), device="cpu")
        unet_3.run()
    finally:
        torch.set_num_threads(threads)
    psp_tester = TestRunner(cfg, model_name="pspnet", resume=psp.ckpt.directory,
                            log_root=one_root, batch_size=2, device="cpu")
    return dict(one=one, one_search=one_search, rc=rc, search_rc=search_rc, test_rc=test_rc,
                two_root=two_root, one_test=one_test, one_trace=one_trace,
                two_trace=two_trace, unet_rc=unet_rc, one_unet=one_unet, unet_3=unet_3,
                psp_rc=psp_rc,
                one_psp_test=psp_tester.run())


def _same_weights(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-2, atol=8e-3, err_msg=k)


def test_train_cli_with_split_rows_matches_one_process(runs):
    assert runs["rc"] == 0
    run_dir, = _run_dirs(runs["two_root"], "train")
    with open(os.path.join(run_dir, "run.log")) as f:
        log = f.read()
    assert "mesh: {'data': 1, 'spatial': 2} over 2 cpu devices" in log
    _same_weights(CheckpointManager(os.path.join(run_dir, "ckpt")).restore_raw("last")["model"],
                  runs["one"].ckpt.restore_raw("last")["model"])
    np.testing.assert_allclose(_val_loss(run_dir), _val_loss(runs["one"].run_dir), rtol=5e-4)


def test_search_cli_with_split_rows_matches_one_process(runs):
    assert runs["search_rc"] == 0
    run_dir, = _run_dirs(runs["two_root"], "search")
    got = CheckpointManager(os.path.join(run_dir, "ckpt")).restore_raw("last")
    want = runs["one_search"].ckpt.restore_raw("last")
    _same_weights(got["model"], want["model"])
    for k, v in want["arch"].items():
        np.testing.assert_allclose(got["arch"][k].numpy(), v.numpy(), rtol=2e-4, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(_val_loss(run_dir), _val_loss(runs["one_search"].run_dir),
                               rtol=5e-4)


def test_testing_cli_with_split_rows_matches_one_process(runs):
    assert runs["test_rc"] == 0
    test_dir, = _run_dirs(runs["two_root"], "testing")
    with open(os.path.join(test_dir, "run.log")) as f:
        line = [ln for ln in f if "val loss" in ln]
    assert len(line) == 1
    loss = float(line[0].split("val loss ")[1].split()[0])
    np.testing.assert_allclose(loss, runs["one_test"]["loss"], rtol=5e-4)
    names = os.listdir(os.path.join(test_dir, "images"))
    assert len([n for n in names if not n.startswith("grid")]) == 14


def test_zoo_train_cli_with_split_rows_matches_one_process(runs):
    """unet's epoch is chaotic in f32 at this size (BatchNorms over 32
    values at batch 2): the one-process run on one thread and on three read
    val losses 1.7e-3 apart. The two-rank run's val loss lies within
    F32_SPREAD times that spread (or 5e-4) of the one-process run's."""
    assert runs["unet_rc"] == 0
    run_dir, = _run_dirs(runs["two_root"], "train", "unet")
    with open(os.path.join(run_dir, "run.log")) as f:
        assert "mesh: {'data': 1, 'spatial': 2} over 2 cpu devices" in f.read()
    _same_weights(CheckpointManager(os.path.join(run_dir, "ckpt")).restore_raw("last")["model"],
                  runs["one_unet"].ckpt.restore_raw("last")["model"])
    want = np.asarray(_val_loss(runs["one_unet"].run_dir))
    spread = np.abs(np.asarray(_val_loss(runs["unet_3"].run_dir)) / want - 1).max()
    np.testing.assert_allclose(_val_loss(run_dir), want, rtol=max(5e-4, F32_SPREAD * spread))


def test_zoo_testing_cli_with_split_rows_matches_one_process(runs):
    assert runs["psp_rc"] == 0
    test_dir, = _run_dirs(runs["two_root"], "testing", "pspnet")
    with open(os.path.join(test_dir, "run.log")) as f:
        line = [ln for ln in f if "val loss" in ln]
    assert len(line) == 1
    loss = float(line[0].split("val loss ")[1].split()[0])
    np.testing.assert_allclose(loss, runs["one_psp_test"]["loss"], rtol=5e-4)
    names = os.listdir(os.path.join(test_dir, "images"))
    assert len([n for n in names if not n.startswith("grid")]) == 14


def test_runners_trace_once_on_rank_zero(runs):
    """Seven steps an epoch: one trace of steps [5, 8), from rank 0 alone
    under the mesh."""
    for key in ("two_trace", "one_trace"):
        files = os.listdir(runs[key])
        assert len(files) == 1 and files[0].startswith("senas_trace_"), (key, files)
        with open(os.path.join(runs[key], files[0])) as f:
            assert json.load(f)["traceEvents"]


def _timed_steps(timer, n):
    for i in range(n):
        with timer:
            with torch.profiler.record_function(f"senas_step_{i}"):
                torch.ones(4).sum()
    timer.close()


def _steps_in(path):
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    return sorted(int(n.rsplit("_", 1)[1]) for n in names if n.startswith("senas_step_"))


def test_step_timer_traces_steps_5_to_8(tmp_path, monkeypatch):
    monkeypatch.setenv("SENAS_TRACE_DIR", str(tmp_path / "env"))
    timer = StepTimer()
    _timed_steps(timer, 10)
    assert os.listdir(tmp_path / "env") == [os.path.basename(timer.trace_path)]
    assert _steps_in(timer.trace_path) == [5, 6, 7]
    # a loop that ends inside the window: the steps that ran
    short = StepTimer(trace_dir=str(tmp_path / "short"))
    _timed_steps(short, 7)
    assert _steps_in(short.trace_path) == [5, 6]
    # not rank 0, and no variable: no trace
    off = StepTimer(trace=False)
    _timed_steps(off, 10)
    monkeypatch.delenv("SENAS_TRACE_DIR")
    unset = StepTimer()
    _timed_steps(unset, 10)
    assert off.trace_path is None and unset.trace_path is None
    assert sorted(os.listdir(tmp_path)) == ["env", "short"]


def test_zoo_model_under_split_rows_raises_in_the_cli(tmp_path, monkeypatch):
    """A factory model under mesh_spatial 2 over two ranks spawns them; a
    model name the factory does not build raises the factory's KeyError
    before any rank is started."""
    from senas_torch import testing_model, train_model
    _, path = _config(tmp_path)
    for mod, extra in ((train_model, []), (testing_model, ["--resume", str(tmp_path)])):
        started = []
        monkeypatch.setattr(mod, "ranks_to_spawn", lambda section, device: 2)
        monkeypatch.setattr(mod, "launch", lambda *a: started.append(a) or 0)
        assert mod.main(["--config", path, "--model", "unet"] + extra) == 0
        assert len(started) == 1 and started[0][2] == 2
        with pytest.raises(KeyError, match="unknown model 'resunet'"):
            mod.main(["--config", path, "--model", "resunet"] + extra)
        assert len(started) == 1
