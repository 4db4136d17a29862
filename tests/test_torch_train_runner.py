"""The port's TrainRunner, TestRunner and their CLIs on
configs/senas/senas_synthetic.yml's `training:` (senas_node_4, c 8, depth 3,
64x64, batch 4), on the CPU: two epochs with a checkpoint each and a "best"
copy, a resume that runs only the epochs left, `ft` restarting the
counters, then TestRunner on the best checkpoint writing masks and grids
that Pillow decodes, and each CLI once."""

import json
import os

import numpy as np
import pytest
import torch

from senas_torch.core.config import load_config
from senas_torch.runner.test import TestRunner
from senas_torch.runner.train import TrainRunner, resolve_genotype
from senas_torch.testing_model import main as eval_cli
from senas_torch.train_model import main as train_cli
from senas_torch.utils.logging import store_images, write_png

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")
EPOCHS = 2


def _cfg(**training):
    cfg = load_config(CONFIG)
    cfg["training"].update(epoch=EPOCHS, **training)
    return cfg


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    log_root = tmp_path_factory.mktemp("logs")
    runner = TrainRunner(_cfg(), config_path=CONFIG, log_root=str(log_root), device="cpu")
    w0 = {k: v.clone() for k, v in runner.model.state_dict().items()}
    result = runner.run()
    return dict(runner=runner, result=result, w0=w0)


@pytest.fixture
def Image():
    """Pillow decodes what write_png wrote (the port itself never imports it)."""
    return pytest.importorskip("PIL.Image")


def _scalars(run_dir, tag):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["tag"] == tag]


def test_epochs_run_with_checkpoints(first_run):
    runner = first_run["runner"]
    assert runner.ckpt.exists("last") and runner.ckpt.exists("best")
    assert runner.state.step == EPOCHS * len(runner.train_queue) > 0
    assert [r["step"] for r in _scalars(runner.run_dir, "Val/dice")] == list(range(EPOCHS))
    assert first_run["result"]["best_dice"] == max(
        r["value"] for r in _scalars(runner.run_dir, "Val/dice"))
    assert os.path.exists(os.path.join(runner.run_dir, "senas_synthetic.yml"))
    # the weights moved, and the schedule set a cosine LR per epoch (T_max = epochs)
    assert any(not torch.equal(v, first_run["w0"][k])
               for k, v in runner.model.state_dict().items())
    lr = runner.cfg["training"]["model_optimizer"]["lr"]
    assert runner.scheduler(1) == pytest.approx(lr * (1 + np.cos(np.pi / EPOCHS)) / 2)


def test_val_grids_decode(first_run, Image):
    run_dir = first_run["runner"].run_dir
    for epoch in range(EPOCHS):
        with Image.open(os.path.join(run_dir, f"Val_images_{epoch}.png")) as im:
            assert im.mode == "RGB" and im.size == (3 * 64, 4 * 64)


def test_resume_runs_the_epochs_left(first_run, tmp_path):
    done = first_run["runner"]
    cfg = _cfg(resume=done.ckpt.directory)
    cfg["training"]["epoch"] = EPOCHS + 1
    runner = TrainRunner(cfg, log_root=str(tmp_path), device="cpu")
    assert runner.start_epoch == EPOCHS and runner.state.step == done.state.step
    assert runner.best_dice == first_run["result"]["best_dice"]
    for k, v in runner.model.state_dict().items():
        torch.testing.assert_close(v, done.model.state_dict()[k], rtol=0, atol=0)
    runner.run()
    assert runner.state.step == done.state.step + len(runner.train_queue)
    assert [r["step"] for r in _scalars(runner.run_dir, "Val/dice")] == [EPOCHS]


def test_ft_restarts_the_counters(first_run, tmp_path):
    done = first_run["runner"]
    runner = TrainRunner(_cfg(resume=done.ckpt.directory), log_root=str(tmp_path),
                         ft=True, device="cpu")
    assert (runner.start_epoch, runner.best_dice, runner.best_miou) == (0, 0.0, 0.0)
    assert runner.state.step == done.state.step   # the weights and optimizer came along


def test_test_runner_on_the_best_checkpoint(first_run, tmp_path, Image):
    done = first_run["runner"]
    runner = TestRunner(_cfg(), resume=done.ckpt.directory, log_root=str(tmp_path),
                        batch_size=6, device="cpu")
    out = runner.run()
    # eval-mode BN is per sample: the best epoch's val dice, whatever the batch
    assert out["dice"] == first_run["result"]["best_dice"]
    n = len(runner.valid_queue.dataset)
    names = sorted(os.listdir(runner.image_dir))
    masks = [f for f in names if not f.startswith("grid_")]
    assert masks == [f"{i:05d}.png" for i in range(n)]
    assert len(names) - len(masks) == len(runner.valid_queue)
    with Image.open(os.path.join(runner.image_dir, masks[0])) as im:
        mask = np.asarray(im)
    assert im.mode == "L" and mask.shape == (64, 64) and set(np.unique(mask)) <= {0, 255}


def test_write_png_round_trips(tmp_path, Image):
    rng = np.random.RandomState(0)
    for shape in ((5, 7), (3, 4, 3), (1, 1)):
        a = rng.randint(0, 256, shape).astype(np.uint8)
        write_png(str(tmp_path / "a.png"), a)
        with Image.open(str(tmp_path / "a.png")) as im:
            np.testing.assert_array_equal(np.asarray(im), a)
    grid = store_images(rng.randn(2, 4, 4, 1), np.ones((2, 4, 4), np.uint8),
                        np.zeros((2, 4, 4), np.int32), 2)
    assert grid.shape == (8, 12, 3) and grid.dtype == np.uint8


def test_clis_train_then_test(tmp_path, capsys):
    assert train_cli(["--config", CONFIG, "--device", "cpu", "--epoch", "1",
                       "--log_root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    run_dir = out.split("run dir: ")[1].splitlines()[0].strip()
    assert "best: {'best_dice'" in out
    assert eval_cli(["--config", CONFIG, "--device", "cpu", "--resume",
                      os.path.join(run_dir, "ckpt"), "--log_root", str(tmp_path)]) == 0
    assert "'dice'" in capsys.readouterr().out


def test_cli_defaults_stay_in_the_checkout():
    from senas_torch import testing_model, train_model
    from senas_torch.models import geno_searched
    assert train_model.DEFAULT_CONFIG == os.path.join(ROOT, "configs", "senas",
                                                      "senas_promise12.yml")
    assert testing_model.DEFAULT_GENOTYPE == repr(geno_searched.senas)


def test_genotype_resolution():
    cfg = load_config(CONFIG)
    from senas_torch.models import geno_searched
    assert resolve_genotype(cfg) == geno_searched.senas
    s = repr(geno_searched.senas_node_2)
    assert repr(resolve_genotype(cfg, s)) == s


def _log(run_dir):
    with open(os.path.join(run_dir, "run.log")) as f:
        return f.read()


ONE_DEVICE = "multi_gpus requested but only 1 device visible"


@pytest.mark.parametrize("mesh_spatial", [1, 2])
def test_multi_gpus_on_one_device_runs_there(tmp_path, first_run, mesh_spatial):
    """multi_gpus with one visible device (the CPU counts as one) runs on
    it and logs the JAX runner's line, in TrainRunner and TestRunner;
    mesh_spatial is not read."""
    cfg = _cfg(multi_gpus=True, mesh_spatial=mesh_spatial)
    cfg["training"]["epoch"] = 1
    runner = TrainRunner(cfg, log_root=str(tmp_path), device="cpu")
    runner.run()
    assert runner.state.step == len(runner.train_queue) > 0
    assert ONE_DEVICE in _log(runner.run_dir)
    tester = TestRunner(cfg, resume=first_run["runner"].ckpt.directory,
                        log_root=str(tmp_path), device="cpu")
    assert ONE_DEVICE in _log(tester.run_dir)


@pytest.mark.parametrize("runner_cls", ["train", "test"])
def test_multi_gpus_over_two_devices_raises(tmp_path, monkeypatch, first_run, runner_cls):
    from senas_torch.runner import common
    monkeypatch.setattr(common, "visible_devices", lambda device: 2)
    with pytest.raises(NotImplementedError, match="M13"):
        if runner_cls == "train":
            TrainRunner(_cfg(multi_gpus=True), log_root=str(tmp_path), device="cpu")
        else:
            TestRunner(_cfg(multi_gpus=True), resume=first_run["runner"].ckpt.directory,
                       log_root=str(tmp_path), device="cpu")


def test_remat_training_runs(tmp_path):
    """training.remat builds the fixed model with its cells recomputed in the
    backward; an epoch runs and every kernel moves."""
    cfg = _cfg(remat=True)
    cfg["training"]["epoch"] = 1
    runner = TrainRunner(cfg, log_root=str(tmp_path), device="cpu")
    assert runner.model.remat and runner.model.head.remat
    w0 = {k: v.clone() for k, v in runner.model.state_dict().items() if k.endswith("kernel")}
    runner.run()
    assert all(not torch.equal(runner.model.state_dict()[k], v) for k, v in w0.items())


def test_bf16_precision_computes_in_bf16_with_f32_masters(tmp_path):
    """`precision: bf16` builds the fixed model in bf16: bf16 logits, f32
    weights and running stats, and an f32 checkpoint."""
    cfg = _cfg(precision="bf16")
    cfg["training"]["epoch"] = 1
    runner = TrainRunner(cfg, log_root=str(tmp_path), device="cpu")
    assert runner.dtype == torch.bfloat16
    with torch.no_grad():
        assert runner.model(torch.zeros(1, 64, 64, 1))[0].dtype == torch.bfloat16
    runner.run()
    payload = runner.ckpt.restore_raw("last")
    for tensors in (payload["model"], dict(runner.model.named_parameters())):
        assert all(v.dtype == torch.float32 for v in tensors.values() if v.is_floating_point())


@pytest.mark.parametrize("precision", ["fp16", "float16"])
def test_unknown_precision_raises(tmp_path, precision):
    with pytest.raises(ValueError, match="precision"):
        TrainRunner(_cfg(precision=precision), log_root=str(tmp_path), device="cpu")


def test_test_runner_needs_a_checkpoint_and_has_no_submission_path(first_run, tmp_path):
    with pytest.raises(ValueError, match="resume"):
        TestRunner(_cfg(), log_root=str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        TestRunner(_cfg(), resume=str(tmp_path / "none"), log_root=str(tmp_path),
                   device="cpu")
    runner = TestRunner(_cfg(), resume=first_run["runner"].ckpt.directory,
                        log_root=str(tmp_path), device="cpu")
    # the submission path, ported since: one case volume of as many 64x64
    # slices as the val queue holds, no ground truth; the mask volume
    # written takes the case's geometry (tests/test_torch_challenge.py holds
    # it to senas_tpu's writer)
    from senas_torch.data.io import MetaImage, read_mhd, write_mhd
    n = len(runner.valid_queue.dataset)
    case_dir = tmp_path / "cases"
    case_dir.mkdir()
    write_mhd(str(case_dir / "Case00.mhd"), MetaImage(np.zeros((n, 64, 64), np.int16),
                                                      spacing=(0.6, 0.6, 3.0)))
    written, summary = runner.run_promise12_submission(str(case_dir))
    assert summary is None and written == [
        os.path.join(runner.run_dir, "predictions", "Case00_segmentation.mhd")]
    mask = read_mhd(written[0])
    assert mask.array.shape == (n, 64, 64) and mask.array.dtype == np.uint8
    assert mask.spacing == (0.6, 0.6, 3.0)


def test_a_failing_val_grid_does_not_end_the_run(tmp_path, monkeypatch):
    """The first val batch's image grid is logged under a guard, as in
    senas_tpu's runner: when it raises, the epoch's checkpoint is still
    written and the run goes on."""
    from senas_torch.utils.logging import ScalarWriter

    def broken(*args, **kwargs):
        raise OSError("the run directory cannot be written")

    monkeypatch.setattr(ScalarWriter, "add_image_grid", broken)
    cfg = _cfg()
    cfg["training"]["epoch"] = 1
    runner = TrainRunner(cfg, log_root=str(tmp_path), device="cpu")
    runner.run()
    assert runner.ckpt.exists("last")
    assert [r["step"] for r in _scalars(runner.run_dir, "Val/dice")] == [0]
    with open(os.path.join(runner.run_dir, "run.log")) as f:
        assert "val image grid failed" in f.read()
    assert 0 <= _scalars(runner.run_dir, "Train/prefetch_wait_share")[0]["value"] <= 1
