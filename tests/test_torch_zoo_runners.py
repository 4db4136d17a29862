"""The baseline zoo through the port's runners and CLIs on the CPU, on
configs/senas/senas_synthetic.yml's `training:` (depth 3, 64x64, batch 4,
SGD 6e-3 / 0.9 / 5e-4, clip 5, dice_ce):

- one TrainRunner epoch (8 steps) of `unet` and of `pspnet` (depth 3:
  full-size logits) against senas_tpu's TrainRunner from the same weights
  (numpy-made, norm scales at 1, through senas_torch.convert). The first
  step agrees as tests/test_torch_zoo.py's single step does (unet: weights
  3e-7, running stats 4e-7 apart); training then amplifies f32 rounding
  about 1.5x a step, so after the epoch unet's running stats are up to
  2.1e-4 of their magnitude apart, its weights 2.3e-5, and the val loss,
  which reads the stats in eval mode, 2.2e-4. Bounds: the train loss rtol
  1e-5, the val loss rtol 1e-3, the dice, mIoU and accuracy (counts of
  pixels) within 0.05 points, every weight atol 1e-4, every running stat
  within 1e-3 of max(1, its magnitude);
- `train_model --model <name>`, `testing_model` on its best checkpoint,
  which gives back the run's best val dice, and `export_model --check
  --f32`, whose artifact answers with the model's logits.
"""

import ast
import functools
import json
import os
import random

import jax
import numpy as np
import pytest
import torch

from senas_torch import convert
from senas_torch.core.config import load_config
from senas_torch.export_model import main as export_cli
from senas_torch.runner import train as ttrain
from senas_torch.serve import Predictor
from senas_torch.testing_model import main as eval_cli
from senas_torch.train_model import main as train_cli

from torch_port_util import flat, random_variables, unit_scales
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")
STEP_RTOL = 1e-5
VAL_LOSS_RTOL = 1e-3
POINTS = 0.05
STATE_ATOL = 1e-4
STATS_REL = 1e-3


@pytest.mark.parametrize("name,cls", [("unet", "Unet"), ("pspnet", "PSPNet")])
def test_train_runner_epoch_matches_senas_tpu(name, cls, monkeypatch, tmp_path):
    from senas_tpu.models import zoo as jzoo
    from senas_tpu.runner import train as jtrain

    cfg = load_config(CONFIG)
    cfg["training"].update(epoch=1)
    # scalars.jsonl only: TensorBoard's writer would import TensorFlow
    monkeypatch.setattr(jtrain, "ScalarWriter",
                        functools.partial(jtrain.ScalarWriter, use_tensorboard=False))
    # flax's initialisers run op by op; numpy fills the tree's shapes instead
    init = getattr(jzoo, cls).init
    # (with unit norm scales: tests/test_torch_zoo.py)
    monkeypatch.setattr(getattr(jzoo, cls), "init", lambda self, rngs, *args: unit_scales(
        random_variables(self, np.random.RandomState(0), *args,
                         init=functools.partial(init, self))))
    jr = jtrain.TrainRunner(json.loads(json.dumps(cfg)), model_name=name,
                            log_root=str(tmp_path / "j"))
    tr = ttrain.TrainRunner(json.loads(json.dumps(cfg)), model_name=name,
                            log_root=str(tmp_path / "t"), device="cpu")
    convert.load_variables(tr.model, {"params": jax.device_get(jr.state.params),
                                      "batch_stats": jax.device_get(jr.state.batch_stats)})
    for runner in (jr, tr):
        random.seed(5)
        np.random.seed(5)
        runner.run()

    def scalars(run_dir):
        with open(os.path.join(run_dir, "scalars.jsonl")) as f:
            return {row["tag"]: row["value"] for row in map(json.loads, f)}

    got, want = scalars(tr.run_dir), scalars(jr.run_dir)
    np.testing.assert_allclose(got["Train/Loss"], want["Train/Loss"], rtol=STEP_RTOL)
    np.testing.assert_allclose(got["Val/loss"], want["Val/loss"], rtol=VAL_LOSS_RTOL)
    for tag in ("Train/dice", "Val/dice", "Val/mIoU", "Val/Acc"):
        np.testing.assert_allclose(got[tag], want[tag], rtol=0, atol=POINTS, err_msg=tag)
    port = flat(convert.state_dict_to_variables(tr.model))
    jstate = jax.device_get(jr.state)
    ref = flat({"params": jstate.params, "batch_stats": jstate.batch_stats})
    assert port.keys() == ref.keys()
    for k, v in ref.items():
        bound = STATE_ATOL if k.startswith("params") else STATS_REL * max(1.0, np.abs(v).max())
        assert np.abs(port[k] - v).max() <= bound, k
    assert tr.state.step == len(tr.train_queue) > 0


@pytest.mark.parametrize("name", ["unet", "pspnet"])
def test_clis_train_test_and_export(name, tmp_path, capsys):
    logs = str(tmp_path / "logs")
    assert train_cli(["--config", CONFIG, "--model", name, "--depth", "3", "--epoch", "1",
                      "--log_root", logs, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    run_dir = out.split("run dir: ")[1].splitlines()[0].strip()
    best = ast.literal_eval(out.split("best: ")[1].splitlines()[0])
    assert os.path.basename(os.path.dirname(run_dir)) == name or name in run_dir
    ckpt = os.path.join(run_dir, "ckpt")

    assert eval_cli(["--config", CONFIG, "--model", name, "--resume", ckpt, "--batch_size",
                     "4", "--log_root", logs, "--device", "cpu"]) == 0
    result = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["dice"] == pytest.approx(best["best_dice"], abs=1e-6)

    art = str(tmp_path / "art")
    assert export_cli(["--config", CONFIG, "--model", name, "--resume", ckpt, "--out", art,
                       "--check", "--f32", "--device", "cpu"]) == 0
    assert "check OK" in capsys.readouterr().out
    pred = Predictor(art, device="cpu")
    assert pred.meta["model"] == name
    masks = pred.predict_masks(np.zeros((1, 64, 64, 1), np.float32))
    assert masks.shape == (1, 64, 64) and masks.dtype == np.uint8


def test_serving_takes_the_masks_of_an_aux_model():
    """With `aux_params` a zoo model returns ([masks], labels); the
    exported program serves the masks."""
    from senas_torch.models.zoo import Unet
    from senas_torch.serve import export_predict_fn

    model = Unet(classes=2, in_channels=1, encoder_depth=3, decoder_channels=(32, 16, 8),
                 aux_params={"classes": 4}, device="cpu").eval()
    exported = export_predict_fn(model, (32, 32, 1))
    x = torch.randn(3, 32, 32, 1)
    with torch.no_grad():
        (want,), labels = model(x)
        got = exported.module()(x)
    assert labels.shape == (3, 4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
