"""The port's serving export (senas_torch.serve and the export CLI) on the
CPU: a torch.export artifact of the fixed SenasModel (c 8, depth 3, 32x32),
given senas_tpu's weights through senas_torch.convert, answers at batch 1
and 3 with the JAX model's logits (rtol = atol = 1e-4) and with the eager
port model's exactly (a batch of 1 runs padded to the traced least of 2);
its masks are the argmax as uint8; it loads and runs
in a fresh interpreter that never imports senas_torch; the export CLI's
--check passes from a port checkpoint; the data-parallel Predictor over two
CPU replicas, at batch 4, 8 and 5 (the zero-pad path), gives exactly the
single Predictor's logits of each replica's half and its whole-batch
logits within the logit tolerance; and the precision flags are set and
restored, and the batch range kept, as the artifact says."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.models import geno_searched as jgs
from senas_tpu.models.senas_model import SenasModel as JModel
from senas_torch import convert
from senas_torch.core.config import load_config
from senas_torch.export_model import main as export_cli
from senas_torch.models import geno_searched as tgs
from senas_torch.models.senas_model import SenasModel
from senas_torch.serve import (FORMAT, Predictor, _LastLogits, batch_range, export_predict_fn,
                               load_artifact, save_artifact, serving_precision)
from senas_torch.train.checkpoint import CheckpointManager
from senas_torch.train.trainer import FixedTrainState

from torch_port_util import random_variables
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")
C, D, HW = 8, 3, 32
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    rng = np.random.RandomState(0)
    x = rng.randn(8, HW, HW, 1).astype(np.float32)
    jm = JModel(nclass=2, in_channels=1, c=C, depth=D, genotype=jgs.senas)
    variables = random_variables(jm, rng, jnp.asarray(x[:2]), False)
    model = convert.load_variables(
        SenasModel(2, 1, c=C, depth=D, genotype=tgs.senas, device="cpu"), variables)
    out_dir = str(tmp_path_factory.mktemp("artifact"))
    save_artifact(export_predict_fn(model, (HW, HW, 1), "float32"), {"model": "senas"}, out_dir)
    return dict(x=x, jm=jm, variables=variables, model=model, out_dir=out_dir,
                predictor=Predictor(out_dir, device="cpu"),
                data_parallel=Predictor(out_dir, data_parallel=True, devices=["cpu", "cpu"]))


@pytest.mark.parametrize("batch", [1, 3])
def test_round_trip_matches_jax(served, batch):
    x = served["x"][:batch]
    got = served["predictor"].logits(x)
    assert got.shape == (batch, HW, HW, 2) and got.dtype == torch.float32
    want = served["jm"].apply(served["variables"], jnp.asarray(x), False)[-1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    # the program runs batches of at least 2: a batch of 1 goes in with a
    # zero image beside it, and comes out as the eager model's first row
    least = served["predictor"].batch_range[0]
    padded = np.concatenate([x, np.zeros((max(least - batch, 0),) + x.shape[1:], np.float32)])
    with torch.inference_mode():
        eager = served["model"](torch.from_numpy(padded), train=False)[-1][:batch]
    torch.testing.assert_close(got, eager, rtol=0, atol=0)


def test_masks_are_the_argmax(served):
    x = served["x"][:3]
    masks = served["predictor"].predict_masks(x)
    assert masks.dtype == np.uint8 and masks.shape == (3, HW, HW)
    np.testing.assert_array_equal(masks, served["predictor"].logits(x).argmax(-1).numpy())


def test_artifact_meta(served):
    exported, meta = load_artifact(served["out_dir"])
    assert meta["format"] == FORMAT and meta["matmul_precision"] == "float32"
    assert meta["batch_range"] == [2, None] == list(batch_range(exported))
    assert meta["model"] == "senas" and meta["torch_version"] == torch.__version__
    assert exported.serving_precision == "float32"
    assert all(t.device.type == "cpu" for t in exported.state_dict.values())


_FRESH = r"""
import sys, numpy as np, torch
ep = torch.export.load(sys.argv[1] + "/model.pt2")
x = torch.from_numpy(np.load(sys.argv[2]))
np.save(sys.argv[3], ep.module()(x).detach().numpy())
print("PORT", sorted(m for m in sys.modules if m.split(".")[0] in ("senas_torch", "senas_tpu")))
"""


def test_artifact_loads_in_a_fresh_interpreter(served, tmp_path):
    np.save(tmp_path / "x.npy", served["x"][:3])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _FRESH, served["out_dir"], str(tmp_path / "x.npy"),
                          str(tmp_path / "y.npy")], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "PORT []" in out.stdout
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"),
                                  served["predictor"].logits(served["x"][:3]).numpy())


@pytest.mark.parametrize("batch", [4, 8, 5])
def test_data_parallel_equals_the_single_predictor(served, batch):
    dp = served["data_parallel"]
    assert len(dp._replicas) == 2
    x = served["x"][:batch]
    single = served["predictor"]
    got = dp.logits(x)
    # each replica ran one half of the zero-padded batch: exactly those logits
    padded = np.concatenate([x, np.zeros((batch % 2,) + x.shape[1:], np.float32)])
    half = len(padded) // 2
    want = torch.cat([single.logits(padded[:half]), single.logits(padded[half:])])[:batch]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # and the full batch at once within the logit tolerance (the CPU's
    # convolutions sum in a batch-dependent order: 1.3e-5 apart at batch 4)
    torch.testing.assert_close(got, single.logits(x), **LOGIT_TOL)
    np.testing.assert_array_equal(dp.predict_masks(x), got.argmax(-1).numpy())


def test_export_cli_check_from_a_port_checkpoint(tmp_path, capsys):
    t = load_config(CONFIG)["training"]
    model = SenasModel(2, 1, c=t["init_channels"], depth=t["depth"], genotype=tgs.senas,
                       device="cpu", generator=torch.Generator().manual_seed(4))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(FixedTrainState.create(model, t["model_optimizer"]), {"epoch": 2}, is_best=True)
    out = str(tmp_path / "art")
    assert export_cli(["--config", CONFIG, "--resume", ckpt.directory, "--out", out,
                       "--check", "--f32", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "check OK" in printed and "float32" in printed
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    assert meta["input_hw"] == [64, 64] and meta["checkpoint_name"] == "best"
    assert meta["checkpoint_meta"] == {"epoch": 2} and meta["matmul_precision"] == "float32"
    x = np.random.RandomState(1).randn(2, 64, 64, 1).astype(np.float32)
    with torch.inference_mode():
        want = model(torch.from_numpy(x), train=False)[-1]
    torch.testing.assert_close(Predictor(out, device="cpu").logits(x), want, rtol=0, atol=0)


def test_precision_flags_and_batch_range_follow_the_artifact(served, tmp_path):
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    before = flags()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with serving_precision("float32"):
            assert flags() == (False, False)
        assert flags() == (True, True)
        with serving_precision(None), serving_precision("backend-default"):
            assert flags() == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    with pytest.raises(ValueError, match="matmul_precision"):
        export_predict_fn(served["model"], (HW, HW, 1), "bf16")
    # a program of no recorded precision (backend-default) and batches 2-3
    with torch.no_grad():
        bounded = torch.export.export(
            _LastLogits(served["model"]).eval(), (torch.zeros(2, HW, HW, 1),),
            dynamic_shapes={"x": {0: torch.export.Dim("b", min=2, max=3)}})
    with pytest.raises(ValueError, match="exported for"):
        save_artifact(bounded, {"matmul_precision": "float32"}, str(tmp_path / "bad"))
    save_artifact(bounded, {}, str(tmp_path / "bounded"))
    pred = Predictor(str(tmp_path / "bounded"), device="cpu")
    assert pred.matmul_precision == "backend-default" and pred.batch_range == (2, 3)
    x = served["x"]
    torch.testing.assert_close(pred.logits(x[:1]), served["predictor"].logits(x[:1]),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="at most 3"):
        pred.logits(x[:4])


def test_no_card_no_fallback(served, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(served["out_dir"])
    with pytest.raises(ValueError, match="no CUDA device"):
        Predictor(served["out_dir"], data_parallel=True)
    with pytest.raises(RuntimeError, match="cuda"):
        export_cli(["--config", CONFIG, "--resume", str(tmp_path), "--out", str(tmp_path)])
    with open(os.path.join(served["out_dir"], "meta.json")) as f:
        meta = json.load(f)
    other = tmp_path / "other"
    other.mkdir()
    with open(other / "meta.json", "w") as f:
        json.dump({**meta, "format": "jax.export/stablehlo"}, f)
    with pytest.raises(ValueError, match="format"):
        load_artifact(str(other))
