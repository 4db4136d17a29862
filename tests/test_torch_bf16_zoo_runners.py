"""The baseline zoo through the runners with `precision: bf16`, against
senas_tpu's, on the CPU: one `TrainRunner` epoch of `unet` and of `fpn` on
configs/senas/senas_synthetic.yml's `training:` (depth 3, batch 4, SGD
6e-3 / 0.9 / 5e-4, clip 5, dice_ce), cut in size (64x64 samples to 32x32,
32 samples to 16), from the same weights (numpy-made, norm scales at 1,
through senas_torch.convert), each package in bf16 and in f32.

The bound of the other bf16 tests (tests/test_torch_bf16_runners.py): the
epoch's train and val losses, the weight updates and the BN running stats
of the two packages' bf16 runs lie at most twice as far apart (relative
L2) as senas_tpu's bf16 run lies from its f32 run, plus 1e-6. The control:
the port's bf16 weight update lies further than 100 x the f32 runner tests'
tolerance from its f32 run's. The bf16 run's checkpoint holds f32 weights,
so an f32 TestRunner (the default, as in senas_tpu) evaluates it."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from senas_torch import convert
from senas_torch.core.config import load_config
from senas_torch.runner import test as ttest
from senas_torch.runner import train as ttrain

from torch_port_util import (assert_bf16_network, flat_leaves, random_variables, rel_l2,
                             unit_scales)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")
F32_TOL = 1e-5
TAGS = ("Train/Loss", "Val/loss")
MODELS = {"unet": "Unet", "fpn": "FPN"}


def _cfg(precision):
    cfg = load_config(CONFIG)
    cfg["data"].update(hw=32, size=16)
    cfg["training"].update(epoch=1, precision=precision)
    return json.loads(json.dumps(cfg))


def _scalars(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        rows = {row["tag"]: row["value"] for row in map(json.loads, f)}
    return np.array([rows[t] for t in TAGS], np.float64)


@pytest.fixture(scope="module", params=list(MODELS))
def runs(request, tmp_path_factory):
    import jax
    from senas_tpu.models import zoo as jzoo
    from senas_tpu.runner import train as jtrain

    name = request.param
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp(f"bf16_zoo_{name}")
    # scalars.jsonl only: TensorBoard's writer would import TensorFlow
    mp.setattr(jtrain, "ScalarWriter",
               functools.partial(jtrain.ScalarWriter, use_tensorboard=False))
    # flax's initialisers run op by op; numpy fills the tree's shapes (with
    # unit norm scales: tests/test_torch_zoo.py)
    cls = getattr(jzoo, MODELS[name])
    init = cls.init
    mp.setattr(cls, "init", lambda self, rngs, *args: unit_scales(random_variables(
        self, np.random.RandomState(0), *args, init=functools.partial(init, self))))
    out = {}
    try:
        for precision in ("bf16", "f32"):
            jr = jtrain.TrainRunner(_cfg(precision), model_name=name,
                                    log_root=str(tmp / f"j_{precision}"))
            tr = ttrain.TrainRunner(_cfg(precision), model_name=name,
                                    log_root=str(tmp / f"t_{precision}"), device="cpu")
            convert.load_variables(tr.model, {"params": jax.device_get(jr.state.params),
                                              "batch_stats": jax.device_get(jr.state.batch_stats)})
            before = flat_leaves(jax.device_get(jr.state.params))
            for runner in (jr, tr):
                runner.run()
            jstate = jax.device_get(jr.state)
            got = convert.state_dict_to_variables(tr.model)
            out[("jax", precision)] = dict(scalars=_scalars(jr.run_dir),
                                           params=flat_leaves(jstate.params) - before,
                                           stats=flat_leaves(jstate.batch_stats))
            out[("port", precision)] = dict(scalars=_scalars(tr.run_dir),
                                            params=flat_leaves(got["params"]) - before,
                                            stats=flat_leaves(got["batch_stats"]), runner=tr)
    finally:
        mp.undo()
    return name, out


@pytest.mark.parametrize("part", ["scalars", "params", "stats"])
def test_bf16_zoo_epoch_matches_jax(runs, part):
    name, r = runs
    assert_bf16_network(r[("port", "bf16")][part], r[("jax", "bf16")][part],
                        r[("jax", "f32")][part], what=f"{name} {part}")
    if part == "params":
        assert rel_l2(r[("port", "bf16")][part], r[("port", "f32")][part]) > 100 * F32_TOL


def test_bf16_zoo_checkpoint_evaluates_in_f32(runs, tmp_path):
    """The bf16 run computed in bf16 over f32 masters; its checkpoint holds
    f32 only and evaluates in an f32 TestRunner."""
    name, r = runs
    runner = r[("port", "bf16")]["runner"]
    assert runner.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in runner.model.parameters())
    payload = runner.ckpt.restore_raw("last")
    assert all(v.dtype == torch.float32 for v in payload["model"].values()
               if v.is_floating_point())
    tr = ttest.TestRunner(_cfg("bf16"), resume=runner.ckpt.directory, model_name=name,
                          log_root=str(tmp_path), batch_size=4, device="cpu")
    with torch.no_grad():
        out = tr.model(torch.zeros(1, 32, 32, 1), train=False)
    assert out[0].dtype == torch.float32
    result = tr.run(save_images=False)
    assert np.isfinite(result["loss"]) and 0 <= result["dice"] <= 100
