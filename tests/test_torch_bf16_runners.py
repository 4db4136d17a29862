"""The runners with `precision: bf16` against senas_tpu's on
configs/senas/senas_synthetic.yml, on the CPU, cut in size (64x64 samples
to 32x32, 32 samples to 16, depth 3 to 2): one `SearchRunner`
epoch with arch steps (alpha_begin 0) and one `TrainRunner` epoch, from the
same weights (and arch tables) through `senas_torch.convert`, each package
in bf16 and in f32.

The bound of the other bf16 tests (tests/test_torch_bf16_fixed.py): the
epoch's losses, the weights' and arch tables' updates and the BN running
stats of the two packages' bf16 runs lie at most twice as far apart
(relative L2) as the JAX package's bf16 run lies from its f32 run, plus
1e-6. The control: the port's bf16 updates lie further than 100 x the f32
runner tests' tolerance (1e-5, tests/test_torch_m9b_runners.py) from its
f32 run's. The checkpoints hold f32 weights, so the bf16 train run's
checkpoint evaluates in an f32 TestRunner, as in the JAX package. Worst
seen on an x86 CPU: the train epoch's losses at 0.63 of the bound, the
weight updates at 0.49 (search) and 0.52 (train)."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from senas_torch import convert
from senas_torch.core.config import load_config
from senas_torch.runner import search as tsearch
from senas_torch.runner import test as ttest
from senas_torch.runner import train as ttrain

from torch_port_util import assert_bf16_network, flat_leaves, random_variables, rel_l2
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "senas", "senas_synthetic.yml")
F32_TOL = 1e-5
TAGS = {"search": ("Train/Loss", "Val/loss"), "train": ("Train/Loss", "Val/loss")}


def _cfg(precision):
    cfg = load_config(CONFIG)
    cfg["data"].update(hw=32, size=16)
    for name in ("searching", "training"):
        cfg[name].update(epoch=1, precision=precision)
        cfg[name]["depth"] = 2
    cfg["searching"]["alpha_begin"] = 0
    return json.loads(json.dumps(cfg))


def _scalars(run_dir, tags):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        rows = {row["tag"]: row["value"] for row in map(json.loads, f)}
    return np.array([rows[t] for t in tags], np.float64)


def _quiet(module, monkeypatch):
    # scalars.jsonl only: TensorBoard's writer would import TensorFlow
    monkeypatch.setattr(module, "ScalarWriter",
                        functools.partial(module.ScalarWriter, use_tensorboard=False))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from senas_tpu.models import senas_model as jmodel
    from senas_tpu.runner import search as jsearch
    from senas_tpu.runner import train as jtrain

    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("bf16_runners")
    for module in (jsearch, jtrain):
        _quiet(module, mp)
    # flax's initialisers run op by op; numpy fills the trees' shapes instead
    for cls in (jsearch.SenasSearch, jmodel.SenasModel):
        init = cls.init
        mp.setattr(cls, "init", lambda self, rngs, *args, _init=init: random_variables(
            self, np.random.RandomState(0), *args, init=functools.partial(_init, self)))
    out = {}
    try:
        for kind, jrun, trun in (("search", jsearch.SearchRunner, tsearch.SearchRunner),
                                 ("train", jtrain.TrainRunner, ttrain.TrainRunner)):
            for precision in ("bf16", "f32"):
                jr = jrun(_cfg(precision), log_root=str(tmp / f"j_{kind}_{precision}"))
                tr = trun(_cfg(precision), log_root=str(tmp / f"t_{kind}_{precision}"),
                          device="cpu")
                model = tr.state.model if kind == "search" else tr.model
                convert.load_variables(model, {"params": jax.device_get(jr.state.params),
                                               "batch_stats": jax.device_get(jr.state.batch_stats)})
                if kind == "search":
                    with torch.no_grad():
                        for k, t in tr.state.arch.items():
                            t.copy_(torch.from_numpy(np.array(jr.state.arch[k])))
                before = dict(params=flat_leaves(jax.device_get(jr.state.params)),
                              arch=flat_leaves(getattr(jr.state, "arch", {})))
                for runner in (jr, tr):
                    runner.run()
                jstate = jax.device_get(jr.state)
                got = convert.state_dict_to_variables(model)
                tags = TAGS[kind]
                out[(kind, "jax", precision)] = dict(
                    scalars=_scalars(jr.run_dir, tags),
                    params=flat_leaves(jstate.params) - before["params"],
                    stats=flat_leaves(jstate.batch_stats),
                    arch=flat_leaves(getattr(jstate, "arch", {})) - before["arch"])
                out[(kind, "port", precision)] = dict(
                    scalars=_scalars(tr.run_dir, tags),
                    params=flat_leaves(got["params"]) - before["params"],
                    stats=flat_leaves(got["batch_stats"]),
                    arch=(flat_leaves(convert.arch_to_numpy(tr.state.arch)) - before["arch"]
                          if kind == "search" else before["arch"]),
                    runner=tr)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("kind,part", [("search", "scalars"), ("search", "params"),
                                       ("search", "stats"), ("search", "arch"),
                                       ("train", "scalars"), ("train", "params"),
                                       ("train", "stats")])
def test_bf16_runner_epoch_matches_jax(runs, kind, part):
    assert_bf16_network(runs[(kind, "port", "bf16")][part], runs[(kind, "jax", "bf16")][part],
                        runs[(kind, "jax", "f32")][part], what=f"{kind} {part}")
    if part in ("params", "arch"):
        assert rel_l2(runs[(kind, "port", "bf16")][part],
                      runs[(kind, "port", "f32")][part]) > 100 * F32_TOL


@pytest.mark.parametrize("kind", ["search", "train"])
def test_bf16_runner_computes_in_bf16_and_keeps_f32_masters(runs, kind):
    runner = runs[(kind, "port", "bf16")]["runner"]
    assert runner.dtype == torch.bfloat16
    model = runner.state.model
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    payload = runner.ckpt.restore_raw("last")
    assert all(v.dtype == torch.float32 for v in payload["model"].values()
               if v.is_floating_point())


def test_bf16_train_checkpoint_evaluates_in_f32(runs, tmp_path):
    """A bf16 run's checkpoint holds f32 weights, so an f32 TestRunner (the
    default, as in the JAX package) loads and evaluates it; so does a bf16
    one."""
    runner = runs[("train", "port", "bf16")]["runner"]
    results = {}
    for dtype in (None, torch.bfloat16):
        tr = ttest.TestRunner(_cfg("bf16"), resume=runner.ckpt.directory,
                              log_root=str(tmp_path), batch_size=4, device="cpu", dtype=dtype)
        with torch.no_grad():
            out = tr.model(torch.zeros(1, 32, 32, 1), train=False)
        assert out[0].dtype == (dtype or torch.float32)
        results[dtype] = tr.run(save_images=False)
    assert np.isfinite(results[None]["loss"]) and np.isfinite(results[torch.bfloat16]["loss"])
