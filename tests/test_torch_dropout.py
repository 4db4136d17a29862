"""`dropout_prob > 0` for the SENAS models and `channel_shuffle` in the
port, against senas_tpu on the CPU:

- senas_tpu's fixed train step (SenasModel senas_node_4 at c 8, depth 2,
  32x32, batch 4, dropout_prob 0.2, SGD of configs/senas/senas_synthetic.yml,
  clip 5, dice_ce) with `spatial_dropout` wrapped by `monkeypatch` to
  record each [B, 1, 1, C] mask it draws (in call order, through
  `jax.debug.callback`); the port's step replays them in that order
  (`primitives.channel_dropout_mask` patched) and lands within
  tests/test_torch_train_step.py's bounds (loss and grad norm rtol 1e-5,
  every weight and running stat atol 1e-5) over two steps. Batch 4, not
  that file's 2: at batch 2 a channel that every sample drops is common
  (p^2 = 0.04 a channel), and with the masks of seed 0 they put the step
  on a kink of the loss, where the packages take different one-sided
  derivatives (a central difference in f64 along their gradients'
  difference: the forward difference is the port's directional
  derivative, the backward difference senas_tpu's; grad norm 1.3647 and
  1.3645); the port's own f32 and f64 steps agree there within 1e-7;
- the port's own draws: the kept share of 20,000 channels within 4.5
  binomial standard deviations of 1 - p, kept channels scaled by
  exactly 1 / (1 - p) and dropped ones 0;
- `remat` on and off: two steps give the same metrics, weights and
  running stats (equal in f64 up to 1e-12 of their scale);
- a run resumed from a state_dict after one step draws the masks the
  uninterrupted run drew (the same second step, exactly);
- two gloo ranks over MeshSpec(1, 2) and MeshSpec(2, 1) match one process
  in f64 within 1e-10 of each result's scale;
- `channel_shuffle` equals the JAX package's (NHWC there, NCHW here).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.models import geno_searched as jgs
from senas_tpu.models.senas_model import SenasModel as JModel
from senas_tpu.ops import primitives as jprim
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
from senas_tpu.train.trainer import FixedTrainState as JState
from senas_tpu.train.trainer import make_train_step as jmake_train
from senas_torch import convert
from senas_torch import ops as tops
from senas_torch.core.config import load_config
from senas_torch.models import geno_searched as tgs
from senas_torch.models.senas_model import SenasModel
from senas_torch.ops import primitives as tprim
from senas_torch.train.loss import build_loss as tbuild_loss
from senas_torch.train.trainer import FixedTrainState, make_train_step

from torch_mesh_workers import CASES, Ranks, combine
from torch_port_util import assert_trees_close, flat, random_variables
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "senas", "senas_synthetic.yml")
C, D, HW, B, STEPS, P = 8, 3, 32, 2, 2, 0.2
REPLAY_D = 2
REPLAY_B = 4
STEP_RTOL = 1e-5
STATE_ATOL = 1e-5
F64_REL = 1e-10


def _batches(rng, n, b=B, hw=HW):
    return [{"image": rng.randn(b, hw, hw, 1).astype(np.float32),
             "label": (rng.rand(b, hw, hw) > 0.6).astype(np.int32)} for _ in range(n)]


def _t(batch, dtype=torch.float32):
    return {"image": torch.from_numpy(batch["image"]).to(dtype),
            "label": torch.from_numpy(batch["label"])}


def test_replays_senas_tpus_masks(monkeypatch):
    t = load_config(CONFIG)["training"]
    rng = np.random.RandomState(0)
    batches = _batches(rng, STEPS, b=REPLAY_B)
    jm = JModel(nclass=2, in_channels=1, c=C, depth=REPLAY_D, genotype=jgs.senas_node_4,
                dropout_prob=P)
    variables = random_variables(jm, rng, jnp.asarray(batches[0]["image"]), False)

    recorded = []
    original = jprim.spatial_dropout

    def recording(x, rate, deterministic, rng=None):
        if deterministic or rate == 0.0:
            return original(x, rate, deterministic, rng)
        keep = 1.0 - rate
        mask = jax.random.bernoulli(rng, keep, (x.shape[0], 1, 1, x.shape[3]))
        jax.debug.callback(lambda m: recorded.append(np.asarray(m)), mask, ordered=True)
        return jnp.where(mask, x / keep, 0.0)

    monkeypatch.setattr(jprim, "spatial_dropout", recording)
    tx = jbuild_optimizer(dict(t["model_optimizer"]))
    jstep = jmake_train(jm.apply, jbuild_loss("dice_ce"), tx, grad_clip=t["grad_clip"],
                        donate=False)
    jstate, jmetrics, masks = JState.create(variables, tx), [], []
    for batch in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jmetrics.append({k: np.asarray(v) for k, v in m.items()})
        jax.effects_barrier()     # this step's masks, in the order it drew them
        masks += [np.transpose(m, (0, 3, 1, 2)) for m in recorded]   # NHWC -> NCHW
        recorded.clear()

    drawn = []
    monkeypatch.setattr(tprim, "channel_dropout_mask",
                        lambda gen, shape, keep: drawn.append(shape) or torch.from_numpy(
                            masks[len(drawn) - 1].copy()))
    tm = convert.load_variables(SenasModel(nclass=2, in_channels=1, c=C, depth=REPLAY_D,
                                           genotype=tgs.senas_node_4, dropout_prob=P,
                                           device="cpu"), variables)
    state = FixedTrainState.create(tm, t["model_optimizer"])
    tstep = make_train_step(tbuild_loss("dice_ce"), grad_clip=t["grad_clip"])
    tmetrics = [{k: v.numpy() for k, v in tstep(state, _t(b)).items()} for b in batches]
    assert len(drawn) == len(masks) > 0
    assert [tuple(s) for s in drawn] == [m.shape for m in masks]
    assert 0 < np.mean([m.mean() for m in masks]) < 1
    for i, (got, want) in enumerate(zip(tmetrics, jmetrics)):
        for k in ("loss", "grad_norm", "acc"):
            np.testing.assert_allclose(got[k], want[k], rtol=STEP_RTOL, err_msg=f"step {i} {k}")
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"step {i} {k}")
    got = convert.state_dict_to_variables(tm)
    assert_trees_close(got["params"], jstate.params, rtol=0, atol=STATE_ATOL)
    assert_trees_close(got["batch_stats"], jstate.batch_stats, rtol=0, atol=STATE_ATOL)


def test_own_draws_keep_and_scale():
    x = torch.ones(200, 100, 2, 3, dtype=torch.float64)
    gen = torch.Generator().manual_seed(5)
    y = tprim.spatial_dropout(x, P, True, gen)
    kept = y[:, :, 0, 0] != 0
    share, n = kept.double().mean().item(), kept.numel()
    assert abs(share - (1 - P)) < 4.5 * np.sqrt(P * (1 - P) / n), share
    assert torch.equal(y[kept[..., None, None].expand_as(y)],
                       torch.full((int(kept.sum()) * 6,), 1 / (1 - P), dtype=torch.float64))
    assert bool((y == y[:, :, :1, :1]).all())          # whole channels
    assert tprim.spatial_dropout(x, P, False, None) is x
    with pytest.raises(ValueError, match="generator"):
        tprim.spatial_dropout(x, P, True, None)
    with pytest.raises(ValueError, match="rng"):
        SenasModel(nclass=2, in_channels=1, c=4, depth=2, genotype=tgs.senas_node_4,
                   dropout_prob=P, device="cpu")(torch.zeros(1, 8, 8, 1), train=True)


def _f64_run(remat=False, steps=STEPS, state_from=None):
    t = load_config(CONFIG)["training"]
    batches = _batches(np.random.RandomState(1), steps)
    net = SenasModel(nclass=2, in_channels=1, c=C, depth=D, genotype=tgs.senas_node_4,
                     dropout_prob=P, remat=remat, device="cpu",
                     generator=torch.Generator().manual_seed(3)).double()
    state = FixedTrainState.create(net, t["model_optimizer"], seed=7)
    first = 0
    if state_from is not None:
        state.load_state_dict(state_from)
        first = state.step
    step = make_train_step(tbuild_loss("dice_ce"), grad_clip=t["grad_clip"])
    metrics = [{k: v.numpy() for k, v in step(state, _t(b, torch.float64)).items()}
               for b in batches[first:]]
    return metrics, convert.state_dict_to_variables(net), state


def test_remat_and_resume_draw_the_same_masks():
    plain, plain_vars, _ = _f64_run()
    remat, remat_vars, _ = _f64_run(remat=True)
    for a, b in zip(plain, remat):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-12)
    for coll in ("params", "batch_stats"):
        assert_trees_close(remat_vars[coll], plain_vars[coll], rtol=1e-12, atol=1e-12)
    # resumed after one step: the second step's masks are the first run's
    _, _, once = _f64_run(steps=1)
    payload = once.state_dict()
    resumed, resumed_vars, _ = _f64_run(state_from=payload)
    assert len(resumed) == 1
    for k in ("loss", "grad_norm"):
        assert resumed[0][k] == plain[1][k], k
    for coll in ("params", "batch_stats"):
        for key, v in flat(plain_vars[coll]).items():
            np.testing.assert_array_equal(flat(resumed_vars[coll])[key], v, err_msg=key)


def test_mesh_ranks_match_one_process_f64(tmp_path):
    t = load_config(CONFIG)["training"]
    rng = np.random.RandomState(2)
    kw = dict(batches=_batches(rng, 2, b=4, hw=24), eval_batch=_batches(rng, 1, b=4, hw=24)[0],
              opt_cfg=t["model_optimizer"], clip=t["grad_clip"], c=C, depth=D,
              dropout_prob=P)
    specs = [(1, 2), (2, 1)]
    ranks = Ranks([("spatial_fixed_steps", dict(kw, mesh_spec=s)) for s in specs], tmp_path, 2,
                  timeout=240)
    single = CASES["spatial_fixed_steps"](None, **kw)
    results = ranks.results()
    assert single["step0"]["loss"] != single["step1"]["loss"]
    for i, spec in enumerate(specs):
        got = combine([r[i] for r in results], spec)
        for step in ("step0", "step1", "eval"):
            for k, v in single[step].items():
                if np.issubdtype(v.dtype, np.integer):
                    np.testing.assert_array_equal(got[step][k], v, err_msg=f"{spec} {step} {k}")
                else:
                    np.testing.assert_allclose(got[step][k], v, rtol=F64_REL, atol=1e-300,
                                               err_msg=f"{spec} {step} {k}")
        for coll in ("params", "batch_stats"):
            g, w = flat(got["variables"][coll]), flat(single["variables"][coll])
            scale = max(float(np.max(np.abs(v))) for v in w.values() if v.size)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=F64_REL * scale,
                                           err_msg=f"{spec} {coll} {k}")


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_channel_shuffle_matches_jax(groups):
    x = np.random.RandomState(groups).randn(2, 5, 4, 6).astype(np.float32)   # NHWC
    want = np.asarray(jprim.channel_shuffle(jnp.asarray(x), groups))
    got = tops.channel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), groups)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
