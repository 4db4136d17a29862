"""The fixed model in bf16: senas_torch's SenasModel, its train and eval
steps and the losses with dtype=torch.bfloat16 against senas_tpu's with
dtype=jnp.bfloat16 on the CPU, from the same f32 weights and batches
(SenasModel(senas_node_4), c 8, depth 3, 32x32, batch 2; the optimizer of
configs/senas/senas_synthetic.yml's `training:`, clip 5, dice_ce).

The loss takes the bf16 logits as they are: its softmax, log-softmax and
means round op by op as jax.nn's and jnp's do, so the two packages' losses
on the same bf16 logits are equal bit for bit (checked). The bound, for
every other compared tensor (logits, running stats, loss, the weight
update, a loss's gradient): the relative L2 distance between the two
packages' bf16 results is at most twice the JAX package's bf16 result's
distance from its f32 result, plus 1e-6. The grad norm, one number that
sums up the gradient, is held to twice the JAX package's bf16 error of the
weight update the step applied. The control: each bf16 output is
torch.bfloat16 and fails 100 times the f32 parity tolerance of the
matching f32 test (logits rtol/atol 1e-4, tests/test_torch_senas_model.py;
the step's loss rtol 1e-5, tests/test_torch_train_step.py; a loss's
gradient, 100 x the losses' rtol 1e-5, tests/test_torch_loss_metrics.py,
as a relative L2 distance).
Worst seen on an x86 CPU: the logits at 0.47 of the bound, the weight
update at 0.51, the running stats at 0.49, the losses' gradients at 0.60;
the train and eval steps' losses equal bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.models import geno_searched as jgs
from senas_tpu.models.senas_model import SenasModel as JModel
from senas_tpu.train import loss as jloss
from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
from senas_tpu.train.trainer import FixedTrainState as JState
from senas_tpu.train.trainer import make_eval_step as jmake_eval
from senas_tpu.train.trainer import make_train_step as jmake_train
from senas_torch import convert
from senas_torch.core.config import load_config
from senas_torch.models import geno_searched as tgs
from senas_torch.models.factory import get_segmentation_model
from senas_torch.models.senas_model import SenasModel
from senas_torch.train import loss as tloss
from senas_torch.train.trainer import FixedTrainState, make_eval_step, make_train_step

from torch_port_util import (as_f64, assert_bf16_computed, assert_bf16_network, flat_leaves,
                             random_variables, rel_l2)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "senas", "senas_synthetic.yml")
C, D, HW, B = 8, 3, 32, 2
BF = torch.bfloat16
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STEP_RTOL = 1e-5
LOSSES = ("cross_entropy", "dice_ce", "dice_sq_ce", "dice_loss", "dice_square",
          "smp_dice", "smp_jaccard", "smp_tversky", "smp_focal", "smp_lovasz", "smp_soft_ce")


def _jmodel(dt):
    return JModel(nclass=2, in_channels=1, c=C, depth=D, genotype=jgs.senas_node_4, dtype=dt)


def _tmodel(dt, variables):
    return convert.load_variables(SenasModel(nclass=2, in_channels=1, c=C, depth=D,
                                             genotype=tgs.senas_node_4, dtype=dt,
                                             device="cpu"), variables)


@pytest.mark.parametrize("train", [False, True])
def test_senas_model_logits_bf16(train):
    rng = np.random.RandomState(2)
    x = rng.randn(B, HW, HW, 1).astype(np.float32)
    variables = random_variables(_jmodel(None), rng, jnp.asarray(x), False)
    want = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", None)):
        out, mut = _jmodel(dt).apply(variables, jnp.asarray(x), train, mutable=["batch_stats"])
        want[name] = (np.asarray(out[0].astype(jnp.float32)), mut.get("batch_stats", {}))
    got = {}
    for name, dt in (("bf16", BF), ("f32", None)):
        tm = _tmodel(dt, variables)
        with torch.no_grad():
            out = tm(torch.from_numpy(x), train=train)
        assert out[0].dtype == (dt or torch.float32) and out[0].shape == (B, HW, HW, 2)
        assert all(p.dtype == torch.float32 for p in tm.parameters())
        assert all(b.dtype == torch.float32 for b in tm.buffers())
        got[name] = (as_f64(out[0]), convert.state_dict_to_variables(tm)["batch_stats"])
    assert_bf16_network(got["bf16"][0], want["bf16"][0], want["f32"][0], what="logits")
    if train:
        assert_bf16_network(flat_leaves(got["bf16"][1]), flat_leaves(want["bf16"][1]),
                            flat_leaves(want["f32"][1]), what="running stats")
    assert_bf16_computed(got["bf16"][0], got["f32"][0], **LOGIT_TOL)


def test_factory_passes_the_dtype():
    m = get_segmentation_model("senas", dataset="synthetic", c=4, depth=2,
                               genotype=tgs.senas_node_2, dtype=BF, device="cpu")
    with torch.no_grad():
        out = m(torch.randn(1, 16, 16, 1), train=False)
    assert out[0].dtype == BF and all(p.dtype == torch.float32 for p in m.parameters())


@pytest.fixture(scope="module")
def step():
    """One train step from one state, then the eval step on a fresh batch:
    the JAX package in bf16 and f32, the port in bf16 and f32."""
    t = load_config(CONFIG)["training"]
    opt_cfg = t["model_optimizer"]
    rng = np.random.RandomState(0)
    mk = lambda: {"image": rng.randn(B, HW, HW, 1).astype(np.float32),
                  "label": (rng.rand(B, HW, HW) > 0.6).astype(np.int32)}
    batch, val = mk(), mk()
    variables = random_variables(_jmodel(None), rng, jnp.asarray(batch["image"]), False)
    out = {"before": flat_leaves(variables["params"])}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", None)):
        jm = _jmodel(dt)
        tx = jbuild_optimizer(dict(opt_cfg))
        jstep = jmake_train(jm.apply, jloss.build_loss("dice_ce"), tx, grad_clip=5.0,
                            donate=False)
        state, m = jstep(JState.create(variables, tx),
                         {k: jnp.asarray(v) for k, v in batch.items()})
        ev = jmake_eval(jm.apply, jloss.build_loss("dice_ce"))(
            state.params, state.batch_stats, {k: jnp.asarray(v) for k, v in val.items()})
        state = jax.device_get(state)
        out[f"jax_{name}"] = dict(m={k: np.asarray(v, np.float64) for k, v in m.items()},
                                  params=flat_leaves(state.params),
                                  stats=flat_leaves(state.batch_stats),
                                  eval={k: np.asarray(v.astype(jnp.float32) if k == "loss"
                                                      else v) for k, v in ev.items()})
    for name, dt in (("bf16", BF), ("f32", None)):
        tm = _tmodel(dt, variables)
        state = FixedTrainState.create(tm, opt_cfg)
        m = make_train_step(tloss.build_loss("dice_ce"), grad_clip=5.0)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        ev = make_eval_step(tm, tloss.build_loss("dice_ce"))(
            {k: torch.from_numpy(v) for k, v in val.items()})
        assert all(p.dtype == torch.float32 for p in tm.parameters())
        got = convert.state_dict_to_variables(tm)
        out[f"port_{name}"] = dict(m={k: as_f64(v) for k, v in m.items()},
                                   params=flat_leaves(got["params"]),
                                   stats=flat_leaves(got["batch_stats"]),
                                   eval={k: v.float().numpy() if k == "loss" else v.numpy()
                                         for k, v in ev.items()})
    return out


def test_train_step_loss_bf16(step):
    assert_bf16_network(*(step[w]["m"]["loss"] for w in ("port_bf16", "jax_bf16", "jax_f32")),
                        what="loss")
    assert rel_l2(step["port_bf16"]["m"]["loss"], step["port_f32"]["m"]["loss"]) > 100 * STEP_RTOL


def test_train_step_weight_update_and_grad_norm_bf16(step):
    upd = {k: step[k]["params"] - step["before"]
           for k in ("port_bf16", "jax_bf16", "jax_f32", "port_f32")}
    gap, own = assert_bf16_network(upd["port_bf16"], upd["jax_bf16"], upd["jax_f32"],
                                   what="weight update")
    gn_gap = rel_l2(step["port_bf16"]["m"]["grad_norm"], step["jax_bf16"]["m"]["grad_norm"])
    assert gn_gap <= 2 * own + 1e-6, (gn_gap, own)
    assert rel_l2(upd["port_bf16"], upd["port_f32"]) > 100 * STEP_RTOL


def test_train_step_running_stats_bf16(step):
    assert_bf16_network(step["port_bf16"]["stats"], step["jax_bf16"]["stats"],
                        step["jax_f32"]["stats"], what="running stats")


def test_eval_step_bf16(step):
    got, want = step["port_bf16"]["eval"], step["jax_bf16"]["eval"]
    assert_bf16_network(got["loss"], want["loss"], step["jax_f32"]["eval"]["loss"],
                        what="eval loss")
    assert got["pred"].dtype == np.uint8 and got["pred"].shape == (B, HW, HW)
    # the argmax of bf16 logits: where the two packages' pixels disagree,
    # JAX's own bf16 and f32 predictions disagree about as often
    flips = float((got["pred"] != want["pred"]).mean())
    own = float((want["pred"] != step["jax_f32"]["eval"]["pred"]).mean())
    assert flips <= 2 * own + 1e-3, (flips, own)


@pytest.mark.parametrize("name", LOSSES)
def test_losses_on_bf16_logits(name):
    rng = np.random.RandomState(5)
    logits = np.asarray(jnp.asarray((2 * rng.randn(B, 16, 16, 3)).astype(np.float32))
                        .astype(jnp.bfloat16).astype(jnp.float32))
    label = rng.randint(0, 3, size=(B, 16, 16)).astype(np.int32)
    jf = jloss.build_loss(name)
    want = {}
    for key, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        v, g = jax.value_and_grad(lambda a: jf(a, jnp.asarray(label)))(
            jnp.asarray(logits).astype(dt))
        want[key] = (np.float64(v.astype(jnp.float32)), np.asarray(g.astype(jnp.float32)))
    got = {}
    for key, dt in (("bf16", BF), ("f32", torch.float32)):
        t = torch.from_numpy(logits).to(dt).requires_grad_()
        v = tloss.build_loss(name)(t, torch.from_numpy(label))
        assert v.dtype == dt
        v.backward()
        assert t.grad.dtype == dt
        got[key] = (as_f64(v), as_f64(t.grad))
    assert got["bf16"][0] == want["bf16"][0], (got["bf16"][0], want["bf16"][0])
    assert_bf16_network(got["bf16"][1], want["bf16"][1], want["f32"][1], what="gradient")
    assert rel_l2(got["bf16"][1], got["f32"][1]) > 100 * 1e-5


@pytest.mark.parametrize("smooth_factor,ignore_index", [(None, None), (0.1, 1), (0.25, -100)])
def test_soft_ce_on_bf16_logits_with_smoothing_and_ignore(smooth_factor, ignore_index):
    """SoftCrossEntropyLoss on bf16 logits: its log-softmax, means and
    smoothing weights round as the JAX package's (bf16(0.9) for 1 - 0.1),
    bit for bit, with pixels of the ignored class masked."""
    from senas_tpu.train import smp_losses as jsmp
    from senas_torch.train import smp_losses as tsmp
    rng = np.random.RandomState(6)
    logits = np.asarray(jnp.asarray((2 * rng.randn(B, 16, 16, 3)).astype(np.float32))
                        .astype(jnp.bfloat16).astype(jnp.float32))
    label = rng.randint(0, 3, size=(B, 16, 16)).astype(np.int32)
    kw = dict(smooth_factor=smooth_factor, ignore_index=ignore_index)
    want = jsmp.SoftCrossEntropyLoss(**kw)(jnp.asarray(logits).astype(jnp.bfloat16),
                                           jnp.asarray(label))
    got = tsmp.SoftCrossEntropyLoss(**kw)(torch.from_numpy(logits).to(BF),
                                          torch.from_numpy(label))
    assert got.dtype == BF
    assert as_f64(got) == np.float64(want.astype(jnp.float32))
