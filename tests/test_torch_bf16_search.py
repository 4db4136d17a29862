"""The search path in bf16: senas_torch's SenasSearch and bilevel search
step with dtype=torch.bfloat16 against senas_tpu's with dtype=jnp.bfloat16
on the CPU, from the same f32 weights, arch tables and batches (meta 2,
depth 2, c 8, 16x16, batch 2); the JAX side runs its CPU default (the
unfused epilogue). GroupedMixedOp and FusedSearchCell:
tests/test_torch_bf16_cells.py.

The bound, for every compared tensor (logits, running stats, loss, grad
norm, the weights' and the arch tables' updates): the relative L2 distance
between the two packages' bf16 results is at most twice the JAX package's
bf16 result's distance from its f32 result (bf16's own error), plus 1e-6.
The grad norm, one number that sums up the gradient, is held to twice the
JAX package's bf16 error of the weight update the step applied. The
control: each bf16 output is torch.bfloat16, and the port's bf16 result
fails 100 times the f32 parity tolerance of the matching f32 test (logits
rtol 2e-4 / atol 2e-5, tests/test_torch_supernet.py; the step rtol 1e-5,
tests/test_torch_search_step.py, on the updates' relative L2 distance).
Worst seen on an x86 CPU: the logits at 0.44 of the bound, the step's
weight and arch updates at 0.42 and 0.54, its running stats at 0.39. bf16
moved the logits 0.7-1.5% (relative L2) from f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.search import supernet as jsn
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
from senas_tpu.train.trainer import SearchTrainState as JState
from senas_tpu.train.trainer import make_search_step as jmake_step
from senas_torch import convert
from senas_torch.search import supernet as tsn
from senas_torch.train.loss import build_loss as tbuild_loss
from senas_torch.train.trainer import SearchTrainState, make_search_step

from torch_port_util import (as_f64, assert_bf16_computed, assert_bf16_network, flat_leaves,
                             random_variables, rel_l2)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

B = 2
BF = torch.bfloat16
# the f32 parity tolerances of the matching f32 tests
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)        # tests/test_torch_supernet.py
STEP_RTOL = 1e-5                              # tests/test_torch_search_step.py


M, D, C, HW = 2, 2, 8, 16


@pytest.fixture(scope="module")
def nets():
    rng = np.random.RandomState(0)
    arch = {k: rng.randn(*v).astype(np.float32)
            for k, v in jsn.arch_param_count(M, D).items()}
    x = rng.randn(B, HW, HW, 1).astype(np.float32)
    mk = lambda dt: jsn.SenasSearch(in_channels=1, c=C, nclass=2, depth=D, meta_node_num=M,
                                    dtype=dt)
    variables = random_variables(mk(None), rng, jnp.asarray(x),
                                 jsn.normalize_arch(arch, M), False)
    return dict(arch=arch, x=x, mk=mk, variables=variables)


@pytest.mark.parametrize("train", [False, True])
def test_supernet_logits_bf16(nets, train):
    aw = jsn.normalize_arch(nets["arch"], M)
    want = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", None)):
        out, mut = nets["mk"](dt).apply(nets["variables"], jnp.asarray(nets["x"]), aw, train,
                                        mutable=["batch_stats"])
        want[name] = (np.asarray(out[0].astype(jnp.float32)), mut.get("batch_stats", {}))
    got = {}
    for name, dt in (("bf16", BF), ("f32", None)):
        tm = convert.load_variables(tsn.SenasSearch(in_channels=1, c=C, nclass=2, depth=D,
                                                    meta_node_num=M, dtype=dt, device="cpu"),
                                    nets["variables"])
        with torch.no_grad():
            out = tm(torch.from_numpy(nets["x"]),
                     tsn.normalize_arch(convert.arch_to_torch(nets["arch"], "cpu"), M),
                     train=train)
        assert out[0].dtype == (dt or torch.float32) and out[0].shape == (B, HW, HW, 2)
        assert all(p.dtype == torch.float32 for p in tm.parameters())
        assert all(b.dtype == torch.float32 for b in tm.buffers())
        got[name] = (as_f64(out[0]), convert.state_dict_to_variables(tm)["batch_stats"])
    assert_bf16_network(got["bf16"][0], want["bf16"][0], want["f32"][0], what="logits")
    if train:
        assert_bf16_network(flat_leaves(got["bf16"][1]), flat_leaves(want["bf16"][1]),
                            flat_leaves(want["f32"][1]), what="running stats")
    assert_bf16_computed(got["bf16"][0], got["f32"][0], **LOGIT_TOL)


@pytest.fixture(scope="module")
def step():
    """One bilevel step (do_arch: the arch step on the val batch, then the
    weight step on the train batch) from one state, with the optimizers of
    configs/senas/senas_synthetic.yml: the JAX package in bf16 and f32, the
    port in bf16 and f32."""
    import os
    from senas_torch.core.config import load_config
    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "configs", "senas", "senas_synthetic.yml"))["searching"]
    w_cfg, a_cfg = cfg["model_optimizer"], cfg["arch_optimizer"]
    rng = np.random.RandomState(1)
    arch = {k: (0.5 * rng.randn(*v)).astype(np.float32)
            for k, v in jsn.arch_param_count(M, D).items()}
    mkb = lambda: {"image": rng.randn(B, HW, HW, 1).astype(np.float32),
                   "label": (rng.rand(B, HW, HW) > 0.6).astype(np.int32)}
    tb, vb = mkb(), mkb()
    mk = lambda dt: jsn.SenasSearch(in_channels=1, c=C, nclass=2, depth=D, meta_node_num=M,
                                    dtype=dt)
    variables = random_variables(mk(None), rng, jnp.asarray(tb["image"]),
                                 jsn.normalize_arch(arch, M), False)
    out = {"before": dict(params=flat_leaves(variables["params"]), arch=flat_leaves(arch))}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", None)):
        w_tx, a_tx = jbuild_optimizer(dict(w_cfg)), jbuild_optimizer(dict(a_cfg))
        jstep = jmake_step(mk(dt).apply, lambda a: jsn.normalize_arch(a, M),
                           jbuild_loss("dice_ce"), w_tx, a_tx, grad_clip=5.0, donate=False)
        state, m = jstep(JState.create(variables, arch, w_tx, a_tx),
                         {k: jnp.asarray(v) for k, v in tb.items()},
                         {k: jnp.asarray(v) for k, v in vb.items()}, True)
        state = jax.device_get(state)
        out[f"jax_{name}"] = dict(m={k: np.asarray(v, np.float64) for k, v in m.items()},
                                  params=flat_leaves(state.params),
                                  stats=flat_leaves(state.batch_stats),
                                  arch=flat_leaves({k: np.asarray(v)
                                                    for k, v in state.arch.items()}))
    for name, dt in (("bf16", BF), ("f32", None)):
        tm = convert.load_variables(
            tsn.SenasSearch(in_channels=1, c=C, nclass=2, depth=D, meta_node_num=M,
                            dtype=dt, device="cpu"), variables)
        state = SearchTrainState.create(tm, convert.arch_to_torch(arch, "cpu"), w_cfg, a_cfg)
        tstep = make_search_step(lambda a: tsn.normalize_arch(a, M), tbuild_loss("dice_ce"),
                                 grad_clip=5.0)
        m = tstep(state, {k: torch.from_numpy(v) for k, v in tb.items()},
                  {k: torch.from_numpy(v) for k, v in vb.items()}, True)
        assert all(p.dtype == torch.float32 for p in tm.parameters())
        assert all(t.dtype == torch.float32 for t in state.arch.values())
        got = convert.state_dict_to_variables(tm)
        out[f"port_{name}"] = dict(m={k: as_f64(v) for k, v in m.items()},
                                   params=flat_leaves(got["params"]),
                                   stats=flat_leaves(got["batch_stats"]),
                                   arch=flat_leaves(convert.arch_to_numpy(state.arch)))
    return out


def _updates(step, part):
    return {k: step[k][part] - step["before"][part]
            for k in ("port_bf16", "jax_bf16", "jax_f32", "port_f32")}


@pytest.mark.parametrize("key", ["loss", "arch_loss"])
def test_search_step_losses_bf16(step, key):
    assert_bf16_network(*(step[w]["m"][key] for w in ("port_bf16", "jax_bf16", "jax_f32")),
                        what=key)


def test_search_step_grad_norm_bf16(step):
    """The grad norm is one number that sums up the gradient, and its bf16
    error is the projection of the gradient's: its gap between the packages
    is held to twice the JAX package's bf16 error of the weight update the
    step applied (its clipped gradient), plus 1e-6."""
    gap = rel_l2(step["port_bf16"]["m"]["grad_norm"], step["jax_bf16"]["m"]["grad_norm"])
    upd = _updates(step, "params")
    own = rel_l2(upd["jax_bf16"], upd["jax_f32"])
    assert gap <= 2 * own + 1e-6, (gap, own)


@pytest.mark.parametrize("part", ["params", "arch"])
def test_search_step_updates_bf16(step, part):
    """The weights' and the arch tables' updates."""
    upd = _updates(step, part)
    assert_bf16_network(upd["port_bf16"], upd["jax_bf16"], upd["jax_f32"], what=part)
    assert rel_l2(upd["port_bf16"], upd["port_f32"]) > 100 * STEP_RTOL


def test_search_step_running_stats_bf16(step):
    assert_bf16_network(step["port_bf16"]["stats"], step["jax_bf16"]["stats"],
                        step["jax_f32"]["stats"], what="running stats")
