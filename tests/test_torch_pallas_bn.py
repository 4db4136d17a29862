"""BatchNorm with SENAS_PALLAS_BN=1: the port's path through the fused
epilogue at n=1 (K1a-K1d's plain twins on the CPU) against senas_tpu's
gated BatchNorm (its Pallas kernels in interpret mode on the CPU), from the
same numpy-made inputs and variables.

Both gated paths take the one-sweep batch variance max(E[x^2] - mu^2, 0),
the default paths the two-pass one, so the comparison is gate on against
gate on. The JAX module reads the variable when it traces: every JAX
function here is built (and jitted) after the monkeypatch.setenv.

Tolerances: the module in f32 within rtol/atol 1e-5 (outputs, running
stats, gradients of x, scale and bias); in bf16 the module-level bound of
tests/torch_port_util.py (`assert_bf16_bits`: equal but on <= 1e-3 of the
elements, by one bf16 ulp); the fixed model's train step at
tests/test_torch_train_step.py's limits (loss and grad norm rtol 1e-5,
weights and running stats atol 1e-5) and the unet step at
tests/test_torch_zoo.py's (atol 2e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.models import geno_searched as jgs
from senas_tpu.models.factory import get_segmentation_model as jget
from senas_tpu.models.senas_model import SenasModel as JModel
from senas_tpu.ops.primitives import BatchNorm as JBatchNorm
from senas_tpu.train.loss import build_loss as jbuild_loss
from senas_tpu.train.optim import build_optimizer as jbuild_optimizer
from senas_tpu.train.trainer import FixedTrainState as JState
from senas_tpu.train.trainer import make_train_step as jmake_train
from senas_torch import convert
from senas_torch.models import geno_searched as tgs
from senas_torch.models.factory import get_segmentation_model as tget
from senas_torch.models.senas_model import SenasModel
from senas_torch.ops import grouped_epilogue as ge
from senas_torch.ops.primitives import BatchNorm
from senas_torch.train.loss import build_loss as tbuild_loss
from senas_torch.train.trainer import FixedTrainState, make_train_step

from torch_port_util import (assert_bf16_bits, assert_trees_close, nchw, nhwc,
                             random_variables, unit_scales)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
# (B, H, W, C): a plane not a multiple of the vector width, the 1x1 planes of
# PSPNet's pooled pyramid and DeepLabV3+'s image pool, the 3x3 of PSP pool 3
SHAPES = [(3, 8, 6, 24), (4, 1, 1, 16), (2, 3, 3, 8)]
OPT = {"name": "sgd", "lr": 0.006, "weight_decay": 0.0005, "momentum": 0.9}


@pytest.fixture
def gate(monkeypatch):
    monkeypatch.setenv("SENAS_PALLAS_BN", "1")


def _case(shape, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 1.5 + 0.3).astype(np.float32)
    v = {"params": {"scale": rng.uniform(0.7, 1.3, c).astype(np.float32),
                    "bias": (0.2 * rng.randn(c)).astype(np.float32)},
         "batch_stats": {"mean": (0.2 * rng.randn(c)).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}
    readout = rng.randn(*shape).astype(np.float32)
    return x, v, readout


def _port_bn(v, dtype=None):
    return convert.load_variables(BatchNorm(v["params"]["scale"].shape[0], dtype=dtype), v)


def _jax_bn(v, x, train, dtype=None):
    out, mut = JBatchNorm(dtype=dtype).apply(v, x, not train, mutable=["batch_stats"])
    return out, mut["batch_stats"]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_and_running_stats_match(gate, shape, train):
    x, v, _ = _case(shape)
    want, want_stats = _jax_bn(v, jnp.asarray(x), train)
    bn = _port_bn(v)
    launches = ge.apply_mix.launches, ge.branch_stats.launches
    with torch.no_grad():
        got = bn(nchw(x), train=train)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    assert_trees_close(convert.state_dict_to_variables(bn)["batch_stats"],
                       jax.device_get(want_stats), **TOL)
    # the CPU runs the plain twins: no kernel was counted
    assert (ge.apply_mix.launches, ge.branch_stats.launches) == launches


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gradients_match(gate, shape):
    x, v, readout = _case(shape, seed=1)

    def loss(params, x):
        out, _ = JBatchNorm().apply({"params": params, "batch_stats": v["batch_stats"]},
                                    x, False, mutable=["batch_stats"])
        return jnp.sum(out * readout)

    jg_params, jg_x = jax.grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(a) for k, a in v["params"].items()}, jnp.asarray(x))
    bn = _port_bn(v)
    tx = nchw(x).requires_grad_()
    (bn(tx, train=True) * nchw(readout)).sum().backward()
    np.testing.assert_allclose(nhwc(tx.grad), np.asarray(jg_x), **TOL)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(getattr(bn, k).grad.numpy(), np.asarray(jg_params[k]),
                                   **TOL, err_msg=k)


def test_gate_changes_only_the_variance_form(monkeypatch):
    """Gate on against gate off in the port: the one-sweep and the two-pass
    variance agree to f32 rounding, and the gated path ran the epilogue."""
    x, v, _ = _case(SHAPES[0], seed=2)
    outs = {}
    for on in ("0", "1"):
        monkeypatch.setenv("SENAS_PALLAS_BN", on)
        with torch.no_grad():
            outs[on] = _port_bn(v)(nchw(x), train=True).numpy()
    np.testing.assert_allclose(outs["1"], outs["0"], **TOL)
    assert not np.array_equal(outs["1"], outs["0"])


@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("train", [True, False])
def test_bf16_output_matches(gate, train, x_dtype):
    """A bf16 module on a bf16 input, and on an f32 one (the path computes
    in f32 and rounds once): bf16 out, at the bf16 module bound."""
    x, v, _ = _case(SHAPES[0], seed=3)
    jx = jnp.asarray(x).astype(jnp.bfloat16) if x_dtype == "bf16" else jnp.asarray(x)
    want, want_stats = _jax_bn(v, jx, train, dtype=jnp.bfloat16)
    tx = nchw(np.asarray(jx.astype(jnp.float32)))
    if x_dtype == "bf16":
        tx = tx.to(torch.bfloat16)
    bn = _port_bn(v, dtype=torch.bfloat16)
    with torch.no_grad():
        got = bn(tx, train=train)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert_bf16_bits(nhwc(got.float()), np.asarray(want.astype(jnp.float32)),
                     what=f"train={train} x {x_dtype}")
    assert_trees_close(convert.state_dict_to_variables(bn)["batch_stats"],
                       jax.device_get(want_stats), **TOL)


def test_bf16_input_to_an_f32_module(gate):
    """dtype f32 over a bf16 input: f32 out, the input widened exactly, one
    counted copy."""
    x, v, _ = _case(SHAPES[0], seed=4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want, _ = _jax_bn(v, jnp.asarray(xb.float().numpy()), True)
    before = BatchNorm.pallas_copies
    with torch.no_grad():
        got = _port_bn(v, dtype=torch.float32)(xb.permute(0, 3, 1, 2), train=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    assert BatchNorm.pallas_copies == before + 1


def test_non_4d_input_keeps_batch_norm(gate):
    rng = np.random.RandomState(5)
    x = rng.randn(6, 16).astype(np.float32)
    v = _case((1, 1, 1, 16))[1]
    want, want_stats = _jax_bn(v, jnp.asarray(x), True)
    bn = _port_bn(v)
    calls = ge.branch_stats.launches
    with torch.no_grad():
        got = bn(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_trees_close(convert.state_dict_to_variables(bn)["batch_stats"],
                       jax.device_get(want_stats), **TOL)
    assert ge.branch_stats.launches == calls


def test_path_goes_through_the_epilogue(gate, monkeypatch):
    """With the gate on a 4-D BatchNorm calls fused_group_epilogue once
    (n=1, ones for the alpha column); a channels_last input is copied to
    NCHW once."""
    from senas_torch.ops import primitives
    seen = []
    real = primitives.fused_group_epilogue

    def spy(xs, *args, **kw):
        seen.append((len(xs), xs[0].is_contiguous(), kw["train"]))
        return real(xs, *args, **kw)

    monkeypatch.setattr(primitives, "fused_group_epilogue", spy)
    x, v, _ = _case(SHAPES[0], seed=6)
    before = BatchNorm.pallas_copies
    bn = _port_bn(v)
    with torch.no_grad():
        bn(nchw(x), train=True)
        bn(nchw(x).to(memory_format=torch.channels_last), train=False)
    assert seen == [(1, True, True), (1, True, False)]
    assert BatchNorm.pallas_copies == before + 1


def _step_pair(jm, tm, variables, batch):
    """One fixed train step of each package from `variables`: (JAX state,
    JAX metrics, port state, port metrics)."""
    tx = jbuild_optimizer(dict(OPT))
    jstep = jmake_train(jm.apply, jbuild_loss("dice_ce"), tx, grad_clip=5.0, donate=False)
    jstate, jmetrics = jstep(JState.create(variables, tx),
                             {k: jnp.asarray(a) for k, a in batch.items()})
    tm = convert.load_variables(tm, variables)
    state = FixedTrainState.create(tm, OPT)
    m = make_train_step(tbuild_loss("dice_ce"), grad_clip=5.0)(
        state, {k: torch.from_numpy(a) for k, a in batch.items()})
    return jax.device_get(jstate), jmetrics, state, m


def _batch(rng, b, hw):
    return {"image": rng.randn(b, hw, hw, 1).astype(np.float32),
            "label": (rng.rand(b, hw, hw) > 0.6).astype(np.int32)}


def test_fixed_model_step_matches(gate):
    """SenasModel(senas_node_4) at c 4, depth 3, 16x16, batch 2: one train
    step with the gate on in both packages."""
    rng = np.random.RandomState(7)
    batch = _batch(rng, 2, 16)
    jm = JModel(nclass=2, in_channels=1, c=4, depth=3, genotype=jgs.senas_node_4)
    variables = random_variables(jm, rng, jnp.asarray(batch["image"]), False)
    tm = SenasModel(nclass=2, in_channels=1, c=4, depth=3, genotype=tgs.senas_node_4,
                    device="cpu")
    jstate, jm_, state, m = _step_pair(jm, tm, variables, batch)
    for k in ("loss", "grad_norm", "acc"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm_[k]), rtol=1e-5, err_msg=k)
    got = convert.state_dict_to_variables(state.model)
    assert_trees_close(got["params"], jstate.params, rtol=0, atol=1e-5)
    assert_trees_close(got["batch_stats"], jstate.batch_stats, rtol=0, atol=1e-5)


def test_unet_step_matches(gate):
    """The zoo's unet (resnet34 encoder) at depth 3, 32x32, batch 2, from
    unit BN scales (tests/test_torch_zoo.py's step): one train step with
    the gate on in both packages."""
    rng = np.random.RandomState(8)
    batch = _batch(rng, 2, 32)
    jm = jget("unet", dataset="promise12", depth=3)
    variables = unit_scales(random_variables(jm, rng, jnp.asarray(batch["image"]), False))
    tm = tget("unet", dataset="promise12", depth=3, device="cpu")
    jstate, jm_, state, m = _step_pair(jm, tm, variables, batch)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm_["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].numpy(), np.asarray(jm_["grad_norm"]),
                               rtol=1e-5)
    got = convert.state_dict_to_variables(state.model)
    assert_trees_close(got["params"], jstate.params, rtol=0, atol=2e-5)
    assert_trees_close(got["batch_stats"], jstate.batch_stats, rtol=0, atol=2e-5)
