"""senas_torch.ops.primitives with dtype=torch.bfloat16 against the flax
modules of senas_tpu.ops.primitives with dtype=jnp.bfloat16, on the CPU:
the same f32 weights (through senas_torch.convert) and inputs, each module
casting its input on entry and its weights at use, BatchNorm normalising
in f32 and rounding once.

Tolerances. A module's bf16 output equals the JAX package's except on at
most 1e-3 of its elements, and there by at most one bf16 ulp: both round
once from an f32 result whose sums run in another order (a convolution)
or whose f32 arithmetic differs by an ulp (BatchNorm's affine). The f32
running stats rtol 1e-5 / atol 1e-6, as in f32. The SE block's sigmoid
is jax.nn.sigmoid's 1 / (1 + exp(-x)) with each op rounded in bf16, as
in the JAX package. Two ops differ by design:
XLA:CPU sums the 3x3 average pool in bf16, rounding after each add, and
resizes bilinearly in two bf16-rounded passes, where PyTorch (on the CPU
and on the card) sums each in f32 and rounds once. The port's
`avg_pool_3x3` and `upsample2x` in bf16 equal the JAX functions computed
in f32 and rounded once, bit for bit; the modules built on them (the
avg_pool, up_sample and same-width resampling blocks) are held to the
network bound: their relative L2 distance from the JAX bf16 output is at
most twice the JAX bf16 output's own distance from its f32 output, plus
1e-6. Worst seen on an x86 CPU: 6.5e-4 of a module's elements differ, by
one ulp; the pool-based modules lie at up to 0.57 of their bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.ops import primitives as JP
from senas_torch import convert
from senas_torch.ops import primitives as TP

from torch_port_util import (assert_bf16_bits, assert_bf16_network, assert_trees_close,
                             flat_leaves, nchw, nhwc, random_variables)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

BF16 = dict(jax=jnp.bfloat16, port=torch.bfloat16)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
# the blocks whose output goes through the average pool or the bilinear
# resize, which XLA:CPU computes with bf16 roundings of its own
_POOLED = {("DOWN", "avg_pool"), ("NORM", "avg_pool"), ("UP", "up_sample"),
           ("NORM", "up_sample"), ("DOWN", "up_sample")}


def _x(seed, *shape):
    """An NHWC f32 array of bf16 values."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _check(jmake, tmake, x, seed, with_train_arg=True, pooled=False, x_dtype=None,
           running_average=False):
    """The bf16 modules from one set of f32 variables, eval then train; the
    JAX f32 module (jmake(None)) gives bf16's own error for `pooled`. The
    flax BatchNorm takes `use_running_average` (not train) in train's place."""
    rng = np.random.RandomState(seed)
    jx = jnp.asarray(x) if x_dtype is None else jnp.asarray(x).astype(jnp.bfloat16)
    tx = nchw(x) if x_dtype is None else nchw(x).to(torch.bfloat16)
    args = (jx, False) if with_train_arg else (jx,)
    jmod = jmake(BF16["jax"])
    variables = random_variables(jmod, rng, *args)
    tmod = convert.load_variables(tmake(BF16["port"]), variables)
    assert all(p.dtype == torch.float32 for p in tmod.parameters())
    for train in ((False, True) if with_train_arg else (False,)):
        flag = (not train) if running_average else train
        call = (lambda m, v: m.apply(v, jx, flag, mutable=["batch_stats"])) \
            if with_train_arg else (lambda m, v: m.apply(v, jx, mutable=["batch_stats"]))
        want, mut = call(jmod, variables)
        got = tmod(tx, train=train) if with_train_arg else tmod(tx)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        got, want = nhwc(got.float()), np.asarray(want.astype(jnp.float32))
        if pooled:
            want_f32, mut_f32 = call(jmake(None), variables)
            assert_bf16_network(got, want, np.asarray(want_f32), what=f"train={train}")
        else:
            assert_bf16_bits(got, want, what=f"train={train}")
        if mut.get("batch_stats"):
            stats = convert.state_dict_to_variables(tmod)["batch_stats"]
            assert all(b.dtype == torch.float32 for b in tmod.buffers())
            if pooled:
                assert_bf16_network(flat_leaves(stats), flat_leaves(mut["batch_stats"]),
                                    flat_leaves(mut_f32["batch_stats"]), what="running stats")
            else:
                assert_trees_close(stats, mut["batch_stats"], **STATS_TOL)


def test_batchnorm_bf16_train_and_eval():
    """bf16 in, stats and running-stat update in f32, bf16 out; and an f32
    input rounded once to the module's bf16."""
    x = (_x(1, 3, 6, 5, 8) * 2 + 1).astype(np.float32)
    _check(lambda dt: JP.BatchNorm(dtype=dt), lambda dt: TP.BatchNorm(8, dtype=dt), x, 2,
           x_dtype="bf16", running_average=True)
    _check(lambda dt: JP.BatchNorm(dtype=dt), lambda dt: TP.BatchNorm(8, dtype=dt), x, 3,
           running_average=True)


def test_batchnorm_without_dtype_keeps_the_input_dtype():
    bn = TP.BatchNorm(4)
    x = torch.randn(2, 4, 3, 3)
    assert bn(x.to(torch.bfloat16), train=True).dtype == torch.bfloat16
    assert bn(x, train=True).dtype == torch.float32
    assert bn.mean.dtype == bn.var.dtype == torch.float32


@pytest.mark.parametrize("block", ["conv_bn", "conv_bn_t", "se", "dep_sep", "dep_sep_t",
                                   "resample_up", "resample_down", "resample_up_same",
                                   "resample_down_same", "basic", "basic_down", "relu_conv",
                                   "shrink", "rectify"])
def test_blocks_bf16(block):
    c_in = 8
    x = _x(12, 2, 8, 8, c_in)
    pairs = {
        "conv_bn": (lambda dt: JP.ConvBn(6, 3, dtype=dt),
                    lambda dt: TP.ConvBn(c_in, 6, 3, dtype=dt)),
        "conv_bn_t": (lambda dt: JP.ConvBn(6, 3, 2, transpose=True, output_padding=1, dtype=dt),
                      lambda dt: TP.ConvBn(c_in, 6, 3, 2, transpose=True, output_padding=1,
                                           dtype=dt)),
        "dep_sep": (lambda dt: JP.DepSepConv(6, 5, 2, dtype=dt),
                    lambda dt: TP.DepSepConv(c_in, 6, 5, 2, dtype=dt)),
        "dep_sep_t": (lambda dt: JP.DepSepConv(6, 3, 2, transpose=True, output_padding=1,
                                               dtype=dt),
                      lambda dt: TP.DepSepConv(c_in, 6, 3, 2, transpose=True, output_padding=1,
                                               dtype=dt)),
        "resample_up": (lambda dt: JP.RectifyResample(6, "up", dtype=dt),
                        lambda dt: TP.RectifyResample(c_in, 6, "up", dtype=dt)),
        "resample_down": (lambda dt: JP.RectifyResample(6, "down", dtype=dt),
                          lambda dt: TP.RectifyResample(c_in, 6, "down", dtype=dt)),
        "resample_up_same": (lambda dt: JP.RectifyResample(c_in, "up", dtype=dt),
                             lambda dt: TP.RectifyResample(c_in, c_in, "up", dtype=dt)),
        "resample_down_same": (lambda dt: JP.RectifyResample(c_in, "down", dtype=dt),
                               lambda dt: TP.RectifyResample(c_in, c_in, "down", dtype=dt)),
        "basic": (lambda dt: JP.BasicBlock(c_in, dtype=dt),
                  lambda dt: TP.BasicBlock(c_in, c_in, dtype=dt)),
        "basic_down": (lambda dt: JP.BasicBlock(6, stride=2, use_downsample=True, dtype=dt),
                       lambda dt: TP.BasicBlock(c_in, 6, stride=2, use_downsample=True,
                                                dtype=dt)),
        "relu_conv": (lambda dt: JP.ReLUConv(3, kernel_size=3, dtype=dt),
                      lambda dt: TP.ReLUConv(c_in, 3, 3, dtype=dt)),
        "shrink": (lambda dt: JP.ShrinkBlock(3, dtype=dt),
                   lambda dt: TP.ShrinkBlock(c_in, 3, dtype=dt)),
        "rectify": (lambda dt: JP.RectifyBlock(5, dtype=dt),
                    lambda dt: TP.RectifyBlock(c_in, 5, dtype=dt)),
    }
    if block == "se":
        x = _x(13, 2, 8, 8, 20)   # c > 16 -> mid = c // 16
        _check(lambda dt: JP.SEBlock(dtype=dt), lambda dt: TP.SEBlock(20, dtype=dt), x, 14,
               with_train_arg=False, x_dtype="bf16")
        return
    jmake, tmake = pairs[block]
    _check(jmake, tmake, x, 15, pooled=block.endswith("_same"))


_ALL_OPS = [(t, name) for t in ("DOWN", "UP", "NORM")
            for name in getattr(JP.OpType, t).value["ops"]]


@pytest.mark.parametrize("op_type,name", _ALL_OPS)
def test_make_op_bf16(op_type, name):
    c_in, c_out = 4, 6
    x = _x(10, 2, 8, 8, c_in)
    jt, tt = getattr(JP.OpType, op_type), getattr(TP.OpType, op_type)
    _check(lambda dt: JP.make_op(name, c_in, c_out, jt, dtype=dt),
           lambda dt: TP.make_op(name, c_in, c_out, tt, dtype=dt), x, 11,
           pooled=(op_type, name) in _POOLED)


@pytest.mark.parametrize("stride", [1, 2])
def test_pool_and_resize_round_once(stride):
    """The port's bf16 average pool and bilinear 2x resize are the JAX
    functions computed in f32 and rounded once to bf16."""
    x = _x(20, 2, 9, 10, 5)
    tx = nchw(x).to(torch.bfloat16)
    for tf, jf in ((lambda t: TP.avg_pool_3x3(t, stride), lambda a: JP.avg_pool_3x3(a, stride)),
                   (TP.upsample2x, JP.upsample2x)):
        got = tf(tx)
        assert got.dtype == torch.bfloat16
        want = jf(jnp.asarray(x)).astype(jnp.bfloat16).astype(jnp.float32)
        np.testing.assert_array_equal(nhwc(got.float()), np.asarray(want))


def test_dense_promotes_as_flax_does():
    """Dense without a dtype computes in the promoted dtype of its input and
    its f32 kernel (flax's promote_dtype); with one, in that dtype."""
    d = TP.Dense(4, 3, bias=True)
    x = torch.randn(2, 4).to(torch.bfloat16)
    assert d(x).dtype == torch.float32
    d16 = TP.Dense(4, 3, bias=True, dtype=torch.bfloat16)
    assert d16(x).dtype == torch.bfloat16 and d16.kernel.dtype == torch.float32
