"""senas_torch.ops.primitives against senas_tpu.ops.primitives on the CPU.

Inputs come from a seeded numpy generator; block weights cross through
senas_torch.convert. Tolerance: rtol 1e-4 / atol 1e-5 for outputs that go
through a convolution (f32 sums taken in another order by XLA:CPU and
PyTorch's CPU convolution), 1e-6 for pooling and resizing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.ops import primitives as JP
from senas_torch import convert
from senas_torch.ops import primitives as TP

from torch_port_util import assert_trees_close, nchw, nhwc, random_variables
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

CONV_TOL = dict(rtol=1e-4, atol=1e-5)
EXACT_TOL = dict(rtol=1e-6, atol=1e-6)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("k,d,stride,groups", [(3, 1, 1, 1), (5, 2, 2, 1),
                                               (5, 3, 1, 1), (7, 1, 1, 1),
                                               (3, 1, 2, 4), (5, 1, 1, 4)])
def test_conv2d(k, d, stride, groups):
    x = _x(0, 2, 12, 12, 4)
    w = _x(1, k, k, 4 // groups, 4 * (2 if groups == 1 else 3))
    want = JP.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride, dilation=d,
                     groups=groups)
    got = TP.conv2d(nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                    stride=stride, dilation=d, groups=groups)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **CONV_TOL)


@pytest.mark.parametrize("k,d,op,pad", [(3, 1, 1, None), (5, 2, 1, None),
                                        (5, 3, 1, None), (1, 1, 1, 0),
                                        (3, 2, 0, None)])
def test_conv_transpose2d(k, d, op, pad):
    """Dilation and output_padding; PyTorch's weight is the spatially
    flipped flax kernel with in/out swapped."""
    x = _x(2, 2, 6, 6, 4)
    w = _x(3, k, k, 4, 5)
    want = JP.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), stride=2,
                               dilation=d, output_padding=op, torch_padding=pad)
    wt = np.flip(w, axis=(0, 1)).transpose(2, 3, 0, 1).copy()
    got = TP.conv_transpose2d(nchw(x), torch.from_numpy(wt), stride=2,
                              dilation=d, output_padding=op, torch_padding=pad)
    assert got.shape[2:] == want.shape[1:3]
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **CONV_TOL)


@pytest.mark.parametrize("k,mult", [(3, 1), (3, 3), (5, 3)])
def test_depthwise_conv_transpose2d_with_multiplier(k, mult):
    """groups=C transposed conv, output channel c*E+e (fused_cell.py:202-204):
    flax (k,k,1,C*E) -> PyTorch (C,E,k,k), flipped."""
    c = 4
    x = _x(4, 2, 5, 5, c)
    w = _x(5, k, k, 1, c * mult)
    want = JP.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), stride=2,
                               output_padding=1, groups=c)
    wt = np.flip(w.reshape(k, k, c, mult), axis=(0, 1)).transpose(2, 3, 0, 1).copy()
    got = TP.conv_transpose2d(nchw(x), torch.from_numpy(wt), stride=2,
                              output_padding=1, groups=c)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **CONV_TOL)


@pytest.mark.parametrize("hw,stride", [(9, 1), (9, 2), (8, 2), (5, 1)])
def test_avg_pool_3x3_borders(hw, stride):
    x = _x(6, 2, hw, hw, 3)
    want = JP.avg_pool_3x3(jnp.asarray(x), stride=stride)
    got = TP.avg_pool_3x3(nchw(x), stride=stride)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **EXACT_TOL)


@pytest.mark.parametrize("hw,stride", [(8, 2), (9, 2), (7, 1)])
def test_max_pool_3x3(hw, stride):
    x = _x(7, 2, hw, hw, 3)
    want = JP.max_pool_3x3(jnp.asarray(x), stride=stride)
    got = TP.max_pool_3x3(nchw(x), stride=stride)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


@pytest.mark.parametrize("h,w", [(6, 6), (5, 7), (1, 2)])
def test_upsample2x(h, w):
    x = _x(8, 2, h, w, 3)
    want = JP.upsample2x(jnp.asarray(x))
    got = TP.upsample2x(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **EXACT_TOL)


def test_batchnorm_train_running_stats_and_eval():
    """Two train-mode steps (biased normalisation, unbiased momentum-0.1
    running variance), then eval mode on the running stats."""
    rng = np.random.RandomState(9)
    x1 = (rng.randn(3, 5, 4, 6) * 2 + 1).astype(np.float32)
    x2 = (rng.randn(3, 5, 4, 6) - 0.5).astype(np.float32)
    jbn = JP.BatchNorm()
    variables = random_variables(jbn, rng, jnp.asarray(x1), True)
    tbn = convert.load_variables(TP.BatchNorm(6), variables)
    for x in (x1, x2):
        want, mut = jbn.apply(variables, jnp.asarray(x), False,
                              mutable=["batch_stats"])
        variables = {"params": variables["params"], **mut}
        got = tbn(nchw(x), train=True)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), **CONV_TOL)
        assert_trees_close(convert.state_dict_to_variables(tbn)["batch_stats"],
                           variables["batch_stats"], rtol=1e-5, atol=1e-6)
    want = jbn.apply(variables, jnp.asarray(x1), True)
    np.testing.assert_allclose(nhwc(tbn(nchw(x1), train=False)), np.asarray(want),
                               **CONV_TOL)


def _check_block(jmod, tmod, x, seed, with_train_arg=True):
    """Same random variables in both; compare eval, then train outputs and
    the advanced running stats."""
    rng = np.random.RandomState(seed)
    args = (jnp.asarray(x), False) if with_train_arg else (jnp.asarray(x),)
    variables = random_variables(jmod, rng, *args)
    convert.load_variables(tmod, variables)
    modes = (False, True) if with_train_arg else (False,)
    for train in modes:
        if with_train_arg:
            want, mut = jmod.apply(variables, jnp.asarray(x), train,
                                   mutable=["batch_stats"])
            got = tmod(nchw(x), train=train)
        else:
            want, mut = jmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
            got = tmod(nchw(x))
        np.testing.assert_allclose(nhwc(got), np.asarray(want), **CONV_TOL,
                                   err_msg=f"train={train}")
        if mut.get("batch_stats"):
            assert_trees_close(convert.state_dict_to_variables(tmod)["batch_stats"],
                               mut["batch_stats"], rtol=1e-5, atol=1e-6)


_ALL_OPS = [(t, name) for t in ("DOWN", "UP", "NORM")
            for name in getattr(JP.OpType, t).value["ops"]]


@pytest.mark.parametrize("op_type,name", _ALL_OPS)
def test_make_op_blocks(op_type, name):
    """Every candidate op of every op type: AdapterBlock, ConvBn, ConvBnSe
    (SEBlock), DepSepConv, in their stride/transpose variants."""
    c_in, c_out = 4, 6
    x = _x(10, 2, 8, 8, c_in)
    jmod = JP.make_op(name, c_in, c_out, getattr(JP.OpType, op_type))
    tmod = TP.make_op(name, c_in, c_out, getattr(TP.OpType, op_type))
    _check_block(jmod, tmod, x, seed=11)


@pytest.mark.parametrize("block", ["relu_conv", "se", "identity_same_width",
                                   "resample_up", "resample_up_same",
                                   "resample_down", "resample_down_same",
                                   "shrink", "rectify", "basic", "basic_down"])
def test_blocks(block):
    c_in = 4
    x = _x(12, 2, 8, 8, c_in)
    pairs = {
        "relu_conv": (JP.ReLUConv(3, kernel_size=3), TP.ReLUConv(c_in, 3, 3)),
        "identity_same_width": (JP.AdapterBlock(c_in, "identity"),
                                TP.AdapterBlock(c_in, c_in, "identity")),
        "resample_up": (JP.RectifyResample(6, "up"), TP.RectifyResample(c_in, 6, "up")),
        "resample_up_same": (JP.RectifyResample(c_in, "up"),
                             TP.RectifyResample(c_in, c_in, "up")),
        "resample_down": (JP.RectifyResample(6, "down"),
                          TP.RectifyResample(c_in, 6, "down")),
        "resample_down_same": (JP.RectifyResample(c_in, "down"),
                               TP.RectifyResample(c_in, c_in, "down")),
        "shrink": (JP.ShrinkBlock(3), TP.ShrinkBlock(c_in, 3)),
        "rectify": (JP.RectifyBlock(5), TP.RectifyBlock(c_in, 5)),
        "basic": (JP.BasicBlock(c_in), TP.BasicBlock(c_in, c_in)),
        "basic_down": (JP.BasicBlock(6, stride=2, use_downsample=True),
                       TP.BasicBlock(c_in, 6, stride=2, use_downsample=True)),
    }
    if block == "se":
        x = _x(12, 2, 8, 8, 20)  # c > 16 -> mid = c // 16
        _check_block(JP.SEBlock(), TP.SEBlock(20), x, seed=13, with_train_arg=False)
        return
    jmod, tmod = pairs[block]
    _check_block(jmod, tmod, x, seed=13)


def test_relu_conv_transpose_block():
    x = _x(14, 2, 5, 5, 4)
    _check_block(JP.ReLUConv(3, kernel_size=3, stride=2, transpose=True,
                             output_padding=1),
                 TP.ReLUConv(4, 3, 3, stride=2, transpose=True, output_padding=1),
                 x, seed=15)
