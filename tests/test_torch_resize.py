"""`senas_torch.ops.resize.jax_resize` against `jax.image.resize` on the
same numpy-made NHWC maps: every method name the JAX function accepts,
enlarging and shrinking, integer and non-integer factors, one axis or
both, within rtol 1e-5 and an atol of 1e-6 of the result's largest
magnitude (`_close`); the gradients of the linear, cubic, Lanczos and
nearest resizes too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_torch.ops.resize import jax_resize

from torch_port_util import nchw, nhwc
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want, what=""):
    """Within rtol 1e-5 and atol 1e-6 of the result's largest magnitude (at
    least 1e-6): XLA:CPU fuses the kernel weights' arithmetic (FMA), so
    they differ from the port's in their last bits, and an output of a
    map of unit scale moves by ~1e-6 of that scale."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * max(1.0, float(np.abs(want).max())),
                               err_msg=what)
METHODS = ("nearest", "linear", "cubic", "lanczos3", "lanczos5")
ALIASES = {"bilinear": "linear", "trilinear": "linear", "triangle": "linear",
           "bicubic": "cubic", "tricubic": "cubic"}
# from 11 x 13: 2x up (primitives.upsample2x), non-integer up, shrink by
# integer and non-integer factors, one axis only, mixed, to 1 x 1
SIZES = ((22, 26), (17, 20), (5, 6), (4, 9), (11, 7), (29, 13), (3, 31), (1, 1))


def _map(seed=0):
    return np.random.RandomState(seed).randn(2, 11, 13, 3).astype(np.float32)


@pytest.mark.parametrize("method", METHODS)
def test_resize_matches_jax(method):
    x = _map()
    for size in SIZES:
        want = jax.image.resize(jnp.asarray(x), (2, size[0], size[1], 3), method)
        got = jax_resize(nchw(x), size, method)
        assert got.dtype == torch.float32
        _close(nhwc(got), want, f"{method} {size}")


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_method_aliases_match_jax(alias):
    x = _map(3)
    for size in ((17, 20), (4, 9)):
        want = jax.image.resize(jnp.asarray(x), (2, size[0], size[1], 3), alias)
        got = jax_resize(nchw(x), size, alias)
        np.testing.assert_array_equal(nhwc(got), nhwc(jax_resize(nchw(x), size,
                                                                   ALIASES[alias])))
        _close(nhwc(got), want, f"{alias} {size}")


@pytest.mark.parametrize("method", ["linear", "cubic", "lanczos3", "nearest"])
@pytest.mark.parametrize("size", [(17, 20), (4, 9)])
def test_resize_gradient_matches_jax(method, size):
    x = _map(1)
    r = np.random.RandomState(2).randn(2, size[0], size[1], 3).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(jax.image.resize(x, (2, *size, 3), method) * r))(
        jnp.asarray(x))
    tx = nchw(x).requires_grad_()
    (jax_resize(tx, size, method) * nchw(r)).sum().backward()
    _close(nhwc(tx.grad), want)


def test_same_size_is_the_identity_and_unknown_raises():
    x = nchw(_map())
    assert jax_resize(x, (11, 13), "cubic") is x
    with pytest.raises(ValueError, match="Unknown resize method"):
        jax.image.resize(jnp.zeros((1, 2, 2, 1)), (1, 4, 4, 1), "area")
    with pytest.raises(ValueError, match="Unknown resize method"):
        jax_resize(x, (4, 4), "area")


def test_bf16_linear_rounds_once():
    """A bf16 map's linear filter is the f32 filter of its values, rounded
    once to bf16."""
    x = nchw(_map()).to(torch.bfloat16)
    got = jax_resize(x, (5, 6), "linear")
    assert got.dtype == torch.bfloat16
    want = jax_resize(x.float(), (5, 6), "linear").to(torch.bfloat16)
    assert torch.equal(got, want)
