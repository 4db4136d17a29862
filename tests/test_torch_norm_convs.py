"""K2 on the CPU: the port's `norm_convs_plain` (and the wrapper, which takes
it for a CPU tensor) against senas_tpu's `fused_norm_convs` in interpret
mode and its `xla_norm_convs`, on the shapes of tests/test_pallas.py and on
images smaller than the 13-pixel receptive field of the 5x5 dilation-3
branch. Inputs from numpy seeds; the port is NCHW/OIHW, the JAX package
NHWC/HWIO. Tolerance rtol/atol 1e-5, that of tests/test_pallas.py: both
sides sum the same f32 products in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.ops.pallas_kernels import fused_norm_convs, xla_norm_convs
from senas_torch.ops import norm_convs as nc

from torch_port_util import nchw, nhwc
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, h, w, c, n, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, h, w, c).astype(np.float32)
    ks = [(0.1 * rs.randn(k, k, c, n)).astype(np.float32) for k in (3, 5, 5)]
    return x, ks


def _port(x, ks):
    """NHWC / HWIO numpy -> the port's NCHW / OIHW tensors."""
    return nchw(x), [torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
                     for k in ks]


# (b, h, w, c, n): tests/test_pallas.py's shapes, then images smaller than
# the receptive field (h a multiple of the Pallas kernel's 8-row tile)
@pytest.mark.parametrize("b,h,w,c,n", [(2, 16, 16, 8, 8), (1, 24, 16, 4, 12),
                                       (1, 8, 5, 3, 4), (2, 8, 1, 2, 3)])
def test_plain_matches_the_pallas_kernel_and_xla(b, h, w, c, n):
    x, ks = _inputs(b, h, w, c, n)
    want_pallas = np.asarray(fused_norm_convs(*map(jnp.asarray, (x, *ks)), tile_h=8,
                                              interpret=True))
    want_xla = np.asarray(xla_norm_convs(*map(jnp.asarray, (x, *ks))))
    tx, tks = _port(x, ks)
    got = nhwc(nc.norm_convs_plain(tx, *tks))
    assert got.shape == (b, h, w, 3 * n)
    np.testing.assert_allclose(got, want_pallas, **TOL)
    np.testing.assert_allclose(got, want_xla, **TOL)


@pytest.mark.parametrize("b,h,w,c,n", [(2, 5, 7, 3, 4), (1, 13, 11, 5, 9)])
def test_plain_matches_xla_off_the_pallas_tiling(b, h, w, c, n):
    """Heights the Pallas kernel's 8-row tiles cannot take."""
    x, ks = _inputs(b, h, w, c, n, seed=1)
    want = np.asarray(xla_norm_convs(*map(jnp.asarray, (x, *ks))))
    tx, tks = _port(x, ks)
    np.testing.assert_allclose(nhwc(nc.norm_convs_plain(tx, *tks)), want, **TOL)


def test_cpu_wrapper_takes_the_twin():
    x, ks = _inputs(2, 16, 16, 8, 8)
    tx, tks = _port(x, ks)
    before = nc.norm_convs.launches
    got = nc.norm_convs(tx, *tks)
    assert nc.norm_convs.launches == before   # no kernel ran
    assert torch.equal(got, nc.norm_convs_plain(tx, *tks))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.bfloat16])
def test_wrapper_raises_on_other_dtypes(dtype):
    x, ks = _inputs(1, 8, 8, 2, 3)
    tx, tks = _port(x, ks)
    with pytest.raises(NotImplementedError, match="float32"):
        nc.norm_convs(tx.to(dtype), *tks)
    with pytest.raises(NotImplementedError, match="float32"):
        nc.norm_convs(tx, tks[0], tks[1].to(dtype), tks[2])


def test_wrapper_raises_on_bad_operands():
    x, ks = _inputs(1, 8, 8, 2, 3)
    tx, (k3, k52, k53) = _port(x, ks)
    with pytest.raises(ValueError, match="contiguous"):
        nc.norm_convs(tx.transpose(2, 3), k3, k52, k53)
    with pytest.raises(ValueError, match="5x5"):
        nc.norm_convs(tx, k3, k52[:, :1].contiguous(), k53)
    with pytest.raises(ValueError, match=r"\[B,C,H,W\]"):
        nc.norm_convs(tx[0], k3, k52, k53)


def test_work_and_bound_at_the_bench_shape():
    """bench.py's shape (B 64, 128x128, C 32, N 24): 95.0 GFLOP, bound by
    operations at 67 TFLOP/s f32 (1.418 ms) rather than by its 436 MB at
    3.35 TB/s (0.130 ms)."""
    shape, n = (64, 32, 128, 128), 24
    assert nc.flops(shape, n) == 2 * 64 * 128 * 128 * 32 * 24 * 59
    assert round(nc.flops(shape, n) / 67e12 * 1e3, 3) == 1.418
    assert round(nc.nbytes(shape, n) / 3.35e12 * 1e3, 3) == 0.130
