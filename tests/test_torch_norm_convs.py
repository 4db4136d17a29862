"""K2 on the CPU: the port's `norm_convs_plain` (and the wrapper, which takes
it for a CPU tensor) against senas_tpu's `fused_norm_convs` in interpret
mode and its `xla_norm_convs`, on the shapes of tests/test_pallas.py and on
images smaller than the 13-pixel receptive field of the 5x5 dilation-3
branch. Inputs from numpy seeds; the port is NCHW/OIHW, the JAX package
NHWC/HWIO. Tolerance rtol/atol 1e-5, that of tests/test_pallas.py: both
sides sum the same f32 products in another order.

The card's kernel computes in split precision on the tensor cores (3xTF32);
its arithmetic is emulated here, and a NumPy mirror of its tile, fragment,
descriptor and store index arithmetic is held to the plain version."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from senas_tpu.ops.pallas_kernels import fused_norm_convs, xla_norm_convs
from senas_torch.ops import norm_convs as nc

from test_torch_kernels_cuda import _NORM_SHAPES
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
    # f32-accurate on the tensor cores: three TF32 products per f32 product
    # at 495 TFLOP/s TF32
    assert round(3 * nc.flops(shape, n) / 495e12 * 1e3, 3) == 0.576


# ---------------------------------------------------------------------------
# The card kernel's arithmetic: 3xTF32 split precision
# ---------------------------------------------------------------------------

# The card's limit (chip_smoke.py, tests/test_torch_kernels_cuda.py): each
# output within this share of its sum of |products|.
K2_REL_TOL = 1e-5


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, the low 13 bits cleared."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (((bits + 0x1000) & 0xFFFFE000).to(torch.int32)).view(torch.float32)


def tf32_truncate(t: torch.Tensor) -> torch.Tensor:
    """An f32 register as the tensor cores read it for TF32: the low 13
    bits dropped."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_split(t: torch.Tensor):
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def _low_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) & 0x1FFF


def test_tf32_split_rebuilds_f32():
    rs = np.random.RandomState(3)
    edge = [0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 1.4e-45, 1e-38, 1e30, -1e30, 1e38, -1e38,
            1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, 3.0 * 2.0 ** -120]
    vals = np.concatenate([rs.randn(4096) * 10.0 ** rs.randint(-30, 30, 4096), edge])
    x = torch.from_numpy(vals.astype(np.float32))
    hi, lo = tf32_split(x)
    assert not _low_bits(hi).any() and not _low_bits(lo).any()
    err = (hi.double() + lo.double() - x.double()).abs()
    # 2^-22 of |x| from rounding lo; below the normal range lo loses bits of
    # its own, up to 2^-137 (0x1000 units of the smallest subnormal)
    assert (err <= 2.0 ** -21 * x.double().abs() + 2.0 ** -137).all()
    # rounding, not truncation: 1 + 2^-11 lies halfway and goes away from 0
    assert tf32_round(torch.tensor([1.0 + 2.0 ** -11])).item() == 1.0 + 2.0 ** -10
    assert tf32_truncate(torch.tensor([1.0 + 2.0 ** -11])).item() == 1.0
    # the kernel's x split: lo = x - hi exact, read truncated by the tensor
    # cores: within 2^-21 of |x|
    hi = tf32_round(x)
    err = (hi.double() + tf32_truncate(x - hi).double() - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs() + 2.0 ** -136).all()


def _conv3(x, ks):
    return torch.cat([F.conv2d(x, w, padding=(k // 2) * d, dilation=d)
                      for (k, d), w in zip(nc.BRANCHES, ks)], dim=1)


def _emulated(x, ks, passes: int, x_lo: str = "rounded"):
    """The kernel's products emulated in f32: TF32 parts multiply exactly in
    f32 (11 x 11 significant bits), the sums in f32. passes=3 is the
    kernel's lo*W_hi + hi*W_lo + hi*W_hi, passes=1 plain TF32. The kernel
    leaves x's lo = x - hi unrounded, and the tensor cores truncate it
    (x_lo="truncated"); the weights' parts are both rounded."""
    xh, xl = tf32_split(x)
    if x_lo == "truncated":
        xl = tf32_truncate(x - xh)
    parts = [tf32_split(k) for k in ks]
    his, los = [p[0] for p in parts], [p[1] for p in parts]
    if passes == 1:
        return _conv3(xh, his)
    return _conv3(xl, his) + _conv3(xh, los) + _conv3(xh, his)


# (b, c, h, w, n): a partial channel chunk (10 = 8 + 2) and N not a
# multiple of 8; then 3 channels and N 5
_ARITH_SHAPES = [(2, 10, 12, 15, 12), (1, 3, 9, 13, 5)]


def _rel_to_f64(got, x, ks):
    exact = _conv3(x.double(), [k.double() for k in ks])
    abs_sum = _conv3(x.double().abs(), [k.double().abs() for k in ks]).clamp_min(1e-300)
    return ((got.double() - exact).abs() / abs_sum).max().item()


def _arith_inputs(b, c, h, w, n, seed=4):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g)
    return x, [0.1 * torch.randn(n, c, k, k, generator=g) for k, _ in nc.BRANCHES]


@pytest.mark.parametrize("x_lo", ["rounded", "truncated"])
@pytest.mark.parametrize("b,c,h,w,n", _ARITH_SHAPES)
def test_3xtf32_stays_within_the_f32_limit(b, c, h, w, n, x_lo):
    x, ks = _arith_inputs(b, c, h, w, n)
    assert _rel_to_f64(_emulated(x, ks, 3, x_lo), x, ks) <= K2_REL_TOL / 10


@pytest.mark.parametrize("b,c,h,w,n", _ARITH_SHAPES)
def test_1xtf32_exceeds_the_f32_limit(b, c, h, w, n):
    """The limit tells f32-accurate from TF32 arithmetic."""
    x, ks = _arith_inputs(b, c, h, w, n)
    assert _rel_to_f64(_emulated(x, ks, 1), x, ks) > K2_REL_TOL


# ---------------------------------------------------------------------------
# A NumPy mirror of csrc/norm_convs.cu's index arithmetic
# ---------------------------------------------------------------------------

HALO, COL_ORIGIN, TILE_W, WARP_GROUPS, M_TILES = 6, 8, 64, 3, 4
TILE_H = WARP_GROUPS * M_TILES
IN_H, IN_W = TILE_H + 2 * HALO, TILE_W + 2 * COL_ORIGIN
CHUNK, MAX_NT = 8, 4
CHAN_STRIDE = (IN_H * IN_W - 8 + 31) // 32 * 32 + 8
TAPS, TAP_BASE, ALL_TAPS = (9, 25, 25), (0, 9, 34), 59


def _rna(v: np.ndarray) -> np.ndarray:
    bits = v.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _trunc(v: np.ndarray) -> np.ndarray:
    """An f32 register as the tensor cores read it for TF32."""
    return (v.astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _plan(c, n):
    slices = -(-n // (8 * MAX_NT))
    nps = 8 * -(-(-(-n // slices)) // 8)
    return slices, nps, nps // 8, -(-c // CHUNK)


def _split_mirror(ks, c, n):
    """norm_convs_split_kernel: scratch[i] for every i."""
    slices, nps, nt, chunks = _plan(c, n)
    i = np.arange(slices * chunks * ALL_TAPS * 2 * nt * 64)
    kk, r, kh, rest = i & 3, (i >> 2) & 7, (i >> 5) & 1, i >> 6
    grp, rest = rest % nt, rest // nt
    part, rest = rest & 1, rest >> 1
    z, q = rest // (chunks * ALL_TAPS), rest % (chunks * ALL_TAPS)
    br = (q >= TAP_BASE[1] * chunks).astype(int) + (q >= TAP_BASE[2] * chunks)
    q = q - np.array(TAP_BASE)[br] * chunks
    taps = np.array(TAPS)[br]
    cc, tap = q // taps, q % taps
    nn, ch = z * nps + grp * 8 + r, cc * CHUNK + kh * 4 + kk
    w = np.zeros(i.size, np.float32)
    for b in range(3):
        sel = (nn < n) & (ch < c) & (br == b)
        w[sel] = ks[b].reshape(n, c, -1)[nn[sel], ch[sel], tap[sel]]
    hi = _rna(w)
    return np.where(part == 0, hi, _rna(w - hi))


def _kernel_mirror(x: np.ndarray, ks) -> np.ndarray:
    """norm_convs_kernel on every block at once: staging, each thread's
    fragments per tap (hi rounded, lo = x - hi as the tensor cores read it),
    B through the descriptor's LBO/SBO, the 3xTF32 products (summed in f64),
    and the accumulator layout at the store."""
    bsz, c, h, w = x.shape
    n = ks[0].shape[0]
    slices, nps, nt, chunks = _plan(c, n)
    scratch, tap_f = _split_mirror(ks, c, n), 2 * nt * 64
    ty, tx = -(-h // TILE_H), -(-w // TILE_W)
    # the halo'd tiles as cp.async stages them (zeros outside the image and C)
    xpad = np.zeros((bsz, chunks * CHUNK, ty * TILE_H + 2 * HALO,
                     tx * TILE_W + 2 * COL_ORIGIN), np.float32)
    xpad[:, :c, HALO:HALO + h, COL_ORIGIN:COL_ORIGIN + w] = x
    t = np.arange(128 * WARP_GROUPS)
    wg, warp, lane = t >> 7, (t >> 5) & 3, t & 31
    g, tig = lane >> 2, lane & 3
    # fragment register r of thread t: M row a_row, channel a_k, at a_off
    a_row = np.stack([16 * warp + g, 16 * warp + g + 8] * 2, 1)
    a_k = np.stack([tig, tig, tig + 4, tig + 4], 1)
    a_off = np.array([0, 8, 4 * CHAN_STRIDE, 4 * CHAN_STRIDE + 8])
    kb, nb = np.arange(8)[:, None], np.arange(8 * nt)[None, :]
    b_off = (nb // 8) * 64 + (kb // 4) * 32 + (nb % 8) * 4 + kb % 4          # LBO 128 B, SBO 256 B
    jj, hh, qq = (a.ravel() for a in np.meshgrid(np.arange(nt), np.arange(2), np.arange(2),
                                                  indexing="ij"))
    out = np.zeros((bsz, 3 * n, h, w))
    for z in range(slices):
        wz = scratch[z * chunks * ALL_TAPS * tap_f:]
        for br, ((k, d), taps) in enumerate(zip(nc.BRANCHES, TAPS)):
            pad = (k // 2) * d
            acc = np.zeros((bsz, ty, tx, WARP_GROUPS, M_TILES, 64, 8 * nt))
            for cc in range(chunks):
                tiles = np.zeros((bsz, ty, tx, CHUNK * CHAN_STRIDE), np.float32)
                for yy in range(ty):
                    for xx in range(tx):
                        win = xpad[:, cc * CHUNK:(cc + 1) * CHUNK,
                                   yy * TILE_H:yy * TILE_H + IN_H, xx * TILE_W:xx * TILE_W + IN_W]
                        tiles[:, yy, xx].reshape(bsz, CHUNK, CHAN_STRIDE)[:, :, :IN_H * IN_W] = \
                            win.reshape(bsz, CHUNK, -1)
                ws = wz[(TAP_BASE[br] * chunks + cc * taps) * tap_f:][:taps * tap_f]
                base = (tig * CHAN_STRIDE + (M_TILES * wg + HALO - pad) * IN_W
                        + 16 * warp + g + COL_ORIGIN - pad)
                for tap_i in range(taps):
                    dy, dx = divmod(tap_i, k)
                    tap = ws[tap_i * tap_f:]
                    b_hi = tap[b_off].astype(np.float64)
                    b_lo = tap[nt * 64 + b_off].astype(np.float64)
                    for m in range(M_TILES):
                        off = base[:, None] + m * IN_W + dy * d * IN_W + dx * d + a_off[None]
                        v = tiles[..., off]                                 # [b, ty, tx, t, reg]
                        hi = _rna(v)
                        lo = _trunc(v - hi)
                        for part_x, part_b in ((lo, b_hi), (hi, b_lo), (hi, b_hi)):
                            a = np.zeros((bsz, ty, tx, WARP_GROUPS, 64, 8))
                            a[:, :, :, wg[:, None], a_row, a_k] = part_x
                            acc[:, :, :, :, m] += a @ part_b
            # the store: register 4j + 2h + q of thread t holds M row
            # 16*warp + g + 8h (that pixel of the M-tile's row), column
            # 8j + 2*tig + q
            row = (16 * warp + g)[:, None] + 8 * hh[None]
            col = (2 * tig)[:, None] + (8 * jj + qq)[None]
            chan = z * nps + col
            for yy in range(ty):
                for xx in range(tx):
                    for m in range(M_TILES):
                        yo = np.broadcast_to((yy * TILE_H + M_TILES * wg + m)[:, None], row.shape)
                        xo = xx * TILE_W + row
                        keep = (chan < n) & (yo < h) & (xo < w)
                        vals = acc[:, yy, xx, wg[:, None], m, row, col]
                        out[:, br * n + chan[keep], yo[keep], xo[keep]] = vals[:, keep]
    return out


@pytest.mark.parametrize("b,c,h,w,n", _NORM_SHAPES)
def test_kernel_mirror_reproduces_the_plain_version(b, c, h, w, n):
    """At each of the card tests' K2 shapes, within a tenth of the card's
    1e-5 of each output's sum of |products| from an f64 reference."""
    rs = np.random.RandomState(b + c + h + w + n)
    x = rs.randn(b, c, h, w).astype(np.float32)
    ks = [(0.1 * rs.randn(n, c, k, k)).astype(np.float32) for k, _ in nc.BRANCHES]
    got = _kernel_mirror(x, ks)
    tx, tks = torch.from_numpy(x).double(), [torch.from_numpy(k).double() for k in ks]
    want = nc.norm_convs_plain(tx, *tks).numpy()
    abs_sum = nc.norm_convs_plain(tx.abs(), *[k.abs() for k in tks]).numpy()
    rel = (np.abs(got - want) / np.maximum(abs_sum, 1e-30)).max()
    assert rel <= K2_REL_TOL / 10, rel
