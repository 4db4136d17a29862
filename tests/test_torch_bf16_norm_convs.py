"""K2 in bf16 on the CPU: the port's `norm_convs_plain` on bf16 operands
(the twin the card's bf16 kernel is held to; the wrapper takes it for a CPU
tensor) against senas_tpu's `fused_norm_convs` on bf16 operands in
interpret mode, and its `xla_norm_convs` in bf16, at a small size and at
edge sizes (a width smaller than the receptive field, a partial channel
chunk). The Pallas kernel accumulates every tap in f32 and writes x's dtype;
the twin is the f32 convolution of the bf16 values (every product exact),
rounded once. Bound: equal but on at most 1e-3 of the elements, each by one
bf16 ulp (f32 sums in other orders); the probe that planned this found 0.

The card's bf16 kernel (csrc/norm_convs.cu, norm_convs_bf16_kernel) is
mirrored in NumPy: its weight packing, the halo'd tile, each thread's
k16 fragments, the B descriptor's core matrices and the store, held to
the twin by the same bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senas_tpu.ops.pallas_kernels import fused_norm_convs, xla_norm_convs
from senas_torch.ops import norm_convs as nc

from torch_port_util import as_f64, assert_bf16_bits, assert_bf16_computed
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

BF = torch.bfloat16


def _inputs(b, h, w, c, n, seed=0):
    """NHWC x and HWIO kernels of bf16 values (as f32 arrays)."""
    rs = np.random.RandomState(seed)
    bf = lambda a: np.asarray(jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16)
                              .astype(jnp.float32))
    x = bf(rs.randn(b, h, w, c))
    ks = [bf(0.1 * rs.randn(k, k, c, n)) for k in (3, 5, 5)]
    return x, ks


def _port(x, ks):
    """NHWC / HWIO -> the port's bf16 NCHW / OIHW tensors."""
    tx = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(BF)
    return tx, [torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).to(BF)
                for k in ks]


def _nhwc(t):
    return as_f64(t.permute(0, 2, 3, 1))


@pytest.mark.parametrize("b,h,w,c,n", [(2, 16, 16, 8, 4), (2, 16, 16, 8, 8), (1, 24, 16, 20, 12),
                                       (1, 8, 5, 3, 4), (2, 8, 1, 2, 3)])
def test_bf16_plain_matches_the_pallas_kernel_and_xla(b, h, w, c, n):
    x, ks = _inputs(b, h, w, c, n)
    jops = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, *ks)]
    want_pallas = fused_norm_convs(*jops, tile_h=8, interpret=True)
    want_xla = xla_norm_convs(*jops)
    assert want_pallas.dtype == jnp.bfloat16
    tx, tks = _port(x, ks)
    got = nc.norm_convs_plain(tx, *tks)
    assert got.dtype == BF and tuple(got.shape) == (b, 3 * n, h, w)
    assert_bf16_bits(_nhwc(got), as_f64(want_pallas), what="against the Pallas kernel")
    assert_bf16_bits(_nhwc(got), as_f64(want_xla), what="against xla_norm_convs")
    # the twin rounds the f32 result once: it is bf16, not f32, arithmetic
    f32 = nc.norm_convs_plain(tx.float(), *[k.float() for k in tks])
    assert torch.equal(got, f32.to(BF))
    assert_bf16_computed(got, f32, rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_takes_the_bf16_twin():
    x, ks = _inputs(2, 16, 16, 8, 8)
    tx, tks = _port(x, ks)
    before = dict(nc.norm_convs.launches_by_dtype)
    got = nc.norm_convs(tx, *tks)
    assert nc.norm_convs.launches_by_dtype == before   # no kernel ran
    assert got.dtype == BF and torch.equal(got, nc.norm_convs_plain(tx, *tks))


def test_mixed_dtypes_raise():
    """No hidden cast: every operand in one dtype, f32 or bf16."""
    x, ks = _inputs(1, 8, 8, 2, 3)
    tx, tks = _port(x, ks)
    with pytest.raises(NotImplementedError, match="one dtype"):
        nc.norm_convs(tx, tks[0].float(), tks[1], tks[2])
    with pytest.raises(NotImplementedError, match="one dtype"):
        nc.norm_convs(tx.float(), *tks)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        nc.norm_convs(tx.half(), *[k.half() for k in tks])


def test_bf16_work_and_bound_at_the_bench_shape():
    """bench.py's shape (B 64, 128x128, C 32, N 24): 95.03 GFLOP at 989
    TFLOP/s bf16 is 0.0961 ms; its 218 MB at 3.35 TB/s 0.0651 ms: bound by
    operations."""
    shape, n = (64, 32, 128, 128), 24
    assert round(nc.flops(shape, n) / 1e9, 2) == 95.03
    assert round(nc.flops(shape, n) / 989e12 * 1e3, 4) == 0.0961
    assert round(nc.nbytes(shape, n, itemsize=2) / 1e6) == 218
    assert round(nc.nbytes(shape, n, itemsize=2) / 3.35e12 * 1e3, 4) == 0.0651


# ---------------------------------------------------------------------------
# A NumPy mirror of norm_convs_bf16_kernel's index arithmetic
# ---------------------------------------------------------------------------

HALO, COL_ORIGIN, TILE_W, WARP_GROUPS, M_TILES = 6, 8, 64, 3, 4
TILE_H = WARP_GROUPS * M_TILES
IN_H, IN_W = TILE_H + 2 * HALO, TILE_W + 2 * COL_ORIGIN
CHUNK, MAX_NT = 16, 4
STRIDE = (IN_H * IN_W - 8 + 63) // 64 * 64 + 8
TAPS, TAP_BASE, ALL_TAPS = (9, 25, 25), (0, 9, 34), 59


def _plan(c, n):
    slices = -(-n // (8 * MAX_NT))
    nps = 8 * -(-(-(-n // slices)) // 8)
    return slices, nps, nps // 8, -(-c // CHUNK)


def _pack_mirror(ks, c, n):
    """norm_convs_bf16_pack_kernel: scratch[i] for every i."""
    slices, nps, nt, chunks = _plan(c, n)
    i = np.arange(slices * chunks * ALL_TAPS * nt * 128)
    kk, r, kh, rest = i & 7, (i >> 3) & 7, (i >> 6) & 1, i >> 7
    grp, rest = rest % nt, rest // nt
    z, q = rest // (chunks * ALL_TAPS), rest % (chunks * ALL_TAPS)
    br = (q >= TAP_BASE[1] * chunks).astype(int) + (q >= TAP_BASE[2] * chunks)
    q = q - np.array(TAP_BASE)[br] * chunks
    taps = np.array(TAPS)[br]
    cc, tap = q // taps, q % taps
    nn, ch = z * nps + grp * 8 + r, cc * CHUNK + kh * 8 + kk
    w = np.zeros(i.size, np.float32)
    for b in range(3):
        sel = (nn < n) & (ch < c) & (br == b)
        w[sel] = ks[b].reshape(n, c, -1)[nn[sel], ch[sel], tap[sel]]
    return w


def _kernel_mirror(x: np.ndarray, ks) -> torch.Tensor:
    """norm_convs_bf16_kernel on every block at once: the staged tiles, each
    thread's 8 fragment values per M-tile and tap (4 registers of 2), B
    through the descriptor's LBO/SBO, the products summed in f64, and the
    accumulator layout at the store, rounded once to bf16."""
    bsz, c, h, w = x.shape
    n = ks[0].shape[0]
    slices, nps, nt, chunks = _plan(c, n)
    scratch, tap_e = _pack_mirror(ks, c, n), nt * 128
    ty, tx = -(-h // TILE_H), -(-w // TILE_W)
    xpad = np.zeros((bsz, chunks * CHUNK, ty * TILE_H + 2 * HALO,
                     tx * TILE_W + 2 * COL_ORIGIN), np.float32)
    xpad[:, :c, HALO:HALO + h, COL_ORIGIN:COL_ORIGIN + w] = x
    t = np.arange(128 * WARP_GROUPS)
    wg, warp, lane = t >> 7, (t >> 5) & 3, t & 31
    g, tig = lane >> 2, lane & 3
    # the 8 values of a thread's 4 registers: M row, K index, offset from p
    row = np.stack([16 * warp + g + d for d in (0, 0, 8, 8, 0, 0, 8, 8)], 1)
    kidx = np.stack([2 * tig + d for d in (0, 1, 0, 1, 8, 9, 8, 9)], 1)
    off = np.array([0, STRIDE, 8, STRIDE + 8, 8 * STRIDE, 9 * STRIDE, 8 * STRIDE + 8,
                    9 * STRIDE + 8])
    kb, nb = np.arange(16)[:, None], np.arange(8 * nt)[None, :]
    b_off = (nb // 8) * 128 + (kb // 8) * 64 + (nb % 8) * 8 + kb % 8      # LBO 128 B, SBO 256 B
    jj, hh, qq = (a.ravel() for a in np.meshgrid(np.arange(nt), np.arange(2), np.arange(2),
                                                  indexing="ij"))
    out = torch.zeros((bsz, 3 * n, h, w), dtype=BF)
    for z in range(slices):
        wz = scratch[z * chunks * ALL_TAPS * tap_e:]
        for br, ((k, d), taps) in enumerate(zip(nc.BRANCHES, TAPS)):
            pad = (k // 2) * d
            acc = np.zeros((bsz, ty, tx, WARP_GROUPS, M_TILES, 64, 8 * nt))
            for cc in range(chunks):
                tiles = np.zeros((bsz, ty, tx, CHUNK * STRIDE), np.float32)
                for yy in range(ty):
                    for xx in range(tx):
                        win = xpad[:, cc * CHUNK:(cc + 1) * CHUNK,
                                   yy * TILE_H:yy * TILE_H + IN_H, xx * TILE_W:xx * TILE_W + IN_W]
                        tiles[:, yy, xx].reshape(bsz, CHUNK, STRIDE)[:, :, :IN_H * IN_W] = \
                            win.reshape(bsz, CHUNK, -1)
                ws = wz[(TAP_BASE[br] * chunks + cc * taps) * tap_e:][:taps * tap_e]
                base = (2 * tig * STRIDE + (M_TILES * wg + HALO - pad) * IN_W
                        + 16 * warp + g + COL_ORIGIN - pad)
                for tap_i in range(taps):
                    dy, dx = divmod(tap_i, k)
                    bmat = ws[tap_i * tap_e:][b_off].astype(np.float64)
                    for m in range(M_TILES):
                        v = tiles[..., base[:, None] + m * IN_W + dy * d * IN_W + dx * d
                                  + off[None]]                              # [b, ty, tx, t, 8]
                        a = np.zeros((bsz, ty, tx, WARP_GROUPS, 64, 16))
                        a[:, :, :, wg[:, None], row, kidx] = v
                        acc[:, :, :, :, m] += a @ bmat
            # register 4j + 2h + q of thread t: M row 16*warp + g + 8h,
            # column 8j + 2*tig + q
            srow = (16 * warp + g)[:, None] + 8 * hh[None]
            col = (2 * tig)[:, None] + (8 * jj + qq)[None]
            chan = z * nps + col
            for yy in range(ty):
                for xx in range(tx):
                    for m in range(M_TILES):
                        yo = np.broadcast_to((yy * TILE_H + M_TILES * wg + m)[:, None], srow.shape)
                        xo = xx * TILE_W + srow
                        keep = (chan < n) & (yo < h) & (xo < w)
                        vals = torch.from_numpy(acc[:, yy, xx, wg[:, None], m, srow, col][:, keep])
                        out[:, br * n + chan[keep], yo[keep], xo[keep]] = vals.to(BF)
    return out


# (b, c, h, w, n): one partial tile in both directions with a partial
# channel chunk (20 = 16 + 4) and N not a multiple of 8; N over 32 (two
# slices); a width not a multiple of 8 (the plain-load staging)
@pytest.mark.parametrize("b,c,h,w,n", [(1, 20, 14, 70, 12), (1, 8, 13, 9, 40), (2, 3, 5, 7, 5)])
def test_kernel_mirror_reproduces_the_bf16_twin(b, c, h, w, n):
    rs = np.random.RandomState(b + c + h + w + n)
    x = torch.from_numpy(rs.randn(b, c, h, w).astype(np.float32)).to(BF)
    ks = [(0.1 * torch.from_numpy(rs.randn(n, c, k, k).astype(np.float32))).to(BF)
          for k, _ in nc.BRANCHES]
    got = _kernel_mirror(x.float().numpy(), [k.float().numpy() for k in ks])
    want = nc.norm_convs_plain(x, *ks)
    assert_bf16_bits(as_f64(got), as_f64(want), what="the kernel's mirror")
