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
mirrored in NumPy: its layout pass, weight packing, TMA boxes in a ring of
stage buffers, the A and B descriptors of every tap and M-tile read as
wgmma reads them, and the store, held by the same bound to the twin's
function summed in f64."""

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
# A NumPy mirror of norm_convs_bf16_kernel
# ---------------------------------------------------------------------------

TILE_W, M_TILES, CONSUMERS, STAGES = 64, 4, 2, 3
TILE_H = CONSUMERS * M_TILES
CHUNK, MAX_NT = 16, 4
PADS, TAPS, TAP_BASE, ALL_TAPS = (1, 4, 6), (9, 25, 25), (0, 9, 34), 59
BOX_BYTES = tuple((TILE_H + 2 * p) * (TILE_W + 2 * p) * 16 for p in PADS)
LBO_A = BOX_BYTES[2]                      # kBoxBytes: the second K half's box
X_BYTES = 2 * LBO_A
STAGE_BYTES = X_BYTES + 25 * MAX_NT * 128 * 2
SMEM_BYTES = STAGES * STAGE_BYTES + 3 * STAGES * 8
OUT_PITCH = TILE_W + 8                    # staged sums: 144 bytes an output channel


def test_kernel_shared_memory_plan():
    """The ring fits a block's 232,448 bytes; every TMA destination is
    128-byte aligned; a descriptor's 14-bit start address (16-byte units)
    reaches every byte of it; 12 rows (3 consumers) would not fit; the
    staged sums of NT 4 fit a stage buffer."""
    assert (LBO_A, STAGE_BYTES, SMEM_BYTES) == (24320, 74240, 222792)
    assert TILE_H * 8 * MAX_NT * OUT_PITCH * 2 <= STAGE_BYTES
    assert SMEM_BYTES <= 232448 < STAGES * (2 * 24 * 76 * 16 + 25600)
    assert LBO_A % 128 == X_BYTES % 128 == STAGE_BYTES % 128 == 0
    assert SMEM_BYTES < (1 << 14) * 16


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


def _layout_mirror(x):
    """norm_convs_bf16_layout_kernel: xl element i (8 bf16, 16 bytes) is
    pixel i % (H*W) of channel group (i / (H*W)) % C8 of image
    i / (H*W*C8); channels past C zero. Returns xl flat, 8 values a row."""
    bsz, c, h, w = x.shape
    c8, plane = -(-c // 8), h * w
    xl = np.zeros((bsz * c8 * plane, 8), np.float32)
    flat = x.reshape(bsz, c, plane)
    i = np.arange(bsz * c8 * plane)
    p, bc = i % plane, i // plane
    c0, b = (bc % c8) * 8, bc // c8
    for k in range(8):
        ok = c0 + k < c
        xl[ok, k] = flat[b[ok], c0[ok] + k, p[ok]]
    return xl


def _tma_box(xmap, x2, y0, c8, b, rows, cols2):
    """cp.async.bulk.tensor.4d of a box {cols2, rows, 1, 1} at coordinates
    (x2, y0, c8, b) of the map (2W, H, C8, B) of 8-byte elements (4 bf16):
    zeros for every coordinate outside it, negative ones too. Returns the
    box flat, as it lands in shared memory."""
    bsz, ngroups, h, w2, _ = xmap.shape
    box = np.zeros((rows, cols2, 4), np.float32)
    if 0 <= c8 < ngroups and 0 <= b < bsz:
        ys, xs = np.arange(y0, y0 + rows), np.arange(x2, x2 + cols2)
        iy, ix = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w2)
        box[np.ix_(iy, ix)] = xmap[b, c8][np.ix_(ys[iy], xs[ix])]
    return box.ravel()


def _desc(addr, lbo, sbo):
    """kmajor_desc / b_desc: start address, LBO and SBO in 16-byte units."""
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32)


def _operand(smem, descs, rows):
    """What wgmma reads through no-swizzle K-major descriptors: per
    descriptor a [rows x 16] bf16 matrix, element (r, k) at byte start +
    (r // 8) * SBO + (k // 8) * LBO + (r % 8) * 16 + (k % 8) * 2."""
    descs = np.asarray(descs, np.int64)[..., None, None]
    start = (descs & 0x3FFF) << 4
    lbo, sbo = ((descs >> 16) & 0x3FFF) << 4, ((descs >> 32) & 0x3FFF) << 4
    r, k = np.arange(rows)[:, None], np.arange(16)[None, :]
    return smem[(start + (r // 8) * sbo + (k // 8) * lbo + (r % 8) * 16 + (k % 8) * 2) // 2]


def _kernel_mirror(x: np.ndarray, ks, sms: int = 3) -> torch.Tensor:
    """norm_convs_bf16_kernel, block by block of a persistent grid of `sms`
    blocks: the layout pass; each stage's TMA boxes and packed weights
    written into a ring of 3 stage buffers in a byte-addressed shared
    memory (NaN where nothing was written); A and B read through the
    consumers' descriptors at each tap and M-tile, the products summed in
    f64 (scale-d 0 at a branch's first tap); the sums rounded once and
    staged in the last stage's buffer by stmatrix's addresses, and the
    storers' copy of 8-pixel rows to global memory."""
    bsz, c, h, w = x.shape
    n = ks[0].shape[0]
    slices, nps, nt, chunks = _plan(c, n)
    scratch, tap_e = _pack_mirror(ks, c, n), nt * 128
    c8 = -(-c // 8)
    xl = _layout_mirror(x).reshape(-1)
    # the map: dimensions (2W, H, C8, B) of 8 bytes, strides 16W, 16WH,
    # 16WHC8 bytes (an element here is 4 bytes of the float32 copy)
    xmap = np.lib.stride_tricks.as_strided(
        xl, (bsz, c8, h, 2 * w, 4), [e * 4 for e in (8 * w * h * c8, 8 * w * h, 8 * w, 4, 1)])
    tiles_x, tiles_y = -(-w // TILE_W), -(-h // TILE_H)
    items = slices * bsz * tiles_x * tiles_y
    e = np.arange(TILE_H * nps * 8)                          # the storers' 16-byte rows
    k8, ech, er = e & 7, (e >> 3) % nps, (e >> 3) // nps
    out = torch.full((bsz, 3 * n, h, w), float("nan"), dtype=BF)
    for block in range(min(items, sms)):
        smem = np.full(STAGES * STAGE_BYTES // 2, np.nan)
        g = 0
        for item in range(block, items, sms):
            tx, ty = item % tiles_x, (item // tiles_x) % tiles_y
            rest = item // (tiles_x * tiles_y)
            b, z = rest % bsz, rest // bsz
            wz = scratch[z * chunks * ALL_TAPS * tap_e:]
            acc = np.zeros((CONSUMERS, M_TILES, 64, 8 * nt))
            for s in range(3 * chunks):
                slot, br, cc = g % STAGES, s // chunks, s % chunks
                g += 1
                (k, d), pad, taps = nc.BRANCHES[br], PADS[br], TAPS[br]
                buf = slot * STAGE_BYTES
                # the producer: two boxes, then the chunk's taps
                rows, cols = TILE_H + 2 * pad, TILE_W + 2 * pad
                for half in range(2):
                    e0 = (buf + half * LBO_A) // 2
                    smem[e0:e0 + rows * cols * 8] = _tma_box(
                        xmap, 2 * (tx * TILE_W - pad), ty * TILE_H - pad, 2 * cc + half, b, rows,
                        2 * cols)
                wsrc = wz[(TAP_BASE[br] * chunks + cc * taps) * tap_e:][:taps * tap_e]
                e0 = (buf + X_BYTES) // 2
                smem[e0:e0 + wsrc.size] = wsrc
                # the consumers: per tap the 8 M-tiles' descriptors
                pitch = TILE_W + 2 * pad
                cw, m = np.divmod(np.arange(CONSUMERS * M_TILES), M_TILES)
                a0 = _desc(buf + M_TILES * cw * pitch * 16, LBO_A, 128)
                b0 = _desc(buf + X_BYTES, 128, 256)
                for dy in range(k):
                    for dx in range(k):
                        a_op = _operand(smem, a0 + dy * d * pitch + dx * d + m * pitch, 64)
                        b_op = _operand(smem, [b0 + (dy * k + dx) * nt * 16], 8 * nt)[0]
                        prod = (a_op @ b_op.T).reshape(acc.shape)
                        acc = prod if cc == 0 and dy == 0 and dx == 0 else acc + prod
                if cc < chunks - 1:
                    continue
                # the consumers stage the rounded sums in this buffer by
                # stmatrix .x2 .trans: matrix (j, h) of M-tile m holds pixels
                # 16*warp + 8h + p, channels 8j + i; its stored row i (the
                # address of lane 8h + i) takes them at pixels p = 0..7
                rounded = torch.from_numpy(acc).to(BF).double().numpy()
                i, p = np.arange(8)[:, None], np.arange(8)[None, :]
                for cw_, m_, w_, j, h_ in np.ndindex(CONSUMERS, M_TILES, 4, nt, 2):
                    r = M_TILES * cw_ + m_
                    addr = buf + ((r * nps + 8 * j + i) * OUT_PITCH + 16 * w_ + 8 * h_) * 2
                    smem[addr // 2 + p] = rounded[cw_, m_][16 * w_ + 8 * h_ + p, 8 * j + i]
                # ... and the storers copy them, 8 pixels of a channel a row
                nn, yo, xo = z * nps + ech, ty * TILE_H + er, tx * TILE_W + 8 * k8
                for i in np.flatnonzero((nn < n) & (yo < h) & (xo < w)):
                    v = smem[buf // 2 + (er[i] * nps + ech[i]) * OUT_PITCH + 8 * k8[i]:][:8]
                    span = min(8, w - xo[i])
                    out[b, br * n + nn[i], yo[i], xo[i]:xo[i] + span] = torch.from_numpy(v[:span])
    return out


# (b, c, h, w, n): one partial tile in both directions with a partial
# channel chunk (20 = 16 + 4) and N not a multiple of 8; N over 32 (two
# slices); a small image (every box mostly halo); C 5 (one channel group,
# 3 channels zero, the second K half all past C); an image narrower than
# an 8-pixel granule with N 36 (two slices); the card's NT 4 shape (C 20,
# N 32, W 70)
@pytest.mark.parametrize("b,c,h,w,n", [(1, 20, 14, 70, 12), (1, 8, 13, 9, 40), (2, 3, 5, 7, 5),
                                       (2, 5, 11, 16, 8), (1, 6, 9, 5, 36),
                                       (2, 20, 30, 70, 32)])
def test_kernel_mirror_reproduces_the_bf16_twin(b, c, h, w, n):
    rs = np.random.RandomState(b + c + h + w + n)
    x = torch.from_numpy(rs.randn(b, c, h, w).astype(np.float32)).to(BF)
    ks = [(0.1 * torch.from_numpy(rs.randn(n, c, k, k).astype(np.float32))).to(BF)
          for k, _ in nc.BRANCHES]
    got = _kernel_mirror(x.float().numpy(), [k.float().numpy() for k in ks])
    # the mirror sums in f64, so it is held to the twin's function in f64
    # (the convolutions of the bf16 values, rounded once); the f32 twin is
    # many ulps off where a sum cancels, as the card's bound allows
    want = nc.norm_convs_plain(x.double(), *[k.double() for k in ks]).to(BF)
    assert bool(torch.isfinite(got).all())       # no read of a byte no copy wrote
    assert_bf16_bits(as_f64(got), as_f64(want), what="the kernel's mirror")
