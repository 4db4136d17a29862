"""The image operations of the PROMISE12 data path, in numpy and scipy.

The JAX package calls cv2 for these (`senas_tpu/data/promise12.py`,
`senas_tpu/data/augment.py`); the port does not depend on cv2, so each
function here computes what its cv2 call computes, down to cv2's own
rounding, and `tests/test_torch_imgproc.py` holds each to cv2:

- `resize_nearest`: `cv2.resize(..., interpolation=INTER_NEAREST)`;
- `resize_bilinear`: `cv2.resize(..., interpolation=INTER_LINEAR)` of a
  float32 image, as x86 builds of cv2 compute it (through Intel IPP);
- `clahe_u16`: `cv2.createCLAHE(clip, grid).apply` on a uint16 image;
- `gaussian_blur`: `cv2.GaussianBlur` on a float64 image;
- `convert_maps_16sc2`: `cv2.convertMaps(map_x, map_y, CV_16SC2)`;
- `remap_bilinear`, `remap_nearest`: `cv2.remap` of those fixed-point maps,
  INTER_LINEAR and INTER_NEAREST, BORDER_CONSTANT with 0 (the bilinear one
  of a multi-channel image too);
- `rotation_matrix`, `warp_affine_nearest`: `cv2.getRotationMatrix2D` and
  `cv2.warpAffine(..., flags=INTER_NEAREST, borderValue=0)` (any dtype and
  channels), exact;
- `rgb_to_hsv`, `hsv_to_rgb`: `cv2.cvtColor` of float32 images,
  COLOR_RGB2HSV (h in degrees) and COLOR_HSV2RGB. cv2 runs them in SIMD
  blocks with a scalar tail at the end of each of its parallel stripes,
  where the tail's h (not fused, then +360) may lie 1 ulp from the
  blocks'; these twins compute every pixel as the blocks do, so h may lie
  1 ulp from cv2's where cv2 took the tail (`tests/test_torch_m9c.py`
  holds the bound).
The warp and the colour conversions run in the native library
(`data/native/image_native.cpp`), for libm's correctly rounded fmaf.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage

# cv2's fixed-point remap maps carry 5 fraction bits (INTER_BITS)
INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS


def resize_nearest(img: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Nearest-neighbour resize of the first two axes to rows x cols.
    cv2 takes source index min(floor(d * (1 / (dst / src))), src - 1) in
    double for destination index d."""
    def index(dst: int, src: int) -> np.ndarray:
        inv = 1.0 / (dst / src)
        return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64), src - 1)

    return img[index(rows, img.shape[0])[:, None], index(cols, img.shape[1])[None, :]]


def fma32(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """x * y + z of float32 arrays rounded once to float32, as a fused
    multiply-add instruction computes it. The product is exact in float64;
    the float64 sum is rounded once more only where it lands exactly half
    way between two float32s with a nonzero remainder, and is then moved
    toward the remainder (so the result is exact for normal float32s)."""
    p = np.asarray(x, np.float64) * np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    s = p + z
    bv = s - p
    err = (p - (s - bv)) + (z - bv)          # s + err == p + z exactly (TwoSum)
    tie = (s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(0x10000000)
    s = np.where(tie & (err != 0), np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _linear_taps(dst: int, src: int):
    """Source index and float32 weight of each destination index, as IPP's
    linear resize takes them: x = (d + 0.5) * (src / dst) - 0.5 in double,
    the weight x - floor(x) rounded to float32 once; both taps clamped to
    the image (border replicate)."""
    x = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    lo = np.floor(x)
    weight = (x - lo).astype(np.float32)
    lo = lo.astype(np.int64)
    return np.clip(lo, 0, src - 1), np.clip(lo + 1, 0, src - 1), weight


# Where x86 cv2's IPP path takes the height pass of a side's border columns
# without the fused multiply-add: from this many border columns a side, on
# these channels of a [H, W, C] image (found against cv2 5.0.0.93; gray and
# 1-channel images keep the fused form everywhere).
_UNFUSED_BORDER_MIN = 5
_UNFUSED_BORDER_CHANNELS = {3: (0, 1), 4: (0, 1, 2, 3)}


def resize_bilinear(img: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """cv2.resize(img, (cols, rows), interpolation=INTER_LINEAR) of a
    float32 [H, W] or [H, W, C] image.

    cv2 copies an image of the same size. Otherwise x86 builds of cv2 hand
    float32 images to Intel IPP (before cv2's own code and its INTER_AREA
    path for 2x downscales), whose arithmetic is this: along the width
    first, then the height, each output is a + w * (b - a) with one fused
    multiply-add (`fma32`), b - a rounded to float32 first, the taps and
    weights of `_linear_taps`. That equals cv2 bit for bit at every ratio
    the loaders give (`tests/test_torch_imgproc.py`). One exception is
    IPP's own: on a side with 5 or more border columns (both width taps
    clamped to one pixel: an upscale of 9x or more in width), the height
    pass computes those columns as a + float32(w * (b - a)), two roundings,
    for channels 0-1 of a 3-channel image and every channel of a 4-channel
    one (`_UNFUSED_BORDER_CHANNELS`)."""
    img = np.asarray(img)
    if img.dtype != np.float32 or img.ndim not in (2, 3):
        raise ValueError(f"resize_bilinear takes a float32 [H, W] or [H, W, C] image, "
                         f"got {img.dtype} {img.shape}")
    if img.shape[:2] == (rows, cols):
        return img.copy()
    x0, x1, wx = _linear_taps(cols, img.shape[1])
    y0, y1, wy = _linear_taps(rows, img.shape[0])
    extra = (None,) * (img.ndim - 2)
    a, b = img[:, x0], img[:, x1]
    along = fma32(b - a, np.broadcast_to(wx[(None, slice(None)) + extra], a.shape), a)
    a, b = along[y0], along[y1]
    w = np.broadcast_to(wy[(slice(None), None) + extra], a.shape)
    out = fma32(b - a, w, a)
    chans = _UNFUSED_BORDER_CHANNELS.get(img.shape[2]) if img.ndim == 3 else None
    if chans:
        # both width taps clamped to one pixel: the border columns, a side
        left = np.flatnonzero((x0 == x1) & (np.arange(cols) < cols // 2))
        right = np.flatnonzero((x0 == x1) & (np.arange(cols) >= cols // 2))
        sides = [side for side in (left, right) if side.size >= _UNFUSED_BORDER_MIN]
        if sides:
            at = (slice(None), np.concatenate(sides)[:, None], np.asarray(chans)[None, :])
            out[at] = a[at] + (b[at] - a[at]) * w[at]
    return out


def clahe_u16(u16: np.ndarray, clip_limit: float, grid: Tuple[int, int]) -> np.ndarray:
    """cv2's CLAHE on a 2-D uint16 image; `grid` is cv2's tileGridSize,
    (tiles along the width, tiles along the height).

    cv2 pads the image by reflection (101) to a multiple of the grid (both
    sides padded as soon as one is not a multiple), histograms each tile
    over 65,536 bins, clips every bin at max(int(clip * tile_px / 65536), 1),
    spreads the excess evenly with the remainder one per bin at a fixed step
    from bin 0, and maps a value through round(cdf * (65535 / tile_px))
    (float32). Each pixel then blends the LUTs of its four nearest tile
    centres bilinearly in float32.

    The 65,536-entry LUTs are never built: a tile's clipped histogram is
    sparse (at most tile_px values), so the cdf at a value is the running
    sum of the clipped counts up to it (a search in the tile's sorted
    values) plus the spread excess, and only the values each LUT serves are
    looked up.
    """
    if u16.dtype != np.uint16 or u16.ndim != 2:
        raise ValueError(f"clahe_u16 takes a 2-D uint16 image, got {u16.dtype} {u16.shape}")
    bins = 65536
    tiles_x, tiles_y = int(grid[0]), int(grid[1])
    h, w = u16.shape
    if h % tiles_y or w % tiles_x:
        ext = np.pad(u16, ((0, tiles_y - h % tiles_y), (0, tiles_x - w % tiles_x)),
                     mode="reflect")
    else:
        ext = u16
    th, tw = ext.shape[0] // tiles_y, ext.shape[1] // tiles_x
    tile_px = th * tw
    lut_scale = np.float32(bins - 1) / np.float32(tile_px)
    limit = max(int(clip_limit * tile_px / bins), 1) if clip_limit > 0 else None

    # per tile: its sorted distinct values and their clipped counts
    tiles = ext[:tiles_y * th, :tiles_x * tw].reshape(tiles_y, th, tiles_x, tw)
    tiles = tiles.transpose(0, 2, 1, 3).reshape(tiles_y * tiles_x, tile_px)
    keys = (np.arange(tiles_y * tiles_x, dtype=np.int64)[:, None] * bins
            + tiles.astype(np.int64)).ravel()
    keys, count = np.unique(keys, return_counts=True)
    if limit is not None:
        clipped_px = count - np.minimum(count, limit)
        count = np.minimum(count, limit)
        clipped = np.bincount(keys // bins, weights=clipped_px,
                              minlength=tiles_y * tiles_x).astype(np.int64)
    else:
        clipped = np.zeros(tiles_y * tiles_x, np.int64)
    batch = clipped // bins
    residual = clipped - batch * bins
    step = np.maximum(bins // np.maximum(residual, 1), 1)
    running = np.concatenate([[0], np.cumsum(count)])
    # running sum at the start of each tile's run of keys
    tile_start = running[np.searchsorted(keys, np.arange(tiles_y * tiles_x) * bins)]

    def lut(tile: np.ndarray, value: np.ndarray) -> np.ndarray:
        """The LUT of tile `tile` at `value` (arrays of one shape)."""
        pos = np.searchsorted(keys, tile * bins + value, side="right")
        cdf = running[pos] - tile_start[tile] + batch[tile] * (value + 1)
        cdf += np.where(residual[tile] > 0,
                        np.minimum(residual[tile], value // step[tile] + 1), 0)
        out = np.rint(cdf.astype(np.float32) * lut_scale)
        return np.clip(out, 0, bins - 1).astype(np.float32)

    def axis_weights(n: int, size: int, count: int):
        # cv2 multiplies by the float32 inverse of the tile side; dividing
        # instead moves some pixels by one
        f = np.arange(n, dtype=np.float32) * (np.float32(1) / np.float32(size)) - np.float32(0.5)
        lo = np.floor(f).astype(np.int64)
        a = (f - lo.astype(np.float32)).astype(np.float32)
        return (np.maximum(lo, 0), np.minimum(lo + 1, count - 1), a,
                (np.float32(1) - a).astype(np.float32))

    ty1, ty2, ya, ya1 = axis_weights(h, th, tiles_y)
    tx1, tx2, xa, xa1 = axis_weights(w, tw, tiles_x)
    v = u16.astype(np.int64)
    t11 = ty1[:, None] * tiles_x + tx1[None, :]
    t12 = ty1[:, None] * tiles_x + tx2[None, :]
    t21 = ty2[:, None] * tiles_x + tx1[None, :]
    t22 = ty2[:, None] * tiles_x + tx2[None, :]
    xa, xa1 = xa[None, :], xa1[None, :]
    top = lut(t11, v) * xa1 + lut(t12, v) * xa
    bottom = lut(t21, v) * xa1 + lut(t22, v) * xa
    res = top * ya1[:, None] + bottom * ya[:, None]
    return np.clip(np.rint(res), 0, bins - 1).astype(np.uint16)


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma, CV_64F) for sigma > 0."""
    scale = -0.5 / (sigma * sigma)
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(scale * x * x)
    total = 0.0
    for t in k:  # cv2 sums in order
        total += t
    return k * (1.0 / total)


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma) of a 2-D float64 image:
    the separable kernel along each axis, reflect-101 border."""
    k = gaussian_kernel(ksize, sigma)
    out = ndimage.correlate1d(np.asarray(img, np.float64), k, axis=1, mode="mirror")
    return ndimage.correlate1d(out, k, axis=0, mode="mirror")


def convert_maps_16sc2(map_x: np.ndarray, map_y: np.ndarray):
    """cv2.convertMaps(map_x, map_y, CV_16SC2) of float32 maps: each
    coordinate rounded to 1/32. Returns (xy int16 [H, W, 2], the integer
    parts; frac uint16 [H, W], y_frac * 32 + x_frac)."""
    ix = np.rint(np.asarray(map_x, np.float32) * np.float32(INTER_TAB_SIZE)).astype(np.int64)
    iy = np.rint(np.asarray(map_y, np.float32) * np.float32(INTER_TAB_SIZE)).astype(np.int64)
    xy = np.stack([np.clip(ix >> INTER_BITS, -32768, 32767),
                   np.clip(iy >> INTER_BITS, -32768, 32767)], axis=-1).astype(np.int16)
    frac = ((iy & (INTER_TAB_SIZE - 1)) * INTER_TAB_SIZE
            + (ix & (INTER_TAB_SIZE - 1))).astype(np.uint16)
    return xy, frac


def _gather(img: np.ndarray, y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """img[y, x] (with img's channels, if any), 0 where (y, x) lies outside
    the image."""
    h, w = img.shape[:2]
    inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    out = img[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)]
    inside = inside.reshape(inside.shape + (1,) * (img.ndim - 2))
    return np.where(inside, out, np.zeros((), img.dtype))


def remap_bilinear(img: np.ndarray, maps) -> np.ndarray:
    """cv2.remap(img, xy, frac, INTER_LINEAR, BORDER_CONSTANT) of a float32
    [H, W] or [H, W, C] image: the four neighbours of each integer part
    weighted by the float32 products of (1 - f/32, f/32), summed in cv2's
    order, the same weights for every channel."""
    xy, frac = maps
    img = np.asarray(img, np.float32)
    x, y = xy[..., 0].astype(np.int64), xy[..., 1].astype(np.int64)
    fx = (frac & (INTER_TAB_SIZE - 1)).astype(np.float32) / np.float32(INTER_TAB_SIZE)
    fy = (frac >> INTER_BITS).astype(np.float32) / np.float32(INTER_TAB_SIZE)
    one = np.float32(1)
    w00, w01 = (one - fy) * (one - fx), (one - fy) * fx
    w10, w11 = fy * (one - fx), fy * fx
    if img.ndim == 3:
        w00, w01, w10, w11 = (wt[..., None] for wt in (w00, w01, w10, w11))
    out = _gather(img, y, x) * w00 + _gather(img, y, x + 1) * w01
    out = out + _gather(img, y + 1, x) * w10
    return (out + _gather(img, y + 1, x + 1) * w11).astype(np.float32)


def remap_nearest(mask: np.ndarray, maps) -> np.ndarray:
    """cv2.remap(mask, xy, frac, INTER_NEAREST, BORDER_CONSTANT) of a 2-D
    image. With the fraction table given, cv2 takes the source pixel
    (y + (y_frac < 16), x + (x_frac < 16)): that is its rule, kept as is."""
    xy, frac = maps
    half = INTER_TAB_SIZE // 2
    x = xy[..., 0].astype(np.int64) + ((frac & (INTER_TAB_SIZE - 1)) < half)
    y = xy[..., 1].astype(np.int64) + ((frac >> INTER_BITS) < half)
    return _gather(np.asarray(mask), y, x)


# ---------------------------------------------------------------------------
# Rotation and colour space (RandomRotate, AdjustHue)
# ---------------------------------------------------------------------------

def rotation_matrix(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, angle, scale): float64 [2, 3]; the
    center as cv2's Point2f."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * (np.pi / 180)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """The inverse map warpAffine computes from `m` (float64 [2, 3])."""
    m = np.asarray(m, np.float64).reshape(6).tolist()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.array(m, np.float64).reshape(2, 3)


def warp_affine_nearest(img: np.ndarray, m: np.ndarray) -> np.ndarray:
    """cv2.warpAffine(img, m, (w, h), flags=INTER_NEAREST, borderValue=0)
    of `img` [H, W] or [H, W, C], any dtype."""
    from senas_torch.data import native
    return native.warp_affine_nearest(img, invert_affine(m).astype(np.float32))


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_RGB2HSV) of float32 [..., 3] (h in [0, 360])."""
    from senas_torch.data import native
    return native.colour_convert(img, True)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_HSV2RGB) of float32 [..., 3]."""
    from senas_torch.data import native
    return native.colour_convert(img, False)
