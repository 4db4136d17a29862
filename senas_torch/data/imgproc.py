"""The image operations of the PROMISE12 data path, in numpy and scipy.

The JAX package calls cv2 for these (`senas_tpu/data/promise12.py`,
`senas_tpu/data/augment.py`); the port does not depend on cv2, so each
function here computes what its cv2 call computes, down to cv2's own
rounding, and `tests/test_torch_imgproc.py` holds each to cv2:

- `resize_nearest`: `cv2.resize(..., interpolation=INTER_NEAREST)`;
- `clahe_u16`: `cv2.createCLAHE(clip, grid).apply` on a uint16 image;
- `gaussian_blur`: `cv2.GaussianBlur` on a float64 image;
- `convert_maps_16sc2`: `cv2.convertMaps(map_x, map_y, CV_16SC2)`;
- `remap_bilinear`, `remap_nearest`: `cv2.remap` of those fixed-point maps,
  INTER_LINEAR and INTER_NEAREST, BORDER_CONSTANT with 0.
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
    """img[y, x], 0 where (y, x) lies outside the image."""
    h, w = img.shape[:2]
    inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    out = img[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)]
    return np.where(inside, out, np.zeros((), img.dtype))


def remap_bilinear(img: np.ndarray, maps) -> np.ndarray:
    """cv2.remap(img, xy, frac, INTER_LINEAR, BORDER_CONSTANT) of a 2-D
    float32 image: the four neighbours of each integer part weighted by the
    float32 products of (1 - f/32, f/32), summed in cv2's order."""
    xy, frac = maps
    img = np.asarray(img, np.float32)
    x, y = xy[..., 0].astype(np.int64), xy[..., 1].astype(np.int64)
    fx = (frac & (INTER_TAB_SIZE - 1)).astype(np.float32) / np.float32(INTER_TAB_SIZE)
    fy = (frac >> INTER_BITS).astype(np.float32) / np.float32(INTER_TAB_SIZE)
    one = np.float32(1)
    w00, w01 = (one - fy) * (one - fx), (one - fy) * fx
    w10, w11 = fy * (one - fx), fy * fx
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
