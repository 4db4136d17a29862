"""Pillow's geometry on uint8 arrays, bit for bit, without Pillow.

The JAX package's generic loaders transform Pillow images
(`senas_tpu/data/generic.py:47-87`); these functions compute the same
pixels on numpy arrays ([H, W] for "L" and "P", [H, W, 3] for "RGB"),
held to Pillow 12.1.0 in `tests/test_torch_pilresample.py`:

- `resize_bilinear(arr, (w, h))`: `Image.resize(size, BILINEAR)`, which
  antialiases when it reduces (Resample.c `ImagingResample`). Each axis
  gets a table of windows and weights: the filter's support is 1, times
  the scale when reducing; the weights are normalised in double and
  rounded half away from zero to 22-bit fixed point. The horizontal pass
  runs first, over the rows the vertical pass reads, then the vertical
  pass; each adds 1 << 21, shifts right by 22 and clips to 8 bits. An
  axis whose size does not change is not resampled.
- `resize_nearest(arr, (w, h))`: `resize(size, NEAREST)` (any mode, "P"
  too: indices are picked, not mixed), Pillow's affine scale: output
  pixel x reads input floor(x0 + x * a), x0 = a / 2, accumulated in
  double as Geometry.c `ImagingScaleAffine` does.
- `flip_left_right`, `expand` (`ImageOps.expand(border=(0, 0, padw,
  padh), fill=0)`) and `crop` (a box past the image reads 0).

The integer passes run in the native library (`data/native/
image_native.cpp`); `native=False` runs their numpy twins.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Resample.c `precompute_coeffs` + `normalize_coeffs_8bpc` for the
    bilinear filter over the whole axis (Pillow's box (0, in_size)):
    `bounds` int32 [out, 2] (first input, count) and the fixed-point
    weights int32 [out, ksize]. Vectorised over the outputs with Pillow's
    double arithmetic, op for op; each output's weight sum adds its taps
    in order, as Pillow's loop does."""
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)[None]
    used = taps < xmax[:, None]
    k = np.abs((taps + xmin[:, None] - center[:, None] + 0.5) * ss)   # the triangle filter
    k = np.where(used & (k < 1.0), 1.0 - k, 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):
        ww = ww + k[:, x]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    one = float(1 << PRECISION_BITS)
    kk = np.where(k < 0, np.trunc(-0.5 + k * one), np.trunc(0.5 + k * one)).astype(np.int32)
    return np.stack([xmin, xmax], 1).astype(np.int32), kk


def _pass_numpy(src: np.ndarray, bounds: np.ndarray, kk: np.ndarray) -> np.ndarray:
    """One pass along axis 0 of uint8 `src` [N, ...]: output i is the sum
    of src[bounds[i,0] + j] * kk[i, j] over j < bounds[i, 1]."""
    n_out, ksize = kk.shape
    idx = np.minimum(bounds[:, :1] + np.arange(ksize)[None], src.shape[0] - 1)
    w = np.where(np.arange(ksize)[None] < bounds[:, 1:], kk, 0).astype(np.int64)
    acc = np.full((n_out,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    extra = (1,) * (src.ndim - 1)
    for j in range(ksize):
        acc += src[idx[:, j]].astype(np.int64) * w[:, j].reshape((-1,) + extra)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(arr: np.ndarray, size: Tuple[int, int], native: bool = True) -> np.ndarray:
    """`Image.resize(size, Image.BILINEAR)` of an "L" [H, W] or "RGB"
    [H, W, 3] uint8 array; `size` is (width, height) as Pillow takes it."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3):
        raise ValueError(f"resize_bilinear takes uint8 [H, W] or [H, W, C], got "
                         f"{arr.dtype} {arr.shape}")
    out_w, out_h = size
    h, w = arr.shape[:2]
    if (out_w, out_h) == (w, h):
        return arr.copy()
    img = arr.reshape(h, w, -1)
    vb, vk = coefficients(h, out_h)
    need_h, need_v = out_w != w, out_h != h
    if need_h:
        first = int(vb[0, 0])
        last = int(vb[-1, 0] + vb[-1, 1])
        hb, hk = coefficients(w, out_w)
        if native:
            from senas_torch.data import native as nat
            img = nat.resample_h(img, first, last - first, out_w, hb, hk)
        else:
            img = _pass_numpy(img[first:last].transpose(1, 0, 2), hb, hk).transpose(1, 0, 2)
        vb = vb.copy()
        vb[:, 0] -= first
    if need_v:
        if native:
            from senas_torch.data import native as nat
            img = nat.resample_v(img, out_h, vb, vk)
        else:
            img = _pass_numpy(img, vb, vk)
    return np.ascontiguousarray(img.reshape((out_h, out_w) + arr.shape[2:]))


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's source column of each output column: x0 = a / 2, then
    x += a, one addition at a time in double (add.accumulate adds in
    order), truncated."""
    a = in_size / out_size
    steps = np.full(out_size, a)
    steps[0] = a * 0.5
    pos = np.add.accumulate(steps)
    return np.where(pos < 0.0, -1, pos.astype(np.int64))


def resize_nearest(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`Image.resize(size, Image.NEAREST)` of `arr` [H, W] or [H, W, C]
    (values or palette indices); `size` is (width, height)."""
    arr = np.asarray(arr)
    out_w, out_h = size
    h, w = arr.shape[:2]
    if (out_w, out_h) == (w, h):
        return arr.copy()
    xs, ys = _nearest_index(w, out_w), _nearest_index(h, out_h)
    out = np.zeros((out_h, out_w) + arr.shape[2:], arr.dtype)
    xin = (xs >= 0) & (xs < w)
    yin = (ys >= 0) & (ys < h)
    out[np.ix_(yin, xin)] = arr[np.ix_(ys[yin], xs[xin])]
    return out


def flip_left_right(arr: np.ndarray) -> np.ndarray:
    """`transpose(Image.FLIP_LEFT_RIGHT)`."""
    return np.ascontiguousarray(np.asarray(arr)[:, ::-1])


def expand(arr: np.ndarray, padw: int, padh: int) -> np.ndarray:
    """`ImageOps.expand(img, border=(0, 0, padw, padh), fill=0)`: zeros
    (palette index 0) on the right and at the bottom."""
    arr = np.asarray(arr)
    pad = ((0, padh), (0, padw)) + ((0, 0),) * (arr.ndim - 2)
    return np.pad(arr, pad)


def crop(arr: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    """`crop((x1, y1, x2, y2))`; what lies outside the image is 0."""
    arr = np.asarray(arr)
    x1, y1, x2, y2 = box
    h, w = arr.shape[:2]
    out = np.zeros((y2 - y1, x2 - x1) + arr.shape[2:], arr.dtype)
    sx1, sy1, sx2, sy2 = max(x1, 0), max(y1, 0), min(x2, w), min(y2, h)
    if sx2 > sx1 and sy2 > sy1:
        out[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1] = arr[sy1:sy2, sx1:sx2]
    return out
