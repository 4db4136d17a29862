"""`jax.image.resize` in PyTorch, NCHW.

The JAX package resizes with `jax.image.resize` wherever the reference
interpolates outside the models (the legacy blocks' `interp` and bilinear
upsampling, the PSP pools' `adaptive_avg_pool` fallback, the PSP
pooling's upsample). `jax_resize` reproduces its rule for every method name it
accepts, on the two spatial axes of an NCHW map:

  * an axis whose size does not change is left alone;
  * "nearest" picks source index floor((i + 0.5) * in / out), computed in
    f32 as JAX computes it;
  * the other methods weight the source pixels with a kernel centred on
    the half-pixel position (i + 0.5) * in / out - 0.5: "linear"
    ("bilinear", "trilinear", "triangle") the triangle, "cubic"
    ("bicubic", "tricubic") Keys' cubic with a = -0.5 (PyTorch's plain
    bicubic takes -0.75), "lanczos3" and "lanczos5" Lanczos of radius 3
    and 5. Shrinking widens the kernel by the scale (antialias). Taps
    outside the map are dropped and each output's weights renormalised.

The linear rule is what `F.interpolate(mode="bilinear", antialias=True,
align_corners=False)` computes, and at an exact 2x enlargement what
`primitives.upsample2x` computes, so those take it. The cubic and Lanczos
methods take separable weight matrices built by JAX's formulas in f32 on
the CPU (so the card and the CPU resize with the same weights), cast to
x's dtype and applied one axis after the other, in the order that
`jnp.einsum` contracts them (the one of fewer multiply-adds first). A bf16 map's linear
filter is taken in f32 and rounded once (PyTorch has no bf16 antialiased
filter on the CPU; JAX rounds between its two passes).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from senas_torch.ops.primitives import upsample2x

_METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
            "trilinear": "linear", "triangle": "linear", "cubic": "cubic",
            "bicubic": "cubic", "tricubic": "cubic", "lanczos3": "lanczos3",
            "lanczos5": "lanczos5"}


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _lanczos(radius: float):
    def fill(x):
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x ** 2, 1.0), 1.0)
        return torch.where(x > radius, 0.0, out)
    return fill


_KERNELS = {"cubic": _keys_cubic, "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


def _weight_matrix(n_in: int, n_out: int, method: str) -> torch.Tensor:
    """[n_in, n_out] f32 weights of one axis (JAX's `compute_weight_mat`
    with antialias, scale n_out / n_in, no translation)."""
    kernel = _KERNELS[_METHODS[method]]
    inv_scale = 1.0 / torch.tensor(n_out / n_in, dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    weights = kernel(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def _nearest_indices(n_in: int, n_out: int) -> torch.Tensor:
    """Source index of each of n_out outputs: floor((i + 0.5) * n_in /
    n_out) in f32."""
    pos = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
    return pos.floor().long()


def jax_resize(x: torch.Tensor, size: Tuple[int, int], method: str = "linear") -> torch.Tensor:
    """x [B, C, H, W] resized to `size` (H', W') as `jax.image.resize(x_nhwc,
    (B, H', W', C), method)` resizes its NHWC twin."""
    if method not in _METHODS:
        raise ValueError(f'Unknown resize method "{method}"')
    kind = _METHODS[method]
    (h, w), (th, tw) = x.shape[2:], tuple(size)
    if (h, w) == (th, tw):
        return x
    if kind == "nearest":
        if h != th:
            x = x.index_select(2, _nearest_indices(h, th).to(x.device))
        if w != tw:
            x = x.index_select(3, _nearest_indices(w, tw).to(x.device))
        return x
    if kind == "linear":
        if (th, tw) == (2 * h, 2 * w):
            return upsample2x(x)
        z = x.float() if x.dtype == torch.bfloat16 else x
        return F.interpolate(z, size=(th, tw), mode="bilinear", antialias=True,
                             align_corners=False).to(x.dtype)
    def along_h(x):
        return torch.matmul(_weight_matrix(h, th, kind).t().to(x.device, x.dtype), x)

    def along_w(x):
        return torch.matmul(x, _weight_matrix(w, tw, kind).to(x.device, x.dtype))

    if h == th:
        return along_w(x)
    if w == tw:
        return along_h(x)
    # jnp.einsum's order: the one of fewer multiply-adds first
    if th * w * h + th * tw * w < h * tw * w + th * tw * h:
        return along_w(along_h(x))
    return along_h(along_w(x))


# the pool sizes of PSPNet's pyramid (zoo.PSPNet, customize.PyramidPooling)
PSP_SIZES = (1, 2, 3, 6)


def adaptive_avg_pool(x: torch.Tensor, size: int) -> torch.Tensor:
    """AdaptiveAvgPool2d((size, size)) as the JAX package computes it for the
    PSP pyramids (models/zoo.py:414-419, utils/customize.py:64): the mean
    over equal blocks where `size` divides H and W, else `jax_resize`'s
    linear filter, which antialiases when it shrinks. PyTorch's adaptive
    pool differs there (ROADMAP.md Queue 3, F3). Keeps x's dtype."""
    h, w = x.shape[2], x.shape[3]
    if h % size == 0 and w % size == 0:
        return F.avg_pool2d(x, (h // size, w // size))
    return jax_resize(x, (size, size), "linear")
