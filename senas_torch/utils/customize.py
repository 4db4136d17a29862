"""Legacy NN helpers inherited from the NasUnet skeleton, NCHW.

Port of `senas_tpu/utils/customize.py` (the reference's GramMatrix, View,
Sum, Mean, Normalize, ConcurrentModule and PyramidPooling). Nothing of the
framework calls them. `PyramidPooling` is the PSP block (Zhao et al.):
pools at 1, 2, 3 and 6, each through a 1x1 convolution (a raw kernel
`conv<i>`, stored OIHW), the port's `BatchNorm` `bn<i>` (K1a-K1d under
`SENAS_PALLAS_BN=1`) and a ReLU, upsampled by `jax.image.resize`'s
bilinear rule and concatenated with the input.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from senas_torch.ops.primitives import BatchNorm, add_conv_kernel, conv2d, relu
from senas_torch.ops.resize import PSP_SIZES, adaptive_avg_pool, jax_resize


def gram_matrix(y: torch.Tensor) -> torch.Tensor:
    """Gram matrix of NCHW feature maps: [B, C, C] / (C*H*W)."""
    b, c, h, w = y.shape
    feats = y.reshape(b, c, h * w)
    return torch.einsum("bcp,bdp->bcd", feats, feats) / (c * h * w)


def view(x: torch.Tensor, *shape) -> torch.Tensor:
    return x.reshape(shape)


def reduce_sum(x: torch.Tensor, axis, keepdims: bool = False) -> torch.Tensor:
    return x.sum(dim=axis, keepdim=keepdims)


def reduce_mean(x: torch.Tensor, axis, keepdims: bool = False) -> torch.Tensor:
    return x.mean(dim=axis, keepdim=keepdims)


def normalize(x: torch.Tensor, p: float = 2.0, axis: int = -1,
              eps: float = 1e-8) -> torch.Tensor:
    """F.normalize: x / max(||x||_p, eps) along `axis`."""
    norm = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(norm, min=eps)


class ConcurrentModule(nn.Module):
    """Feed x to every branch, concatenate the outputs on the channel axis.
    The branches are submodules `branches_<i>`, as flax names them."""

    def __init__(self, branches: Sequence[nn.Module]):
        super().__init__()
        self.n_branches = len(branches)
        for i, branch in enumerate(branches):
            setattr(self, f"branches_{i}", branch)

    def forward(self, x, *args, **kwargs):
        outs = [getattr(self, f"branches_{i}")(x, *args, **kwargs)
                for i in range(self.n_branches)]
        return torch.cat(outs, dim=1)


class PyramidPooling(nn.Module):
    """PSPNet pyramid pooling (customize.py:115+): x and, for each pool
    size, its pool -> 1x1 conv (in_channels // 4) -> BN -> ReLU, upsampled
    to x's size, concatenated on the channel axis."""

    def __init__(self, in_channels: int, dtype=None):
        super().__init__()
        out_c = in_channels // 4
        for i in range(len(PSP_SIZES)):
            add_conv_kernel(self, f"conv{i + 1}", (out_c, in_channels, 1, 1))
            setattr(self, f"bn{i + 1}", BatchNorm(out_c, dtype=dtype))

    def forward(self, x, train: bool = False):
        h, w = x.shape[2], x.shape[3]
        feats = [x]
        for i, size in enumerate(PSP_SIZES):
            y = adaptive_avg_pool(x, size)
            y = conv2d(y, getattr(self, f"conv{i + 1}").to(y.dtype))
            y = relu(getattr(self, f"bn{i + 1}")(y, train))
            feats.append(jax_resize(y, (h, w), "bilinear"))
        return torch.cat(feats, dim=1)
