"""Baseline-zoo shared blocks in PyTorch (NCHW inside).

Port of `senas_tpu/models/base.py` (the reference's vendored smp
base/modules.py and base/heads.py): Conv2dReLU, SCSE attention, the
segmentation and classification heads, smp's activation dispatch and the
encoder -> decoder -> head output contract. Submodules and parameters carry
the flax names (`kernel`, `bias`, `BatchNorm_0`, `Dense_0`, ...), so
`senas_torch.convert` maps the two trees leaf by leaf. Kernels are OIHW.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from senas_torch.core.device import resolve_device
from senas_torch.ops.primitives import (BatchNorm, Dense, Dropout, add_bias, add_conv_kernel,
                                        conv2d, init_params_, kaiming_std, relu)


class Conv2dReLU(nn.Module):
    """conv -> [BN] -> ReLU. Without BN the conv has a bias with torch's
    default init."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3, stride: int = 1,
                 use_batchnorm: bool = True):
        super().__init__()
        k = kernel_size
        self.stride = stride
        add_conv_kernel(self, "kernel", (c_out, c_in, k, k))
        if use_batchnorm:
            self.BatchNorm_0 = BatchNorm(c_out)
        else:
            add_bias(self, "bias", c_out, fan_in=c_in * k * k)

    def forward(self, x, train: bool = False):
        x = conv2d(x, self.kernel, stride=self.stride)
        if hasattr(self, "BatchNorm_0"):
            x = self.BatchNorm_0(x, train)
        else:
            x = x + self.bias[:, None, None]
        return relu(x)


class SCSEModule(nn.Module):
    """Concurrent spatial & channel SE (smp modules.py:50-73). smp's 1x1
    convs with bias: kernels kaiming fan_out, biases torch's conv default."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        mid = max(1, c // reduction)
        self.Dense_0 = Dense(c, mid, bias=True, std=kaiming_std(mid), bias_fan_in=c)
        self.Dense_1 = Dense(mid, c, bias=True, std=kaiming_std(c), bias_fan_in=mid)
        add_conv_kernel(self, "s_kernel", (1, c, 1, 1))
        add_bias(self, "s_bias", 1, fan_in=c)

    def forward(self, x):
        y = x.mean(dim=(2, 3))
        y = self.Dense_1(relu(self.Dense_0(y)))
        cse = x * torch.sigmoid(y)[:, :, None, None]
        sse = x * torch.sigmoid(conv2d(x, self.s_kernel) + self.s_bias[:, None, None])
        return cse + sse


class Attention(nn.Module):
    """None | 'scse' (smp modules.py:107-119)."""

    def __init__(self, c: int, attention_type: Optional[str] = None):
        super().__init__()
        if attention_type not in (None, "scse"):
            raise ValueError(f"unknown attention {attention_type!r}")
        if attention_type == "scse":
            self.SCSEModule_0 = SCSEModule(c)

    def forward(self, x):
        return self.SCSEModule_0(x) if hasattr(self, "SCSEModule_0") else x


def upsample_nearest2x(x):
    """Nearest 2x: every source pixel twice along each axis (what
    jax.image.resize 'nearest' gives at an integer factor of 2)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_bilinear(x, size_hw):
    """Bilinear resize with torch's align_corners=True: the corners of the
    input and the output coincide. senas_tpu computes it from linspace
    indices (models/base.py:95-117, models/zoo.py:31-52); a 1x1 input is
    broadcast in both."""
    return F.interpolate(x, size=tuple(size_hw), mode="bilinear", align_corners=True)


def upsample_bilinear(x, factor: int):
    """smp's nn.UpsamplingBilinear2d (align_corners=True) by `factor`."""
    return resize_bilinear(x, (x.shape[2] * factor, x.shape[3] * factor))


def smp_activation(name):
    """smp's `Activation` dispatch (base/modules.py:76-105) as a function of
    an NHWC tensor (the channel axis is the last, as in senas_tpu)."""
    if name is None or name == "identity":
        return lambda x: x
    if name == "sigmoid":
        return torch.sigmoid
    if name in ("softmax", "softmax2d"):
        return lambda x: torch.softmax(x, dim=-1)
    if name == "logsoftmax":
        return lambda x: torch.log_softmax(x, dim=-1)
    if name == "tanh":
        return torch.tanh
    if name == "argmax":
        return torch.argmax
    if name == "argmax2d":
        return lambda x: torch.argmax(x, dim=-1)
    if callable(name):
        return name
    raise ValueError(
        "Activation should be callable/sigmoid/softmax/logsoftmax/tanh/"
        "None; got {}".format(name))


class SegmentationHead(nn.Module):
    """3x3 conv (+bias) -> optional bilinear upsample (heads.py:5-11). The
    activation is applied at the model's NHWC boundary."""

    def __init__(self, c_in: int, classes: int, kernel_size: int = 3, upsampling: int = 1):
        super().__init__()
        k = kernel_size
        self.upsampling = upsampling
        add_conv_kernel(self, "kernel", (classes, c_in, k, k))
        add_bias(self, "bias", classes, fan_in=c_in * k * k)

    def forward(self, x):
        x = conv2d(x, self.kernel) + self.bias[:, None, None]
        return upsample_bilinear(x, self.upsampling) if self.upsampling > 1 else x


class ClassificationHead(nn.Module):
    """avg/max pool -> dropout (train mode) -> linear -> optional
    activation (heads.py:14-25). The Dense is an nn.Linear under
    weights_init: xavier_normal kernel, zero bias."""

    def __init__(self, c_in: int, classes: int, pooling: str = "avg", dropout: float = 0.2,
                 activation: Optional[Any] = None):
        super().__init__()
        if pooling not in ("max", "avg"):
            raise ValueError("Pooling should be one of ('max', 'avg'), "
                             "got {}.".format(pooling))
        self.pooling, self.activation = pooling, activation
        self.dropout = Dropout(dropout or 0.0)
        self.Dense_0 = Dense(c_in, classes, bias=True)

    def forward(self, x, train: bool = False, rng: Optional[torch.Generator] = None):
        y = x.mean(dim=(2, 3)) if self.pooling == "avg" else x.amax(dim=(2, 3))
        y = self.dropout(y, train, rng)
        return smp_activation(self.activation)(self.Dense_0(y))


class SegmentationModel(nn.Module):
    """The encoder -> decoder -> head composition of smp's SegmentationModel
    (base/model.py:13-24) at senas_tpu's NHWC boundary.

    forward(x [B,H,W,C_in], train, rng) -> [masks [B,H',W',classes]], or
    ([masks], labels [B,classes]) with `aux_params`, whose
    ClassificationHead reads the deepest encoder feature. A subclass builds
    its encoder, decoder and `SegmentationHead_0`, then calls
    `_finish_init`, and implements `decode(x NCHW, train, rng) -> (logits
    NCHW, encoder features)`."""

    def _finish_init(self, aux_params: Optional[dict], deepest: int, activation,
                     device, generator: Optional[torch.Generator]) -> None:
        self.activation = activation
        self.aux_params = aux_params
        if aux_params is not None:
            self.classification_head = ClassificationHead(deepest, **aux_params)
        init_params_(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.to(resolve_device(device))

    def forward(self, x, train: bool = False, rng: Optional[torch.Generator] = None):
        # NHWC -> NCHW with canonical strides (a 1-channel permuted view
        # counts as contiguous with channels_last strides)
        x = x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
        logits, feats = self.decode(x, train, rng)
        masks = smp_activation(self.activation)(logits.permute(0, 2, 3, 1))
        if self.aux_params is None:
            return [masks]
        return [masks], self.classification_head(feats[-1], train, rng)
