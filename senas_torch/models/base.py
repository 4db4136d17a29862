"""Baseline-zoo shared blocks in PyTorch (NCHW inside).

Port of `senas_tpu/models/base.py` (the reference's vendored smp
base/modules.py and base/heads.py): Conv2dReLU, SCSE attention, the
segmentation and classification heads, smp's activation dispatch and the
encoder -> decoder -> head output contract. Submodules and parameters carry
the flax names (`kernel`, `bias`, `BatchNorm_0`, `Dense_0`, ...), so
`senas_torch.convert` maps the two trees leaf by leaf. Kernels are OIHW.

Under the mesh's row split (`senas_torch.parallel`) every map is this
rank's block of image rows: the resizes read their source rows at the
global positions (`spatial.source_rows`), a target size is global (a
level's height is `collectives.global_height`), and the means span the
global image.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from senas_torch.core.device import resolve_device
from senas_torch.ops.primitives import (BatchNorm, Dense, Dropout, add_bias, add_conv_kernel,
                                        conv2d, image_mean, init_params_, is_split, kaiming_std,
                                        log_softmax, relu, sigmoid, softmax, whole_level)
from senas_torch.parallel import spatial
from senas_torch.parallel.collectives import active_split, global_height


class Conv2dReLU(nn.Module):
    """conv -> [BN] -> ReLU. Without BN the conv has a bias with torch's
    default init. The conv runs in x's dtype (the kernel cast at use) and
    BN rounds to `dtype`, as senas_tpu's Conv2dReLU does; without BN the
    result stays in x's dtype."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3, stride: int = 1,
                 use_batchnorm: bool = True, dtype=None):
        super().__init__()
        k = kernel_size
        self.stride = stride
        add_conv_kernel(self, "kernel", (c_out, c_in, k, k))
        if use_batchnorm:
            self.BatchNorm_0 = BatchNorm(c_out, dtype=dtype)
        else:
            add_bias(self, "bias", c_out, fan_in=c_in * k * k)

    def forward(self, x, train: bool = False):
        x = conv2d(x, self.kernel.to(x.dtype), stride=self.stride)
        if hasattr(self, "BatchNorm_0"):
            x = self.BatchNorm_0(x, train)
        else:
            x = x + self.bias.to(x.dtype)[:, None, None]
        return relu(x)


class SCSEModule(nn.Module):
    """Concurrent spatial & channel SE (smp modules.py:50-73). smp's 1x1
    convs with bias: kernels kaiming fan_out, biases torch's conv default.
    The channel SE's Dense layers compute in `dtype`, the spatial SE in x's."""

    def __init__(self, c: int, reduction: int = 16, dtype=None):
        super().__init__()
        mid = max(1, c // reduction)
        self.Dense_0 = Dense(c, mid, bias=True, std=kaiming_std(mid), bias_fan_in=c,
                             dtype=dtype)
        self.Dense_1 = Dense(mid, c, bias=True, std=kaiming_std(c), bias_fan_in=mid,
                             dtype=dtype)
        add_conv_kernel(self, "s_kernel", (1, c, 1, 1))
        add_bias(self, "s_bias", 1, fan_in=c)

    def forward(self, x):
        y = image_mean(x)
        y = self.Dense_1(relu(self.Dense_0(y)))
        cse = x * sigmoid(y)[:, :, None, None]
        s = conv2d(x, self.s_kernel.to(x.dtype)) + self.s_bias.to(x.dtype)[:, None, None]
        return cse + x * sigmoid(s)


class Attention(nn.Module):
    """None | 'scse' (smp modules.py:107-119)."""

    def __init__(self, c: int, attention_type: Optional[str] = None, dtype=None):
        super().__init__()
        if attention_type not in (None, "scse"):
            raise ValueError(f"unknown attention {attention_type!r}")
        if attention_type == "scse":
            self.SCSEModule_0 = SCSEModule(c, dtype=dtype)

    def forward(self, x):
        return self.SCSEModule_0(x) if hasattr(self, "SCSEModule_0") else x


def upsample_nearest2x(x):
    """Nearest 2x: every source pixel twice along each axis (what
    jax.image.resize 'nearest' gives at an integer factor of 2). Under a
    row split output row i is input row i // 2 of the global level, which
    may lie on another rank: the blocks of 2H rows do not line up with
    twice those of H where the spatial size does not divide H."""
    if not is_split(x):
        return F.interpolate(x, scale_factor=2, mode="nearest")
    h = 2 * global_height(x)
    rows, = spatial.source_rows(x, h, [[i // 2 for i in range(h)]])
    return spatial.entered(rows.repeat_interleave(2, dim=3), h)


def _aligned_taps(n_in: int, n_out: int, device):
    """The two source indices and the weight of the second one for each of
    n_out positions with torch's align_corners=True, from senas_tpu's
    jnp.linspace(0, n_in - 1, n_out) in f32 (its iota / (n_out - 1) times
    n_in - 1, the last position exactly n_in - 1)."""
    if n_out > 1:
        pos = (n_in - 1.0) * (torch.arange(n_out, dtype=torch.float32, device=device)
                              / (n_out - 1))
        pos[-1] = n_in - 1.0
    else:
        pos = torch.zeros(1, dtype=torch.float32, device=device)
    i0 = pos.floor().long().clamp(0, n_in - 1)
    return i0, (i0 + 1).clamp(max=n_in - 1), pos - i0


def _interpolate_taps(n_in: int, n_out: int, dtype):
    """The taps of F.interpolate(mode="bilinear", align_corners=True) along
    one axis, as PyTorch computes them in `dtype` (its opmath type: f32 for
    f32, f64 for f64): position scale * i with scale (n_in - 1) / (n_out -
    1), the lower index its floor, the weight of the upper one the rest."""
    scale = (torch.tensor(n_in - 1, dtype=dtype) / (n_out - 1) if n_out > 1
             else torch.zeros((), dtype=dtype))
    pos = scale * torch.arange(n_out, dtype=dtype)
    i0 = pos.floor().long().clamp(0, n_in - 1)
    return i0, (i0 + 1).clamp(max=n_in - 1), (pos - i0).clamp(0, 1)


def _two_lerps(rows0, rows1, wy, cols, out_dtype):
    """The bilinear formula: each row pair's column lerps, then the lerp
    between them, each op in `out_dtype`."""
    x0, x1, wx = cols
    wy, wx = wy.to(out_dtype)[:, None], wx.to(out_dtype)
    top = rows0.index_select(3, x0) * (1 - wx) + rows0.index_select(3, x1) * wx
    bot = rows1.index_select(3, x0) * (1 - wx) + rows1.index_select(3, x1) * wx
    return top * (1 - wy) + bot * wy


def resize_bilinear(x, size_hw, weight_dtype=None, whole: bool = False):
    """Bilinear resize with torch's align_corners=True: the corners of the
    input and the output coincide. senas_tpu computes it from linspace
    indices with weights in `weight_dtype` (None: x's dtype), so the result
    is in the promoted dtype of the two: senas_tpu's zoo keeps f32 weights
    (models/zoo.py:31-48), and a bf16 map comes out f32; its heads cast them
    to x's dtype (models/base.py:95-117). A 1x1 map is broadcast in its own
    dtype in both.

    An f32 (or f64) map takes F.interpolate. A bf16 map takes senas_tpu's
    formula itself, two lerps with each op in the result's dtype: with bf16
    weights the bf16 roundings fall where XLA's do; with f32 weights it is
    f32 arithmetic on the bf16 values.

    Under a row split `size_hw` is the global size, and the result is this
    rank's rows of it: each output row reads the two rows at its position
    in the global level (`spatial.source_rows`; with `whole`, x is a map
    every rank holds whole, and no rows are exchanged). The bf16 formula is
    the same; an f32 or f64 map takes it with F.interpolate's taps, which
    agrees with F.interpolate to rounding."""
    th, tw = size_hw
    if is_split(x):
        return _split_resize(x, th, tw, weight_dtype, whole)
    if x.dtype != torch.bfloat16:
        return F.interpolate(x.to(torch.promote_types(x.dtype, weight_dtype or x.dtype)),
                             size=(th, tw), mode="bilinear", align_corners=True)
    if x.shape[2] == 1 and x.shape[3] == 1:
        return x.expand(-1, -1, th, tw)
    out_dtype = weight_dtype or x.dtype
    y0, y1, wy = _aligned_taps(x.shape[2], th, x.device)
    g = x.to(out_dtype)
    return _two_lerps(g.index_select(2, y0), g.index_select(2, y1), wy,
                      _aligned_taps(x.shape[3], tw, x.device), out_dtype)


def _split_resize(x, th: int, tw: int, weight_dtype, whole: bool):
    h = x.shape[2] if whole else global_height(x)
    bf16 = x.dtype == torch.bfloat16
    out_dtype = (weight_dtype or x.dtype) if bf16 else torch.promote_types(
        x.dtype, weight_dtype or x.dtype)
    if h == 1 and x.shape[3] == 1:
        row, = spatial.source_rows(x, th, [[0] * th], whole)
        y = (row if bf16 else row.to(out_dtype)).expand(-1, -1, -1, tw)
        return spatial.entered(y.contiguous(), th)
    taps = ((lambda n, m: _aligned_taps(n, m, "cpu")) if bf16
            else (lambda n, m: _interpolate_taps(n, m, out_dtype)))
    y0, y1, wy = taps(h, th)
    rows0, rows1 = spatial.source_rows(x.to(out_dtype), th, [y0.tolist(), y1.tolist()], whole)
    oa, ob = active_split().bounds(th)
    cols = [t.to(x.device) for t in taps(x.shape[3], tw)]
    return spatial.entered(_two_lerps(rows0, rows1, wy[oa:ob].to(x.device), cols, out_dtype),
                           th)


def upsample_bilinear(x, factor: int):
    """smp's nn.UpsamplingBilinear2d (align_corners=True) by `factor`, its
    weights in x's dtype."""
    return resize_bilinear(x, (global_height(x) * factor, x.shape[3] * factor))


def smp_activation(name):
    """smp's `Activation` dispatch (base/modules.py:76-105) as a function of
    an NHWC tensor (the channel axis is the last, as in senas_tpu); in bf16
    the sigmoid and softmaxes round op by op as jax.nn's."""
    if name is None or name == "identity":
        return lambda x: x
    if name == "sigmoid":
        return sigmoid
    if name in ("softmax", "softmax2d"):
        return softmax
    if name == "logsoftmax":
        return log_softmax
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
    """3x3 conv (+bias) -> optional bilinear upsample (heads.py:5-11), in
    x's dtype. The activation is applied at the model's NHWC boundary."""

    def __init__(self, c_in: int, classes: int, kernel_size: int = 3, upsampling: int = 1):
        super().__init__()
        k = kernel_size
        self.upsampling = upsampling
        add_conv_kernel(self, "kernel", (classes, c_in, k, k))
        add_bias(self, "bias", classes, fan_in=c_in * k * k)

    def forward(self, x):
        x = conv2d(x, self.kernel.to(x.dtype)) + self.bias.to(x.dtype)[:, None, None]
        return upsample_bilinear(x, self.upsampling) if self.upsampling > 1 else x


class ClassificationHead(nn.Module):
    """avg/max pool -> dropout (train mode) -> linear -> optional
    activation (heads.py:14-25). The Dense is an nn.Linear under
    weights_init: xavier_normal kernel, zero bias; it computes in `dtype`."""

    def __init__(self, c_in: int, classes: int, pooling: str = "avg", dropout: float = 0.2,
                 activation: Optional[Any] = None, dtype=None):
        super().__init__()
        if pooling not in ("max", "avg"):
            raise ValueError("Pooling should be one of ('max', 'avg'), "
                             "got {}.".format(pooling))
        self.pooling, self.activation = pooling, activation
        self.dropout = Dropout(dropout or 0.0)
        self.Dense_0 = Dense(c_in, classes, bias=True, dtype=dtype)

    def forward(self, x, train: bool = False, rng: Optional[torch.Generator] = None):
        y = image_mean(x) if self.pooling == "avg" else whole_level(x).amax(dim=(2, 3))
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
                     device, generator: Optional[torch.Generator], dtype=None) -> None:
        self.activation = activation
        self.aux_params = aux_params
        if aux_params is not None:
            self.classification_head = ClassificationHead(deepest, **aux_params, dtype=dtype)
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
