"""VGG, DenseNet, MobileNetV2 and EfficientNet encoders of the baseline zoo
in PyTorch (NCHW inside).

Port of `senas_tpu/models/encoders_extra.py`: the same stage boundaries and
per-stage channels as smp's encoders/{vgg,densenet,mobilenet,
efficientnet}.py, so every zoo decoder works on top. Each encoder is built
with its input channels; parameters carry the flax names. Where
senas_tpu departs from smp, the port follows senas_tpu: EfficientNet has
no drop-connect, and `timm-efficientnet-*` is the `efficientnet-b*`
architecture.

`dtype` is the compute dtype, as in senas_tpu: the stem casts its input to
it (VGG every conv's input), every BatchNorm rounds its output to it, and a
conv runs in its input's dtype with its f32 kernel cast at use.

Every conv and pool goes through `primitives` and EfficientNet's SE mean
is `image_mean`, so each encoder runs under the mesh's row split
(`senas_torch.parallel.spatial`).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from senas_torch.models.encoders import stage_dilation
from senas_torch.ops.primitives import (BatchNorm, add_bias, add_conv_kernel, add_kernel,
                                        avg_pool_2x2, cast, conv2d, image_mean, kaiming_std,
                                        max_pool_2x2, max_pool_3x3, relu, sigmoid)

# VGG configs (vgg.py:34-39): numbers are conv widths, "M" is a 2x2 maxpool
_VGG_CFG = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def relu6(x):
    return F.hardtanh(x, 0.0, 6.0)


def swish(x):
    """jax.nn.swish, x * sigmoid(x), with `primitives.sigmoid`."""
    return x * sigmoid(x)


class VGGEncoder(nn.Module):
    """VGG feature pyramid: a stage ends right before each maxpool, the
    final stage is the last pool alone (vgg.py:44-69 get_stages); the first
    map is the first block's output, not the input. out_channels (64, 128,
    256, 512, 512, 512)."""

    def __init__(self, in_channels: int, config: Sequence, batch_norm: bool = False,
                 depth: int = 5, dtype=None):
        super().__init__()
        self.depth, self.batch_norm, self.dtype = depth, batch_norm, dtype
        # the forward's plan: a conv index or "M" (a tap, then a pool)
        self.plan: List = []
        c, stage, i = in_channels, 0, 0
        for item in config:
            if item == "M":
                stage += 1
                self.plan.append("M")
                if stage > depth:
                    break
            else:
                add_conv_kernel(self, f"conv{i}", (item, c, 3, 3))
                add_bias(self, f"bias{i}", item)
                if batch_norm:
                    setattr(self, f"bn{i}", BatchNorm(item, dtype=dtype))
                self.plan.append(i)
                c, i = item, i + 1
        self.trailing = stage <= depth

    def forward(self, x, train: bool = False):
        features, stage = [], 0
        for item in self.plan:
            if item == "M":
                features.append(x)
                stage += 1
                if stage > self.depth:
                    break
                x = max_pool_2x2(x)
            else:
                x = cast(x, self.dtype)
                x = conv2d(x, getattr(self, f"conv{item}").to(x.dtype)) \
                    + getattr(self, f"bias{item}").to(x.dtype)[:, None, None]
                if self.batch_norm:
                    x = getattr(self, f"bn{item}")(x, train)
                x = relu(x)
        if self.trailing:
            features.append(max_pool_2x2(features[-1]))
        return features[:self.depth + 1]


class _DenseLayer(nn.Module):
    def __init__(self, c_in: int, growth: int, dtype=None):
        super().__init__()
        self.norm1 = BatchNorm(c_in, dtype=dtype)
        add_conv_kernel(self, "conv1", (4 * growth, c_in, 1, 1))
        self.norm2 = BatchNorm(4 * growth, dtype=dtype)
        add_conv_kernel(self, "conv2", (growth, 4 * growth, 3, 3))

    def forward(self, x, train: bool = False):
        y = relu(self.norm1(x, train))
        y = conv2d(y, self.conv1.to(y.dtype))
        y = relu(self.norm2(y, train))
        y = conv2d(y, self.conv2.to(y.dtype))
        return torch.cat([x, y], dim=1)


class DenseNetEncoder(nn.Module):
    """DenseNet feature pyramid (densenet.py stage contract): f0 = x, f1 =
    the stem conv (stride 2), then each dense block's output taken before
    its transition's pooling, the final block after the last norm."""

    def __init__(self, in_channels: int, growth: int = 32, init_channels: int = 64,
                 block_layers: Sequence[int] = (6, 12, 24, 16), depth: int = 5, dtype=None):
        super().__init__()
        self.depth, self.dtype, self.block_layers = depth, dtype, tuple(block_layers)
        maps = 1   # the maps the forward returns so far
        self.n_blocks = 0
        if depth > 0:
            add_conv_kernel(self, "conv0", (init_channels, in_channels, 7, 7))
            self.norm0 = BatchNorm(init_channels, dtype=dtype)
            maps += 1
        c = init_channels
        for bi, n_layers in enumerate(self.block_layers):
            if depth == 0 or maps > depth:
                break
            for li in range(n_layers):
                setattr(self, f"block{bi}_layer{li}", _DenseLayer(c, growth, dtype))
                c += growth
            setattr(self, f"trans{bi}_norm", BatchNorm(c, dtype=dtype))
            maps += 1
            if bi != len(self.block_layers) - 1:
                add_conv_kernel(self, f"trans{bi}_conv", (c // 2, c, 1, 1))
                c //= 2
            self.n_blocks += 1

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        x = cast(x, self.dtype)
        x = relu(self.norm0(conv2d(x, self.conv0.to(x.dtype), stride=2), train))
        features.append(x)
        x = max_pool_3x3(x, stride=2)
        for bi in range(self.n_blocks):
            for li in range(self.block_layers[bi]):
                x = getattr(self, f"block{bi}_layer{li}")(x, train)
            x = relu(getattr(self, f"trans{bi}_norm")(x, train))
            features.append(x)  # block output, pre-transition-pool
            if hasattr(self, f"trans{bi}_conv"):
                x = conv2d(x, getattr(self, f"trans{bi}_conv").to(x.dtype))
                x = avg_pool_2x2(x)
        return features[:self.depth + 1]


class _InvertedResidual(nn.Module):
    """MobileNetV2 block. `dilation` > 1: the block sits in a dilated stage
    (conv strides 1, depthwise dilated); the residual test keeps the
    original stride, as the patched torch module does."""

    def __init__(self, c_in: int, c_out: int, stride: int, expand: int, dilation: int = 1,
                 dtype=None):
        super().__init__()
        self.stride, self.expand, self.dilation = stride, expand, dilation
        self.residual = stride == 1 and c_in == c_out
        hidden = c_in * expand
        if expand != 1:
            add_conv_kernel(self, "expand_conv", (hidden, c_in, 1, 1))
            self.expand_bn = BatchNorm(hidden, dtype=dtype)
        add_conv_kernel(self, "dw_conv", (hidden, 1, 3, 3))
        self.dw_bn = BatchNorm(hidden, dtype=dtype)
        add_conv_kernel(self, "project_conv", (c_out, hidden, 1, 1))
        self.project_bn = BatchNorm(c_out, dtype=dtype)

    def forward(self, x, train: bool = False):
        y = x
        if self.expand != 1:
            y = relu6(self.expand_bn(conv2d(y, self.expand_conv.to(y.dtype)), train))
        y = conv2d(y, self.dw_conv.to(y.dtype), stride=1 if self.dilation > 1 else self.stride,
                   groups=self.dw_conv.shape[0], dilation=self.dilation)
        y = relu6(self.dw_bn(y, train))
        y = self.project_bn(conv2d(y, self.project_conv.to(y.dtype)), train)
        return x + y if self.residual else y


# MobileNetV2 inverted-residual plan: (expand, channels, repeats, stride)
_MBV2_PLAN = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
              (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
# the pyramid taps after these plan groups: (3, 16, 24, 32, 96, 1280)
_MBV2_STAGE_AFTER = {0: 1, 1: 2, 2: 3, 4: 4}
# the pyramid stage of each plan group (mobilenet.py get_stages)
_MBV2_GROUP_STAGE = {0: 1, 1: 2, 2: 3, 3: 4, 4: 4, 5: 5, 6: 5}


class MobileNetV2Encoder(nn.Module):
    """MobileNetV2 feature pyramid (mobilenet.py stage contract):
    out_channels (3, 16, 24, 32, 96, 1280)."""

    def __init__(self, in_channels: int, depth: int = 5, output_stride: int = 32, dtype=None):
        super().__init__()
        self.depth, self.dtype = depth, dtype
        maps = 1   # the maps the forward returns so far
        self.groups_run: List[Tuple[List[str], bool]] = []
        self.last = False
        if depth > 0:
            add_conv_kernel(self, "stem_conv", (32, in_channels, 3, 3))
            self.stem_bn = BatchNorm(32, dtype=dtype)
            c = 32
            for pi, (t, c_out, n, s) in enumerate(_MBV2_PLAN):
                rate = stage_dilation(_MBV2_GROUP_STAGE[pi], output_stride)
                names = []
                for r in range(n):
                    setattr(self, f"block{pi}_{r}", _InvertedResidual(
                        c, c_out, s if r == 0 else 1, t, dilation=rate, dtype=dtype))
                    names.append(f"block{pi}_{r}")
                    c = c_out
                tap = pi in _MBV2_STAGE_AFTER
                self.groups_run.append((names, tap))
                if tap:
                    maps += 1
                    if maps > depth:
                        break
            else:
                add_conv_kernel(self, "last_conv", (1280, c, 1, 1))
                self.last_bn = BatchNorm(1280, dtype=dtype)
                self.last = True

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        x = cast(x, self.dtype)
        x = relu6(self.stem_bn(conv2d(x, self.stem_conv.to(x.dtype), stride=2), train))
        for names, tap in self.groups_run:
            for name in names:
                x = getattr(self, name)(x, train)
            if tap:
                features.append(x)
        if self.last:
            x = relu6(self.last_bn(conv2d(x, self.last_conv.to(x.dtype)), train))
            features.append(x)
        return features[:self.depth + 1]


EXTRA_ENCODERS = {
    "vgg11": dict(cls=VGGEncoder, kw=dict(config=tuple(_VGG_CFG["A"]))),
    "vgg11_bn": dict(cls=VGGEncoder,
                     kw=dict(config=tuple(_VGG_CFG["A"]), batch_norm=True)),
    "vgg13": dict(cls=VGGEncoder, kw=dict(config=tuple(_VGG_CFG["B"]))),
    "vgg13_bn": dict(cls=VGGEncoder,
                     kw=dict(config=tuple(_VGG_CFG["B"]), batch_norm=True)),
    "vgg16": dict(cls=VGGEncoder, kw=dict(config=tuple(_VGG_CFG["D"]))),
    "vgg16_bn": dict(cls=VGGEncoder,
                     kw=dict(config=tuple(_VGG_CFG["D"]), batch_norm=True)),
    "vgg19": dict(cls=VGGEncoder, kw=dict(config=tuple(_VGG_CFG["E"]))),
    "vgg19_bn": dict(cls=VGGEncoder,
                     kw=dict(config=tuple(_VGG_CFG["E"]), batch_norm=True)),
    "densenet121": dict(cls=DenseNetEncoder, kw=dict(block_layers=(6, 12, 24, 16))),
    "densenet169": dict(cls=DenseNetEncoder, kw=dict(block_layers=(6, 12, 32, 32))),
    "densenet201": dict(cls=DenseNetEncoder, kw=dict(block_layers=(6, 12, 48, 32))),
    "densenet161": dict(cls=DenseNetEncoder,
                        kw=dict(block_layers=(6, 12, 36, 24), growth=48, init_channels=96)),
    "mobilenet_v2": dict(cls=MobileNetV2Encoder, kw=dict()),
}

# The one surface with no architecture behind it: the tu- TimmUniversalEncoder
# (timm's whole pretrained registry). A tu- name that resolves to a ported
# architecture builds it (`encoders._resolve_tu_alias`).
GATED_FAMILIES = ("tu-",)


# ---------------------------------------------------------------------------
# EfficientNet (efficientnet.py stage contract)
# ---------------------------------------------------------------------------

def _round_filters(c: int, width_mult: float, divisor: int = 8) -> int:
    c *= width_mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def _round_repeats(n: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * n))


class _MBConv(nn.Module):
    """MBConv: expand 1x1 -> depthwise kxk (stride s) -> SE (a quarter of
    the block's input channels) -> project 1x1, swish activations, residual
    when the original stride is 1 and the widths match. No drop-connect,
    as in senas_tpu. `lite`: relu6 and no SE (timm tf_efficientnet_lite*).
    `dilation` > 1: a dilated stage (depthwise dilated, stride 1)."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, expand: int,
                 lite: bool = False, dilation: int = 1, dtype=None):
        super().__init__()
        self.stride, self.expand, self.lite, self.dilation = stride, expand, lite, dilation
        self.residual = stride == 1 and c_in == c_out
        hidden = c_in * expand
        if expand != 1:
            add_conv_kernel(self, "expand_conv", (hidden, c_in, 1, 1))
            self.expand_bn = BatchNorm(hidden, dtype=dtype)
        add_conv_kernel(self, "dw_conv", (hidden, 1, kernel, kernel))
        self.dw_bn = BatchNorm(hidden, dtype=dtype)
        if not lite:
            se_c = max(1, c_in // 4)
            # flax Dense-style (I, O) kernels, kaiming over the fan-out
            add_kernel(self, "se_reduce", (hidden, se_c), kaiming_std(se_c))
            add_bias(self, "se_reduce_b", se_c)
            add_kernel(self, "se_expand", (se_c, hidden), kaiming_std(hidden))
            add_bias(self, "se_expand_b", hidden)
        add_conv_kernel(self, "project_conv", (c_out, hidden, 1, 1))
        self.project_bn = BatchNorm(c_out, dtype=dtype)

    def _act(self, y):
        return relu6(y) if self.lite else swish(y)

    def forward(self, x, train: bool = False):
        y = x
        if self.expand != 1:
            y = self._act(self.expand_bn(conv2d(y, self.expand_conv.to(y.dtype)), train))
        y = conv2d(y, self.dw_conv.to(y.dtype), stride=1 if self.dilation > 1 else self.stride,
                   groups=self.dw_conv.shape[0], dilation=self.dilation)
        y = self._act(self.dw_bn(y, train))
        if not self.lite:
            s = image_mean(y)
            s = swish(s @ self.se_reduce.to(s.dtype) + self.se_reduce_b.to(s.dtype))
            s = sigmoid(s @ self.se_expand.to(s.dtype) + self.se_expand_b.to(s.dtype))
            y = y * s[:, :, None, None]
        y = self.project_bn(conv2d(y, self.project_conv.to(y.dtype)), train)
        return x + y if self.residual else y


# base (t expand, c channels, n repeats, k kernel, s stride): EfficientNet-B0
_EFFNET_PLAN = [(1, 16, 1, 3, 1), (6, 24, 2, 3, 2), (6, 40, 2, 5, 2),
                (6, 80, 3, 3, 2), (6, 112, 3, 5, 1), (6, 192, 4, 5, 2),
                (6, 320, 1, 3, 1)]
# the pyramid taps after these plan groups -> levels 2..5
_EFFNET_STAGE_AFTER = {1: 2, 2: 3, 4: 4, 6: 5}
# the pyramid stage of each plan group (efficientnet.py stage_idxs)
_EFFNET_GROUP_STAGE = {0: 2, 1: 2, 2: 3, 3: 4, 4: 4, 5: 5, 6: 5}


class EfficientNetEncoder(nn.Module):
    """EfficientNet-B* feature pyramid: f1 = the stem (stride 2), then taps
    after the c24 / c40 / c112 / c320 block groups (efficientnet.py:45-53,
    110-129). `lite` builds EfficientNet-Lite as smp's timm wrapper does
    (timm_efficientnet.py:53-91): relu6, no SE, the stem fixed at 32
    channels, the first and last groups' repeats not scaled."""

    def __init__(self, in_channels: int, width_mult: float = 1.0, depth_mult: float = 1.0,
                 depth: int = 5, lite: bool = False, output_stride: int = 32, dtype=None):
        super().__init__()
        self.depth, self.lite, self.dtype = depth, lite, dtype
        maps = 1   # the maps the forward returns so far
        self.groups_run: List[Tuple[List[str], bool]] = []
        if depth > 0:
            stem_c = 32 if lite else _round_filters(32, width_mult)
            add_conv_kernel(self, "stem_conv", (stem_c, in_channels, 3, 3))
            self.stem_bn = BatchNorm(stem_c, dtype=dtype)
            maps += 1
            c = stem_c
            last_pi = len(_EFFNET_PLAN) - 1
            for pi, (t, c_base, n, k, s) in enumerate(_EFFNET_PLAN):
                c_out = _round_filters(c_base, width_mult)
                n_rep = n if lite and pi in (0, last_pi) else _round_repeats(n, depth_mult)
                rate = stage_dilation(_EFFNET_GROUP_STAGE[pi], output_stride)
                names = []
                for r in range(n_rep):
                    setattr(self, f"block{pi}_{r}", _MBConv(
                        c, c_out, k, s if r == 0 else 1, t, lite=lite, dilation=rate,
                        dtype=dtype))
                    names.append(f"block{pi}_{r}")
                    c = c_out
                tap = pi in _EFFNET_STAGE_AFTER
                self.groups_run.append((names, tap))
                if tap:
                    maps += 1
                    if maps > depth:
                        break

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        act = relu6 if self.lite else swish
        x = cast(x, self.dtype)
        x = act(self.stem_bn(conv2d(x, self.stem_conv.to(x.dtype), stride=2), train))
        features.append(x)
        for names, tap in self.groups_run:
            for name in names:
                x = getattr(self, name)(x, train)
            if tap:
                features.append(x)
        return features[:self.depth + 1]


_EFFNET_SCALES = {"b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
                  "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1)}
# (width_mult, depth_mult) of the compound-scaling table; smp ships b0..b7
# (efficientnet.py:106-177)
EXTRA_ENCODERS.update({
    f"efficientnet-{k}": dict(cls=EfficientNetEncoder, kw=dict(width_mult=wm, depth_mult=dm))
    for k, (wm, dm) in _EFFNET_SCALES.items()})
# timm-efficientnet-* is the same architecture through timm's model factory
# (pretrained provenance and BN eps differ, both moot without weights);
# smp adds b8 and l2 there and the tf_efficientnet_lite family
# (timm_efficientnet.py:156-383)
EXTRA_ENCODERS.update({
    f"timm-efficientnet-{k}": dict(cls=EfficientNetEncoder, kw=dict(width_mult=wm, depth_mult=dm))
    for k, (wm, dm) in {**_EFFNET_SCALES, "b8": (2.2, 3.6), "l2": (4.3, 5.3)}.items()})
EXTRA_ENCODERS.update({
    f"timm-tf_efficientnet_lite{i}": dict(
        cls=EfficientNetEncoder, kw=dict(width_mult=wm, depth_mult=dm, lite=True))
    for i, (wm, dm) in enumerate([(1.0, 1.0), (1.0, 1.1), (1.1, 1.2), (1.2, 1.4), (1.4, 1.8)])})
