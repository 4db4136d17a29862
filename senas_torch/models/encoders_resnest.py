"""ResNeSt encoders of the baseline zoo in PyTorch (NCHW inside).

Port of `senas_tpu/models/encoders_resnest.py`, the reference's
`timm-resnest*` encoders (smp encoders/timm_resnest.py:89-209 lists the
variants; blocks follow timm.models.resnest's ResNestBottleneck and
SplitAttn):

  * deep stem (3x3 s2 -> 3x3 -> 3x3 to 2*stem_width) + maxpool
  * ResNestBottleneck: 1x1 -> SplitAttn 3x3 (radix-grouped conv + radix
    softmax attention) -> 1x1, with the average-pool downsampling (avd)
    and average-pool shortcut projections (avg_down)
  * smp's stage contract: [identity, stem, maxpool+layer1, layer2-4]

As in timm (and senas_tpu), avd applies only where the stride is above 1,
so layer1's first block has no smoothing pool.
"""

from __future__ import annotations

from typing import List, Sequence

from torch import nn

from senas_torch.models.encoders_families import ConvBnAct, _conv, _max_pool
from senas_torch.ops.primitives import (BatchNorm, add_conv_kernel, avg_pool, image_mean,
                                        relu, sigmoid, softmax)
from senas_torch.parallel.collectives import whole_maps


def _avg_pool(x, k: int, stride: int, pad: int):
    """AvgPool2d(k, stride, padding=pad, count_include_pad=False)."""
    return avg_pool(x, k, stride, pad, count_include_pad=False)


class SplitAttn(nn.Module):
    """timm SplitAttn: radix-grouped 3x3 conv + radix-softmax attention. The
    conv's channels are radix-major ([R, C]), as NCHW's flatten orders them;
    the attention's BatchNorm normalises [B, attn, 1, 1] maps. Under a row
    split the gap is the global image's mean, and its fc1 -> bn1 -> fc2
    chain a map every spatial rank computes whole (`whole_maps`: bn1 over
    the data subgroup, each image counted once)."""

    def __init__(self, c_in: int, c_out: int, radix: int = 2, cardinality: int = 1,
                 stride: int = 1, dtype=None):
        super().__init__()
        R, G, C = radix, cardinality, c_out
        self.radix, self.cardinality, self.c_out = R, G, C
        mid = C * R
        self.conv = ConvBnAct(c_in, mid, 3, stride=stride, groups=G * R, dtype=dtype)
        # the attention bottleneck: max(C*R//4 rounded to /8, 32) (timm
        # make_divisible)
        attn_chs = max(32, (C * R // 4 + 4) // 8 * 8)
        add_conv_kernel(self, "fc1", (attn_chs, C // G, 1, 1))
        self.bn1 = BatchNorm(attn_chs, dtype=dtype)
        add_conv_kernel(self, "fc2", (mid, attn_chs // G, 1, 1))

    def forward(self, x, train: bool = False):
        R, G, C = self.radix, self.cardinality, self.c_out
        x = self.conv(x, train)
        b, _, h, w = x.shape
        gap = x.view(b, R, C, h, w).sum(dim=1) if R > 1 else x
        gap = image_mean(gap)[:, :, None, None]   # [b, C, 1, 1]
        with whole_maps():
            gap = _conv(gap, self.fc1, groups=G, padding=(0, 0))
            gap = relu(self.bn1(gap, train))
            attn = _conv(gap, self.fc2, groups=G, padding=(0, 0))
        if R > 1:
            # RadixSoftmax: over the radix axis within each cardinal group
            attn = softmax(attn.view(b, R, G, C // G), dim=1)
            return (x.view(b, R, C, h, w) * attn.reshape(b, R, C, 1, 1)).sum(dim=1)
        return x * sigmoid(attn)


class ResNestBottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, planes: int, stride: int = 1, radix: int = 2,
                 cardinality: int = 1, base_width: int = 64, avd: bool = True,
                 avd_first: bool = False, use_downsample: bool = False, avg_down: bool = True,
                 dtype=None):
        super().__init__()
        group_width = int(planes * (base_width / 64.0)) * cardinality
        self.avd_stride = stride if (avd and stride > 1) else 0
        self.avd_first, self.stride, self.avg_down = avd_first, stride, avg_down
        conv2_stride = 1 if self.avd_stride > 0 else stride
        out = planes * self.expansion
        self.conv1 = ConvBnAct(c_in, group_width, 1, padding=(0, 0), dtype=dtype)
        if radix >= 1:
            self.conv2 = SplitAttn(group_width, group_width, radix=radix,
                                   cardinality=cardinality, stride=conv2_stride, dtype=dtype)
        else:
            self.conv2 = ConvBnAct(group_width, group_width, 3, stride=conv2_stride,
                                   groups=cardinality, dtype=dtype)
        self.conv3 = ConvBnAct(group_width, out, 1, padding=(0, 0), act=False, dtype=dtype)
        if use_downsample:
            self.downsample = ConvBnAct(c_in, out, 1, padding=(0, 0), act=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        out = self.conv1(x, train)
        if self.avd_stride > 0 and self.avd_first:
            out = _avg_pool(out, 3, self.avd_stride, 1)
        out = self.conv2(out, train)
        if self.avd_stride > 0 and not self.avd_first:
            out = _avg_pool(out, 3, self.avd_stride, 1)
        out = self.conv3(out, train)
        residual = x
        if hasattr(self, "downsample"):
            r = x
            if self.avg_down and self.stride > 1:
                r = _avg_pool(r, 2, self.stride, 0)
            residual = self.downsample(r, train)
        return relu(out + residual)


class ResNestEncoder(nn.Module):
    def __init__(self, in_channels: int, layers: Sequence[int], depth: int = 5,
                 stem_width: int = 32, radix: int = 2, cardinality: int = 1,
                 base_width: int = 64, avd_first: bool = False, dtype=None):
        super().__init__()
        self.depth = depth
        maps = 1   # the maps the forward returns so far
        self.stage_blocks: List[List[str]] = []
        if depth > 0:
            self.stem0 = ConvBnAct(in_channels, stem_width, 3, stride=2, dtype=dtype)
            self.stem1 = ConvBnAct(stem_width, stem_width, 3, dtype=dtype)
            self.stem2 = ConvBnAct(stem_width, stem_width * 2, 3, dtype=dtype)
            c = stem_width * 2
            maps += 1
            planes = (64, 128, 256, 512)
            for li, n_blocks in enumerate(layers):
                if maps > depth:
                    break
                names = []
                for bi in range(n_blocks):
                    stride = 2 if (li > 0 and bi == 0) else 1
                    name = f"layer{li + 1}_{bi}"
                    setattr(self, name, ResNestBottleneck(
                        c, planes[li], stride=stride, radix=radix, cardinality=cardinality,
                        base_width=base_width, avd_first=avd_first,
                        use_downsample=stride != 1 or c != planes[li] * 4, dtype=dtype))
                    names.append(name)
                    c = planes[li] * 4
                self.stage_blocks.append(names)
                maps += 1

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        x = self.stem2(self.stem1(self.stem0(x, train), train), train)
        features.append(x)
        for li, names in enumerate(self.stage_blocks):
            if li == 0:
                x = _max_pool(x, 3, 2, 1)
            for name in names:
                x = getattr(self, name)(x, train)
            features.append(x)
        return features[:self.depth + 1]


# the variants of timm_resnest.py:89-209
RESNEST_ENCODERS = {
    "timm-resnest14d": dict(cls=ResNestEncoder, kw=dict(layers=(1, 1, 1, 1), stem_width=32)),
    "timm-resnest26d": dict(cls=ResNestEncoder, kw=dict(layers=(2, 2, 2, 2), stem_width=32)),
    "timm-resnest50d": dict(cls=ResNestEncoder, kw=dict(layers=(3, 4, 6, 3), stem_width=32)),
    "timm-resnest101e": dict(cls=ResNestEncoder, kw=dict(layers=(3, 4, 23, 3), stem_width=64)),
    "timm-resnest200e": dict(cls=ResNestEncoder, kw=dict(layers=(3, 24, 36, 3), stem_width=64)),
    "timm-resnest269e": dict(cls=ResNestEncoder, kw=dict(layers=(3, 30, 48, 8), stem_width=64)),
    "timm-resnest50d_4s2x40d": dict(cls=ResNestEncoder, kw=dict(
        layers=(3, 4, 6, 3), stem_width=32, radix=4, cardinality=2, base_width=40,
        avd_first=True)),
    "timm-resnest50d_1s4x24d": dict(cls=ResNestEncoder, kw=dict(
        layers=(3, 4, 6, 3), stem_width=32, radix=1, cardinality=4, base_width=24,
        avd_first=True)),
}
