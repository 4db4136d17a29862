"""Res2Net, RegNet X/Y, SK-Net and GERNet encoders of the baseline zoo in
PyTorch (NCHW inside).

Port of `senas_tpu/models/encoders_timm2.py`, the reference's timm-backed
residual variants (smp encoders/timm_{res2net,regnet,sknet,gernet}.py):

  * Res2Net: timm's Bottle2neck (hierarchical splits of the 3x3 stage; the
    last split average-pooled, padding counted, where the block is
    "first"); no dilated mode
  * RegNet X/Y: the quantised linear stage widths (`regnet_stage_widths`)
    and the group-conv bottleneck, Y with a squeeze-excite over the
    block's input width
  * SK-Net: selective-kernel blocks (two 3x3 paths at dilations 1 and 2,
    a softmax attention over the paths) whose attention BatchNorm is
    flax's `nn.BatchNorm` (`FlaxBatchNorm`), not the package's
  * GERNet: timm's ByobNet basic and bottle blocks; pyramid stage 5 folds
    byob stages 3 and 4 and the final 1x1 conv

`dtype` is the compute dtype, as in senas_tpu: every BatchNorm rounds its
output to it, a conv runs in its input's dtype (the stem's in the
image's) with its f32 kernel cast at use, and the SE and SK weights are
cast to the activations' dtype.

Under the mesh's row split every conv and pool is its row-shard form
(through `primitives`); the SE and SK means span the global image
(`image_mean`), and the squeeze's 1x1 convs (and SK's attention
BatchNorm) act on a map every spatial rank computes whole
(`collectives.whole_maps`: that BatchNorm reduces over the data
subgroup).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from senas_torch.models.encoders import stage_dilation
from senas_torch.models.encoders_families import ConvBnAct, _conv, _max_pool
from senas_torch.ops.primitives import (EPS, add_bias, add_conv_kernel, avg_pool, image_mean,
                                        relu, sigmoid, softmax)
from senas_torch.parallel.collectives import (active_mesh, all_reduce_sum, global_count,
                                              whole_maps)


# ---------------------------------------------------------------------------
# Res2Net (timm Bottle2neck)
# ---------------------------------------------------------------------------

def _avg_pool_incl(x, k: int, stride: int, pad: int):
    """AvgPool2d(k, stride, padding=pad) with count_include_pad=True (the
    torch default, which timm's Bottle2neck pool uses): a border window
    divides by k*k."""
    return avg_pool(x, k, stride, pad, count_include_pad=True)


class Bottle2neck(nn.Module):
    """1x1 -> `scale` splits, each but the last through a 3x3 (grouped by
    `cardinality`) fed by its split plus the previous 3x3's output -> 1x1.
    A "first" block (stride above 1 or a downsample, so layer1's first
    too) feeds each 3x3 its split alone and pools the last split."""

    expansion = 4

    def __init__(self, c_in: int, planes: int, stride: int = 1, cardinality: int = 1,
                 base_width: int = 26, scale: int = 4, use_downsample: bool = False,
                 dtype=None):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0))) * cardinality
        self.width, self.scale, self.stride = width, scale, stride
        self.is_first = stride > 1 or use_downsample
        self.num_scales = max(1, scale - 1)
        out = planes * self.expansion
        self.conv1 = ConvBnAct(c_in, width * scale, 1, padding=(0, 0), dtype=dtype)
        for i in range(self.num_scales):
            setattr(self, f"conv2_{i}", ConvBnAct(width, width, 3, stride=stride,
                                                  groups=cardinality, dtype=dtype))
        self.conv3 = ConvBnAct(width * scale, out, 1, padding=(0, 0), act=False, dtype=dtype)
        if use_downsample:
            self.downsample = ConvBnAct(c_in, out, 1, stride=stride, padding=(0, 0), act=False,
                                        dtype=dtype)

    def forward(self, x, train: bool = False):
        out = self.conv1(x, train)
        splits = torch.split(out, self.width, dim=1)
        spo = []
        sp = splits[0]
        for i in range(self.num_scales):
            sp = splits[i] if i == 0 or self.is_first else sp + splits[i]
            sp = getattr(self, f"conv2_{i}")(sp, train)
            spo.append(sp)
        if self.scale > 1:
            spo.append(_avg_pool_incl(splits[-1], 3, self.stride, 1) if self.is_first
                       else splits[-1])
        out = self.conv3(torch.cat(spo, dim=1), train)
        residual = self.downsample(x, train) if hasattr(self, "downsample") else x
        return relu(out + residual)


class Res2NetEncoder(nn.Module):
    """timm's ResNet of Bottle2neck blocks on smp's stage contract
    (timm_res2net.py): [identity, 7x7 stem, maxpool + layer1, layer2-4]."""

    def __init__(self, in_channels: int, layers: Sequence[int], depth: int = 5,
                 base_width: int = 26, scale: int = 4, cardinality: int = 1, dtype=None):
        super().__init__()
        self.depth = depth
        self.stage_blocks: List[List[str]] = []
        if depth == 0:
            return
        self.stem = ConvBnAct(in_channels, 64, 7, stride=2, dtype=dtype)
        c, planes = 64, (64, 128, 256, 512)
        for li, n_blocks in enumerate(layers):
            if len(self.stage_blocks) + 2 > depth:
                break
            names = []
            for bi in range(n_blocks):
                stride = 2 if (li > 0 and bi == 0) else 1
                name = f"layer{li + 1}_{bi}"
                setattr(self, name, Bottle2neck(
                    c, planes[li], stride=stride, cardinality=cardinality,
                    base_width=base_width, scale=scale,
                    use_downsample=stride != 1 or c != planes[li] * 4, dtype=dtype))
                names.append(name)
                c = planes[li] * 4
            self.stage_blocks.append(names)

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        x = self.stem(x, train)
        features.append(x)
        for li, names in enumerate(self.stage_blocks):
            if li == 0:
                x = _max_pool(x, 3, 2, 1)
            for name in names:
                x = getattr(self, name)(x, train)
            features.append(x)
        return features[:self.depth + 1]


RES2NET_ENCODERS = {
    "timm-res2net50_26w_4s": dict(cls=Res2NetEncoder, kw=dict(
        layers=(3, 4, 6, 3), base_width=26, scale=4)),
    "timm-res2net101_26w_4s": dict(cls=Res2NetEncoder, kw=dict(
        layers=(3, 4, 23, 3), base_width=26, scale=4)),
    "timm-res2net50_26w_6s": dict(cls=Res2NetEncoder, kw=dict(
        layers=(3, 4, 6, 3), base_width=26, scale=6)),
    "timm-res2net50_26w_8s": dict(cls=Res2NetEncoder, kw=dict(
        layers=(3, 4, 6, 3), base_width=26, scale=8)),
    "timm-res2net50_48w_2s": dict(cls=Res2NetEncoder, kw=dict(
        layers=(3, 4, 6, 3), base_width=48, scale=2)),
    "timm-res2net50_14w_8s": dict(cls=Res2NetEncoder, kw=dict(
        layers=(3, 4, 6, 3), base_width=14, scale=8)),
    "timm-res2next50": dict(cls=Res2NetEncoder, kw=dict(
        layers=(3, 4, 6, 3), base_width=4, scale=4, cardinality=8)),
}


# ---------------------------------------------------------------------------
# RegNet (timm regnet.py: quantized linear widths + X/Y blocks)
# ---------------------------------------------------------------------------

def regnet_stage_widths(w0: float, wa: float, wm: float, depth: int,
                        group_w: int, bottle_ratio: float = 1.0,
                        q: int = 8):
    """generate_regnet + adjust_widths_groups_comp (timm regnet.py):
    per-stage (width, n_blocks, group_width) tuples. `np.round` and
    Python's `round` both round half to even."""
    widths_cont = np.arange(depth) * wa + w0
    width_exps = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = w0 * np.power(wm, width_exps)
    widths = (np.round(widths / q) * q).astype(int)
    stage_widths, stage_depths = np.unique(widths, return_counts=True)
    # adjust for group-width compatibility
    out = []
    for w, d in zip(stage_widths.tolist(), stage_depths.tolist()):
        w_bot = int(round(w * bottle_ratio))
        g = min(group_w, w_bot)
        w_bot = int(round(w_bot / g) * g)
        w = int(w_bot / bottle_ratio)
        out.append((w, int(d), g))
    return out


class RegNetBlock(nn.Module):
    """timm's RegNet bottleneck: 1x1 -> 3x3 in groups of `group_width`
    (+ SE, Y variants) -> 1x1, ReLU after the residual add. `dilation` > 1:
    a dilated stage, every conv at stride 1 with that dilation (smp
    encoders/_utils.py:48-60); the downsample keeps to the nominal stride's
    test, so it is there at stride 1 too."""

    def __init__(self, c_in: int, w_out: int, stride: int = 1, group_width: int = 8,
                 bottle_ratio: float = 1.0, se_ratio: float = 0.0, dilation: int = 1,
                 dtype=None):
        super().__init__()
        w_b = int(round(w_out * bottle_ratio))
        eff_stride = 1 if dilation > 1 else stride
        self.se = se_ratio > 0
        self.conv1 = ConvBnAct(c_in, w_b, 1, padding=(0, 0), dtype=dtype)
        self.conv2 = ConvBnAct(w_b, w_b, 3, stride=eff_stride, groups=w_b // group_width,
                               dilation=dilation, dtype=dtype)
        if self.se:
            # the squeeze on the block's INPUT width (timm: rd_channels
            # from in_chs)
            rd = int(round(c_in * se_ratio))
            add_conv_kernel(self, "se_fc1", (rd, w_b, 1, 1))
            add_bias(self, "se_b1", rd)
            add_conv_kernel(self, "se_fc2", (w_b, rd, 1, 1))
            add_bias(self, "se_b2", w_b)
        self.conv3 = ConvBnAct(w_b, w_out, 1, padding=(0, 0), act=False, dtype=dtype)
        if stride != 1 or c_in != w_out:
            self.downsample = ConvBnAct(c_in, w_out, 1, stride=eff_stride, padding=(0, 0),
                                        act=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        out = self.conv2(self.conv1(x, train), train)
        if self.se:
            y = image_mean(out)[:, :, None, None]
            with whole_maps():
                y = relu(_conv(y, self.se_fc1, padding=(0, 0))
                         + self.se_b1.to(y.dtype)[:, None, None])
                y = sigmoid(_conv(y, self.se_fc2, padding=(0, 0))
                            + self.se_b2.to(y.dtype)[:, None, None])
            out = out * y
        out = self.conv3(out, train)
        residual = self.downsample(x, train) if hasattr(self, "downsample") else x
        return relu(out + residual)


class RegNetEncoder(nn.Module):
    """smp's RegNetEncoder stage contract (timm_regnet.py): [identity,
    stem (3x3 s2 -> 32), s1, s2, s3, s4], each stage's first block at
    stride 2."""

    def __init__(self, in_channels: int, w0: float, wa: float, wm: float, net_depth: int,
                 group_w: int, se_ratio: float = 0.0, bottle_ratio: float = 1.0,
                 stem_width: int = 32, depth: int = 5, output_stride: int = 32, dtype=None):
        super().__init__()
        self.depth = depth
        self.stage_blocks: List[List[str]] = []
        if depth == 0:
            return
        self.stem = ConvBnAct(in_channels, stem_width, 3, stride=2, dtype=dtype)
        c = stem_width
        stages = regnet_stage_widths(w0, wa, wm, net_depth, group_w, bottle_ratio)
        for si, (w, d, g) in enumerate(stages):
            if len(self.stage_blocks) + 2 > depth:
                break
            rate = stage_dilation(si + 2, output_stride)
            names = []
            for bi in range(d):
                name = f"s{si + 1}_b{bi}"
                setattr(self, name, RegNetBlock(
                    c, w, stride=2 if bi == 0 else 1, group_width=g, bottle_ratio=bottle_ratio,
                    se_ratio=se_ratio, dilation=rate, dtype=dtype))
                names.append(name)
                c = w
            self.stage_blocks.append(names)

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        x = self.stem(x, train)
        features.append(x)
        for names in self.stage_blocks:
            for name in names:
                x = getattr(self, name)(x, train)
            features.append(x)
        return features[:self.depth + 1]


def _regnet(w0, wa, wm, depth, group_w, se=0.0):
    return dict(cls=RegNetEncoder, kw=dict(w0=w0, wa=wa, wm=wm, net_depth=depth,
                                           group_w=group_w, se_ratio=se))


# variant table: timm_regnet.py:140-340 (X = no SE, Y = se_ratio 0.25)
REGNET_ENCODERS = {
    "timm-regnetx_002": _regnet(24, 36.44, 2.49, 13, 8),
    "timm-regnetx_004": _regnet(24, 24.48, 2.54, 22, 16),
    "timm-regnetx_006": _regnet(48, 36.97, 2.24, 16, 24),
    "timm-regnetx_008": _regnet(56, 35.73, 2.28, 16, 16),
    "timm-regnetx_016": _regnet(80, 34.01, 2.25, 18, 24),
    "timm-regnetx_032": _regnet(88, 26.31, 2.25, 25, 48),
    "timm-regnetx_040": _regnet(96, 38.65, 2.43, 23, 40),
    "timm-regnetx_064": _regnet(184, 60.83, 2.07, 17, 56),
    "timm-regnetx_080": _regnet(80, 49.56, 2.88, 23, 120),
    "timm-regnetx_120": _regnet(168, 73.36, 2.37, 19, 112),
    "timm-regnetx_160": _regnet(216, 55.59, 2.1, 22, 128),
    "timm-regnetx_320": _regnet(320, 69.86, 2.0, 23, 168),
    "timm-regnety_002": _regnet(24, 36.44, 2.49, 13, 8, se=0.25),
    "timm-regnety_004": _regnet(48, 27.89, 2.09, 16, 8, se=0.25),
    "timm-regnety_006": _regnet(48, 32.54, 2.32, 15, 16, se=0.25),
    "timm-regnety_008": _regnet(56, 38.84, 2.4, 14, 16, se=0.25),
    "timm-regnety_016": _regnet(48, 20.71, 2.65, 27, 24, se=0.25),
    "timm-regnety_032": _regnet(80, 42.63, 2.66, 21, 24, se=0.25),
    "timm-regnety_040": _regnet(96, 31.41, 2.24, 22, 64, se=0.25),
    "timm-regnety_064": _regnet(112, 33.22, 2.27, 25, 72, se=0.25),
    "timm-regnety_080": _regnet(192, 76.82, 2.19, 17, 56, se=0.25),
    "timm-regnety_120": _regnet(168, 73.36, 2.37, 19, 112, se=0.25),
    "timm-regnety_160": _regnet(200, 106.23, 2.48, 18, 112, se=0.25),
    "timm-regnety_320": _regnet(232, 115.89, 2.53, 20, 232, se=0.25),
}


# ---------------------------------------------------------------------------
# SK-Net (timm selective_kernel.py: SelectiveKernel + path attention)
# ---------------------------------------------------------------------------

def _make_divisible(v: float, divisor: int = 8) -> int:
    return max(divisor, int(v + divisor / 2) // divisor * divisor)


class FlaxBatchNorm(nn.Module):
    """flax.linen's `nn.BatchNorm` (flax 0.12.3) over the channels of an
    NCHW map, as senas_tpu's SK attention uses it. Its rules are flax's,
    not torch's (`primitives.BatchNorm`): train mode normalises by the
    BIASED batch variance E[x^2] - E[x]^2 clipped at 0 (use_fast_variance),
    the statistics in at least f32, and moves the running stats by
    running <- 0.99 running + 0.01 batch, the biased variance too; eps
    1e-5. The output is (x - mean) * (rsqrt(var + eps) * scale) + bias,
    rounded once to `dtype` (None: x's dtype promoted with the
    parameters'). Variables: parameters `scale`, `bias`; buffers `mean`,
    `var`. It is not a `primitives.BatchNorm`, so `SENAS_PALLAS_BN` never
    routes it through the epilogue's kernels, as in senas_tpu. Under an
    active mesh (`senas_torch.parallel`) E[x] and E[x^2] are the global
    batch's."""

    def __init__(self, c: int, momentum: float = 0.99, eps: float = EPS, dtype=None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, train: bool = False):
        ct = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(ct)
        if train and active_mesh() is not None:
            # the global batch's E[x] and E[x^2]: both sums in one collective
            count = global_count(x)
            sums = all_reduce_sum(torch.stack([xs.sum(dim=(0, 2, 3)),
                                               (xs * xs).sum(dim=(0, 2, 3))])) / count
            mu = sums[0]
            var = torch.clamp_min(sums[1] - mu * mu, 0.0)
        elif train:
            mu = xs.mean(dim=(0, 2, 3))
            var = torch.clamp_min((xs * xs).mean(dim=(0, 2, 3)) - mu * mu, 0.0)
        if train:
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mu.to(self.mean.dtype))
                self.var.copy_(m * self.var + (1 - m) * var.to(self.var.dtype))
        else:
            mu, var = self.mean.to(ct), self.var.to(ct)
        mul = torch.rsqrt(var + self.eps) * self.scale.to(ct)
        y = (xs - mu[:, None, None]) * mul[:, None, None] + self.bias.to(ct)[:, None, None]
        return y.to(self.dtype or torch.promote_types(x.dtype, self.scale.dtype))


class SelectiveKernel(nn.Module):
    """Two 3x3 paths (dilations 1 and 2: timm's keep_3x3 folding of the
    [3, 5] kernel pair), each on one half of the input's channels
    (split_input), and a softmax attention over the paths from a shared
    squeeze. `dilation` > 1: a dilated stage, where the reference
    sets BOTH paths to the stage's dilation (replace_strides_with_dilation
    sets every Conv2d), at stride 1; kept."""

    n_paths = 2

    def __init__(self, c_in: int, c_out: int, stride: int = 1, groups: int = 1,
                 rd_ratio: float = 1.0 / 16, dilation: int = 1, dtype=None):
        super().__init__()
        self.c_out, self.split = c_out, c_in // self.n_paths
        path_dil = (1, 2) if dilation == 1 else (dilation,) * 2
        eff_stride = 1 if dilation > 1 else stride
        for i, (ci, d) in enumerate(zip((self.split, c_in - self.split), path_dil)):
            setattr(self, f"path{i}", ConvBnAct(ci, c_out, 3, stride=eff_stride, groups=groups,
                                                dilation=d, dtype=dtype))
        attn_chs = _make_divisible(c_out * rd_ratio)
        add_conv_kernel(self, "fc_reduce", (attn_chs, c_out, 1, 1))
        self.attn_bn = FlaxBatchNorm(attn_chs, dtype=dtype)
        add_conv_kernel(self, "fc_select", (c_out * self.n_paths, attn_chs, 1, 1))

    def forward(self, x, train: bool = False):
        inputs = (x[:, :self.split], x[:, self.split:])
        paths = [getattr(self, f"path{i}")(xin, train) for i, xin in enumerate(inputs)]
        y = image_mean(paths[0] + paths[1])[:, :, None, None]     # [B, C, 1, 1]
        with whole_maps():
            y = relu(self.attn_bn(_conv(y, self.fc_reduce, padding=(0, 0)), train))
            y = _conv(y, self.fc_select, padding=(0, 0))
        y = softmax(y.view(y.shape[0], self.n_paths, self.c_out, 1, 1), dim=1)
        return paths[0] * y[:, 0] + paths[1] * y[:, 1]


class SelectiveKernelBasic(nn.Module):
    def __init__(self, c_in: int, planes: int, stride: int = 1, rd_ratio: float = 1.0 / 8,
                 use_downsample: bool = False, dilation: int = 1, dtype=None):
        super().__init__()
        eff_stride = 1 if dilation > 1 else stride
        self.conv1 = SelectiveKernel(c_in, planes, stride=stride, rd_ratio=rd_ratio,
                                     dilation=dilation, dtype=dtype)
        self.conv2 = ConvBnAct(planes, planes, 3, act=False, dilation=dilation, dtype=dtype)
        if use_downsample:
            self.downsample = ConvBnAct(c_in, planes, 1, stride=eff_stride, padding=(0, 0),
                                        act=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        out = self.conv2(relu(self.conv1(x, train)), train)
        residual = self.downsample(x, train) if hasattr(self, "downsample") else x
        return relu(out + residual)


class SelectiveKernelBottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, planes: int, stride: int = 1, cardinality: int = 32,
                 base_width: int = 4, use_downsample: bool = False, dilation: int = 1,
                 dtype=None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * cardinality
        eff_stride = 1 if dilation > 1 else stride
        out = planes * self.expansion
        self.conv1 = ConvBnAct(c_in, width, 1, padding=(0, 0), dtype=dtype)
        self.conv2 = SelectiveKernel(width, width, stride=stride, groups=cardinality,
                                     dilation=dilation, dtype=dtype)
        self.conv3 = ConvBnAct(width, out, 1, padding=(0, 0), act=False, dtype=dtype)
        if use_downsample:
            self.downsample = ConvBnAct(c_in, out, 1, stride=eff_stride, padding=(0, 0),
                                        act=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        out = self.conv3(relu(self.conv2(self.conv1(x, train), train)), train)
        residual = self.downsample(x, train) if hasattr(self, "downsample") else x
        return relu(out + residual)


class SkNetEncoder(nn.Module):
    """timm's ResNet of selective-kernel blocks on smp's stage contract
    (timm_sknet.py): [identity, 7x7 stem, maxpool + layer1, layer2-4]."""

    def __init__(self, in_channels: int, layers: Sequence[int], block: str = "basic",
                 depth: int = 5, cardinality: int = 32, base_width: int = 4,
                 output_stride: int = 32, dtype=None):
        super().__init__()
        self.depth = depth
        self.stage_blocks: List[List[str]] = []
        if depth == 0:
            return
        self.stem = ConvBnAct(in_channels, 64, 7, stride=2, dtype=dtype)
        c, planes = 64, (64, 128, 256, 512)
        for li, n_blocks in enumerate(layers):
            if len(self.stage_blocks) + 2 > depth:
                break
            rate = stage_dilation(li + 2, output_stride)
            names = []
            for bi in range(n_blocks):
                stride = 2 if (li > 0 and bi == 0) else 1
                name = f"layer{li + 1}_{bi}"
                if block == "basic":
                    out = planes[li]
                    blk = SelectiveKernelBasic(c, planes[li], stride=stride,
                                               use_downsample=stride != 1 or c != out,
                                               dilation=rate, dtype=dtype)
                else:
                    out = planes[li] * 4
                    blk = SelectiveKernelBottleneck(c, planes[li], stride=stride,
                                                    cardinality=cardinality,
                                                    base_width=base_width,
                                                    use_downsample=stride != 1 or c != out,
                                                    dilation=rate, dtype=dtype)
                setattr(self, name, blk)
                names.append(name)
                c = out
            self.stage_blocks.append(names)

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        x = self.stem(x, train)
        features.append(x)
        for li, names in enumerate(self.stage_blocks):
            if li == 0:
                x = _max_pool(x, 3, 2, 1)
            for name in names:
                x = getattr(self, name)(x, train)
            features.append(x)
        return features[:self.depth + 1]


SKNET_ENCODERS = {
    "timm-skresnet18": dict(cls=SkNetEncoder, kw=dict(
        layers=(2, 2, 2, 2), block="basic")),
    "timm-skresnet34": dict(cls=SkNetEncoder, kw=dict(
        layers=(3, 4, 6, 3), block="basic")),
    "timm-skresnext50_32x4d": dict(cls=SkNetEncoder, kw=dict(
        layers=(3, 4, 6, 3), block="bottleneck", cardinality=32,
        base_width=4)),
}


# ---------------------------------------------------------------------------
# GERNet (timm ByobNet: basic / bottle block configs, timm_gernet.py:67-140)
# ---------------------------------------------------------------------------

class ByoBasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int = 1, dilation: int = 1, dtype=None):
        super().__init__()
        eff_stride = 1 if dilation > 1 else stride
        self.conv1 = ConvBnAct(c_in, c_out, 3, stride=eff_stride, dilation=dilation, dtype=dtype)
        self.conv2 = ConvBnAct(c_out, c_out, 3, act=False, dilation=dilation, dtype=dtype)
        if stride != 1 or c_in != c_out:
            self.shortcut = ConvBnAct(c_in, c_out, 1, stride=eff_stride, padding=(0, 0),
                                      act=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        out = self.conv2(self.conv1(x, train), train)
        residual = self.shortcut(x, train) if hasattr(self, "shortcut") else x
        return relu(out + residual)


class ByoBottleBlock(nn.Module):
    """1x1 -> 3x3 (group_size 1: depthwise) -> 1x1 at the mid width
    `_make_divisible(c_out * bottle_ratio)` (inverted where the ratio is
    above 1)."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1, bottle_ratio: float = 1.0,
                 group_size: int = 0, dilation: int = 1, dtype=None):
        super().__init__()
        mid = _make_divisible(c_out * bottle_ratio)
        groups = mid // group_size if group_size else 1
        eff_stride = 1 if dilation > 1 else stride
        self.conv1 = ConvBnAct(c_in, mid, 1, padding=(0, 0), dtype=dtype)
        self.conv2 = ConvBnAct(mid, mid, 3, stride=eff_stride, groups=groups, dilation=dilation,
                               dtype=dtype)
        self.conv3 = ConvBnAct(mid, c_out, 1, padding=(0, 0), act=False, dtype=dtype)
        if stride != 1 or c_in != c_out:
            self.shortcut = ConvBnAct(c_in, c_out, 1, stride=eff_stride, padding=(0, 0),
                                      act=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        out = self.conv3(self.conv2(self.conv1(x, train), train), train)
        residual = self.shortcut(x, train) if hasattr(self, "shortcut") else x
        return relu(out + residual)


class GERNetEncoder(nn.Module):
    """smp's GERNetEncoder stage contract (timm_gernet.py:16-24): the last
    pyramid stage folds byob stages 3 and 4 and the final 1x1 conv. The
    final conv is built (and run, so that its running stats move in train
    mode) over whatever the last built stage leaves, at every depth above
    0, as in senas_tpu: its kernel's input width depends on the depth."""

    def __init__(self, in_channels: int, blocks: Sequence[Tuple], stem_chs: int,
                 num_features: int, depth: int = 5, output_stride: int = 32, dtype=None):
        super().__init__()
        self.depth = depth
        self.stage_blocks: List[List[str]] = []
        if depth == 0:
            return
        self.stem = ConvBnAct(in_channels, stem_chs, 3, stride=2, dtype=dtype)
        c, maps = stem_chs, 2
        for si, (btype, d, c_out, s, gs, br) in enumerate(blocks):
            if maps > depth:
                break
            # byob stages 3 and 4 (and the final 1x1) fold into pyramid stage 5
            rate = stage_dilation(min(si + 2, 5), output_stride)
            names = []
            for bi in range(d):
                stride = s if bi == 0 else 1
                name = f"s{si}_b{bi}"
                if btype == "basic":
                    blk = ByoBasicBlock(c, c_out, stride=stride, dilation=rate, dtype=dtype)
                else:
                    blk = ByoBottleBlock(c, c_out, stride=stride, bottle_ratio=br, group_size=gs,
                                         dilation=rate, dtype=dtype)
                setattr(self, name, blk)
                names.append(name)
                c = c_out
            self.stage_blocks.append(names)
            maps += si < 3
        self.final_conv = ConvBnAct(c, num_features, 1, padding=(0, 0), dtype=dtype)

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        x = self.stem(x, train)
        features.append(x)
        for si, names in enumerate(self.stage_blocks):
            for name in names:
                x = getattr(self, name)(x, train)
            if si < 3:
                features.append(x)
        features.append(self.final_conv(x, train))
        return features[:self.depth + 1]


GERNET_ENCODERS = {
    # (type, depth, channels, stride, group_size, bottle_ratio)
    "timm-gernet_s": dict(cls=GERNetEncoder, kw=dict(
        blocks=(("basic", 1, 48, 2, 0, 1.0), ("basic", 3, 48, 2, 0, 1.0),
                ("bottle", 7, 384, 2, 0, 0.25), ("bottle", 2, 560, 2, 1, 3.0),
                ("bottle", 1, 256, 1, 1, 3.0)),
        stem_chs=13, num_features=1920)),
    "timm-gernet_m": dict(cls=GERNetEncoder, kw=dict(
        blocks=(("basic", 1, 128, 2, 0, 1.0), ("basic", 2, 192, 2, 0, 1.0),
                ("bottle", 6, 640, 2, 0, 0.25), ("bottle", 4, 640, 2, 1, 3.0),
                ("bottle", 1, 640, 1, 1, 3.0)),
        stem_chs=32, num_features=2560)),
    "timm-gernet_l": dict(cls=GERNetEncoder, kw=dict(
        blocks=(("basic", 1, 128, 2, 0, 1.0), ("basic", 2, 192, 2, 0, 1.0),
                ("bottle", 6, 640, 2, 0, 0.25), ("bottle", 5, 640, 2, 1, 3.0),
                ("bottle", 4, 640, 1, 1, 3.0)),
        stem_chs=32, num_features=2560)),
}

TIMM2_ENCODERS = {**RES2NET_ENCODERS, **REGNET_ENCODERS, **SKNET_ENCODERS,
                  **GERNET_ENCODERS}
