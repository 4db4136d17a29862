"""MobileNetV3 encoders of the baseline zoo in PyTorch (NCHW inside).

Port of `senas_tpu/models/encoders_mnv3.py`, the reference's
`timm-mobilenetv3_*` encoders (smp encoders/timm_mobilenetv3.py) as timm's
tf_mobilenetv3_* builds them: hardswish activations, SE with a
hard-sigmoid gate on the expanded width (ratio 0.25), TF 'same' padding
(asymmetric at stride 2), and smp's stage split (large: stem+blocks0 | b1 |
b2 | b3:5 | b5:+final 1x1; small: stem | b0 | b1 | b2:4 | b4:+final 1x1).
The `minimal` variants use relu, no SE and 3x3 kernels throughout;
width_mult scales every width through make_divisible(8).
"""

from __future__ import annotations

from typing import List, Tuple

from torch import nn

from senas_torch.models.encoders import stage_dilation
from senas_torch.ops.primitives import (BatchNorm, add_bias, add_conv_kernel, conv2d_padded,
                                        image_mean, relu)
from senas_torch.parallel.collectives import whole_maps


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hardswish(x):
    """x * clip(x + 3, 0, 6) / 6 op by op (each op rounds in bf16)."""
    return x * (x + 3.0).clamp(0.0, 6.0) / 6.0


def hardsigmoid(x):
    return (x + 3.0).clamp(0.0, 6.0) / 6.0


def _conv_same(x, w, stride: int = 1, groups: int = 1, dilation: int = 1):
    """TF 'same' padding of the tf_mobilenetv3 variants, fixed by the
    kernel: k//2 on each side at stride 1; (lo, hi) with hi = lo + (k - s)
    % 2 at stride 2. Under dilation (a dilated stage runs stride 1) the
    effective kernel (k-1)*d+1 keeps it symmetric at (k//2)*d for odd k.
    w is cast to x's dtype; under a row split the row-shard form, whose
    output row o reads rows [o*s - lo, o*s - lo + k - 1]."""
    k = (w.shape[-1] - 1) * dilation + 1
    if stride == 1:
        lo = hi = k // 2
    else:
        total = max(k - stride, 0)
        lo, hi = total // 2, total - total // 2
    return conv2d_padded(x, w.to(x.dtype), ((lo, hi), (lo, hi)), stride=stride,
                         dilation=dilation, groups=groups)


class _ConvBnAct(nn.Module):
    """conv ('same') -> BN -> hardswish ("hs"), relu ("re") or nothing."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3, stride: int = 1, groups: int = 1,
                 dilation: int = 1, act: str = "hs", dtype=None):
        super().__init__()
        self.stride = 1 if dilation > 1 else stride
        self.groups, self.dilation, self.act = groups, dilation, act
        add_conv_kernel(self, "kernel", (c_out, c_in // groups, kernel, kernel))
        self.bn = BatchNorm(c_out, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = _conv_same(x, self.kernel, stride=self.stride, groups=self.groups,
                       dilation=self.dilation)
        x = self.bn(x, train)
        if self.act == "hs":
            return hardswish(x)
        if self.act == "re":
            return relu(x)
        return x


class InvertedResidual(nn.Module):
    """MNv3 block: [1x1 expand] -> kxk depthwise -> [SE] -> 1x1 project.
    `dilation` > 1: a dilated stage (depthwise dilated, stride 1); the
    residual test keeps the original stride, as the patched module does."""

    def __init__(self, c_in: int, exp: int, c_out: int, kernel: int = 3, stride: int = 1,
                 se: bool = False, act: str = "hs", dilation: int = 1, dtype=None):
        super().__init__()
        self.se = se
        self.residual = stride == 1 and c_in == c_out
        if exp != c_in:
            self.expand = _ConvBnAct(c_in, exp, 1, act=act, dtype=dtype)
        self.dw = _ConvBnAct(exp, exp, kernel, stride=stride, groups=exp, dilation=dilation,
                             act=act, dtype=dtype)
        if se:
            rd = _make_divisible(exp * 0.25)
            add_conv_kernel(self, "se_fc1", (rd, exp, 1, 1))
            add_bias(self, "se_b1", rd)
            add_conv_kernel(self, "se_fc2", (exp, rd, 1, 1))
            add_bias(self, "se_b2", exp)
        self.project = _ConvBnAct(exp, c_out, 1, act="none", dtype=dtype)

    def forward(self, x, train: bool = False):
        y = self.expand(x, train) if hasattr(self, "expand") else x
        y = self.dw(y, train)
        if self.se:
            # the global image's mean; the squeeze a map every spatial rank
            # computes whole
            s = image_mean(y)[:, :, None, None]
            with whole_maps():
                s = relu(_conv_same(s, self.se_fc1) + self.se_b1.to(s.dtype)[:, None, None])
                s = hardsigmoid(_conv_same(s, self.se_fc2)
                                + self.se_b2.to(s.dtype)[:, None, None])
            y = y * s
        y = self.project(y, train)
        return y + x if self.residual else y


# per-block spec: (kernel, exp, out, se, act, stride), grouped into timm's
# `blocks[i]` stage lists
_LARGE_BLOCKS = [
    [(3, 16, 16, False, "re", 1)],
    [(3, 64, 24, False, "re", 2), (3, 72, 24, False, "re", 1)],
    [(5, 72, 40, True, "re", 2), (5, 120, 40, True, "re", 1),
     (5, 120, 40, True, "re", 1)],
    [(3, 240, 80, False, "hs", 2), (3, 200, 80, False, "hs", 1),
     (3, 184, 80, False, "hs", 1), (3, 184, 80, False, "hs", 1)],
    [(3, 480, 112, True, "hs", 1), (3, 672, 112, True, "hs", 1)],
    [(5, 672, 160, True, "hs", 2), (5, 960, 160, True, "hs", 1),
     (5, 960, 160, True, "hs", 1)],
]
_SMALL_BLOCKS = [
    [(3, 16, 16, True, "re", 2)],
    [(3, 72, 24, False, "re", 2), (3, 88, 24, False, "re", 1)],
    [(5, 96, 40, True, "hs", 2), (5, 240, 40, True, "hs", 1),
     (5, 240, 40, True, "hs", 1)],
    [(5, 120, 48, True, "hs", 1), (5, 144, 48, True, "hs", 1)],
    [(5, 288, 96, True, "hs", 2), (5, 576, 96, True, "hs", 1),
     (5, 576, 96, True, "hs", 1)],
]


class MobileNetV3Encoder(nn.Module):
    def __init__(self, in_channels: int, mode: str = "large", width_mult: float = 1.0,
                 minimal: bool = False, depth: int = 5, output_stride: int = 32, dtype=None):
        super().__init__()
        self.depth = depth
        wm = width_mult
        act0 = "re" if minimal else "hs"
        blocks = _SMALL_BLOCKS if mode == "small" else _LARGE_BLOCKS
        maps = 1   # the maps the forward returns so far
        # the forward's plan: (block names, tap after them)
        self.plan: List[Tuple[List[str], bool]] = []
        if depth == 0:
            return
        c = _make_divisible(16 * wm)
        self.stem = _ConvBnAct(in_channels, c, 3, stride=2, act=act0, dtype=dtype)

        def stage(si, rate=1):
            nonlocal c
            names = []
            for bi, (k, e, co, se, act, s) in enumerate(blocks[si]):
                if minimal:
                    k, se, act = 3, False, "re"
                name = f"b{si}_{bi}"
                setattr(self, name, InvertedResidual(
                    c, _make_divisible(e * wm), _make_divisible(co * wm), kernel=k, stride=s,
                    se=se, act=act, dilation=rate, dtype=dtype))
                names.append(name)
                c = _make_divisible(co * wm)
            return names

        if mode == "large":
            # smp stages: stem+b0 | b1 | b2 | b3+b4 | b5+final
            self.plan.append((stage(0), True))
            groups = [(1,), (2,), (3, 4), (5,)]
        else:
            # stem | b0 | b1 | b2+b3 | b4+final
            self.plan.append(([], True))
            groups = [(0,), (1,), (2, 3), (4,)]
        maps += 1
        for gi, group in enumerate(groups):
            if maps > depth:
                break
            rate = stage_dilation(gi + 2, output_stride)
            names = [n for si in group for n in stage(si, rate)]
            if gi == len(groups) - 1:
                final_c = _make_divisible((576 if mode == "small" else 960) * wm)
                self.final_conv = _ConvBnAct(c, final_c, 1, act=act0, dtype=dtype)
                names.append("final_conv")
                c = final_c
            self.plan.append((names, True))
            maps += 1

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        x = self.stem(x, train)
        for names, _ in self.plan:
            for name in names:
                x = getattr(self, name)(x, train)
            features.append(x)
        return features[:self.depth + 1]


MNV3_ENCODERS = {
    "timm-mobilenetv3_large_075": dict(cls=MobileNetV3Encoder, kw=dict(
        mode="large", width_mult=0.75)),
    "timm-mobilenetv3_large_100": dict(cls=MobileNetV3Encoder, kw=dict(
        mode="large", width_mult=1.0)),
    "timm-mobilenetv3_large_minimal_100": dict(cls=MobileNetV3Encoder, kw=dict(
        mode="large", width_mult=1.0, minimal=True)),
    "timm-mobilenetv3_small_075": dict(cls=MobileNetV3Encoder, kw=dict(
        mode="small", width_mult=0.75)),
    "timm-mobilenetv3_small_100": dict(cls=MobileNetV3Encoder, kw=dict(
        mode="small", width_mult=1.0)),
    "timm-mobilenetv3_small_minimal_100": dict(cls=MobileNetV3Encoder, kw=dict(
        mode="small", width_mult=1.0, minimal=True)),
}
