"""SE-Net, Xception, InceptionV4, InceptionResNetV2 and DPN encoders of the
baseline zoo in PyTorch (NCHW inside).

Port of `senas_tpu/models/encoders_families.py`, which re-implements
smp's `pretrainedmodels` wrappers (encoders/{senet,xception,inceptionv4,
inceptionresnetv2,dpn}.py) against their stage contracts:

  senet154            (3, 128, 256, 512, 1024, 2048)
  se_resnet50/...     (3,  64, 256, 512, 1024, 2048)
  xception            (3,  64, 128, 256,  728, 2048)
  inceptionv4         (3,  64, 192, 384, 1024, 1536)   stage_idxs (3,5,9,15)
  inceptionresnetv2   (3,  64, 192, 320, 1088, 1536)
  dpn68/68b           (3,  10, 144, 320,  704,  832)
  dpn92               (3,  64, 336, 704, 1552, 2688)
  dpn98               (3,  96, 336, 768, 1728, 2688)
  dpn107              (3, 128, 376, 1152, 2432, 2688)
  dpn131              (3, 128, 352, 832, 1984, 2688)

smp "corrects" the paddings of the 3x3 convs and stride-2 max pools of the
Inception and Xception stems (inceptionv4.py:42-47, inceptionresnetv2.py:
42-48, xception.py:20-22) so that the pyramid halves at each stage;
senas_tpu writes every conv with padding k//2 per axis unless a spec says
otherwise, and so does the port. A max pool with (lo, hi) padding (SENet's
ceil_mode pool) pads with -inf explicitly.

`dtype` is the compute dtype, as in senas_tpu: every BatchNorm rounds its
output to it and a conv runs in its input's dtype (the stems' first conv in
the image's), with its f32 kernel cast at use.

Every conv and pool goes through `primitives` (`conv2d_padded`,
`max_pool`, `avg_pool`) and the SE mean is `image_mean`, so each
encoder runs under the mesh's row split (`senas_torch.parallel.spatial`).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from senas_torch.models.encoders import stage_dilation
from senas_torch.ops.primitives import (BatchNorm, add_bias, add_conv_kernel, add_kernel,
                                        avg_pool, conv2d, conv2d_padded, image_mean,
                                        kaiming_std, max_pool, relu, scalar, sigmoid)

Kernel = Union[int, Tuple[int, int]]


# ---------------------------------------------------------------------------
# rectangular conv / pool helpers (Inception needs 1x7 / 7x1 kernels)
# ---------------------------------------------------------------------------

def _conv(x, w, stride=1, groups: int = 1, dilation: int = 1, padding=None):
    """NCHW/OIHW conv with torch-style explicit padding (default (k//2)*d
    per axis), w cast to x's dtype; under a row split its row-shard form
    (`primitives.conv2d_padded`)."""
    kh, kw = w.shape[2], w.shape[3]
    if padding is None:
        padding = ((kh // 2) * dilation, (kw // 2) * dilation)
    return conv2d_padded(x, w.to(x.dtype), tuple(padding), stride=stride, dilation=dilation,
                         groups=groups)


def _max_pool(x, k: int = 3, stride: int = 2, pad=1):
    """MaxPool2d; `pad` is an int (symmetric) or a (lo, hi) pair, padded
    with -inf. (0, 1) is torch's ceil_mode=True window alignment for an odd
    map (windows anchored at 0, the trailing one padded)."""
    return max_pool(x, k, stride, pad)


def _avg_pool_same(x, k: int = 3):
    """AvgPool2d(k, stride 1, pad k//2, count_include_pad=False)."""
    return avg_pool(x, k, 1, k // 2, count_include_pad=False)


def _pair(k: Kernel) -> Tuple[int, int]:
    return k if isinstance(k, tuple) else (k, k)


class ConvBnAct(nn.Module):
    """conv (no bias) -> BN -> ReLU: the BasicConv2d of the inception nets.
    `kernel` is an int or (kh, kw); `padding` None is k//2 per axis (times
    the dilation). The conv runs in x's dtype."""

    def __init__(self, c_in: int, c_out: int, kernel: Kernel = 3, stride: int = 1,
                 groups: int = 1, dilation: int = 1, padding: Optional[Tuple[int, int]] = None,
                 act: bool = True, dtype=None):
        super().__init__()
        self.stride, self.groups, self.dilation, self.padding, self.act = (
            stride, groups, dilation, padding, act)
        self.c_out = c_out
        kh, kw = _pair(kernel)
        add_conv_kernel(self, "kernel", (c_out, c_in // groups, kh, kw))
        self.bn = BatchNorm(c_out, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = _conv(x, self.kernel, stride=self.stride, groups=self.groups,
                  dilation=self.dilation, padding=self.padding)
        x = self.bn(x, train)
        return relu(x) if self.act else x


# ---------------------------------------------------------------------------
# SENet family (pretrainedmodels senet.py semantics)
# ---------------------------------------------------------------------------

class _SEModule(nn.Module):
    """Squeeze-excite with flax Dense-style (I, O) kernels `fc1`, `fc2`."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        mid = c // reduction
        add_kernel(self, "fc1", (c, mid), kaiming_std(mid))
        add_bias(self, "fc1_b", mid)
        add_kernel(self, "fc2", (mid, c), kaiming_std(c))
        add_bias(self, "fc2_b", c)

    def forward(self, x):
        s = image_mean(x)
        s = relu(s @ self.fc1.to(s.dtype) + self.fc1_b.to(s.dtype))
        s = sigmoid(s @ self.fc2.to(s.dtype) + self.fc2_b.to(s.dtype))
        return x * s[:, :, None, None]


class _SEBottleneck(nn.Module):
    """The three SENet bottlenecks, by `style`:

      * "senet"   (SEBottleneck): 1x1 -> planes*2, grouped 3x3 (stride)
                  -> planes*4, 1x1 -> planes*4 (senet154)
      * "resnet"  (SEResNetBottleneck): the stride on the 1x1 conv1 (the
                  Caffe quirk pretrainedmodels keeps), 3x3 stride 1
      * "resnext" (SEResNeXtBottleneck): width planes*base_width/64 *
                  groups, the stride on the grouped 3x3

    `dilation` > 1: a dilated stage, every conv at stride 1 with that
    dilation (smp encoders/_utils.py:48-60); the downsample test keeps the
    original stride."""

    def __init__(self, c_in: int, planes: int, style: str, stride: int = 1, groups: int = 1,
                 reduction: int = 16, base_width: int = 4, downsample_kernel: int = 1,
                 dilation: int = 1, dtype=None):
        super().__init__()
        c_out = planes * 4
        d = dilation
        if style == "senet":
            w1, w2, s1, s2, g = planes * 2, planes * 4, 1, stride, groups
        elif style == "resnet":
            w1, w2, s1, s2, g = planes, planes, stride, 1, 1
        else:  # resnext
            width = math.floor(planes * (base_width / 64)) * groups
            w1, w2, s1, s2, g = width, width, 1, stride, groups
        sd = stride
        if d > 1:
            s1 = s2 = sd = 1
        self.conv1 = ConvBnAct(c_in, w1, kernel=1, stride=s1, dilation=d, dtype=dtype)
        self.conv2 = ConvBnAct(w1, w2, kernel=3, stride=s2, groups=g, dilation=d, dtype=dtype)
        self.conv3 = ConvBnAct(w2, c_out, kernel=1, act=False, dilation=d, dtype=dtype)
        self.se = _SEModule(c_out, reduction)
        if stride != 1 or c_in != c_out:
            self.downsample = ConvBnAct(c_in, c_out, kernel=downsample_kernel, stride=sd,
                                        dilation=d, act=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        y = self.se(self.conv3(self.conv2(self.conv1(x, train), train), train))
        if hasattr(self, "downsample"):
            x = self.downsample(x, train)
        return relu(x + y)


class SENetEncoder(nn.Module):
    """SENet feature pyramid (smp senet.py get_stages): stage1 = layer0's
    convs, stage2 = maxpool + layer1, stages 3-5 = layer2-4."""

    def __init__(self, in_channels: int, layers: Sequence[int], style: str = "resnet",
                 groups: int = 1, reduction: int = 16, input_3x3: bool = False,
                 downsample_kernel: int = 1, depth: int = 5, output_stride: int = 32,
                 dtype=None):
        super().__init__()
        self.depth = depth
        maps = 1   # the maps the forward returns so far
        self.stem: List[str] = []
        self.stage_blocks: List[List[str]] = []
        if depth > 0:
            if input_3x3:
                self.stem0 = ConvBnAct(in_channels, 64, 3, stride=2, dtype=dtype)
                self.stem1 = ConvBnAct(64, 64, 3, dtype=dtype)
                self.stem2 = ConvBnAct(64, 128, 3, dtype=dtype)
                self.stem, c = ["stem0", "stem1", "stem2"], 128
            else:
                self.stem0 = ConvBnAct(in_channels, 64, 7, stride=2, dtype=dtype)
                self.stem, c = ["stem0"], 64
            maps += 1
            planes = (64, 128, 256, 512)
            for li, n_blocks in enumerate(layers):
                if maps > depth:
                    break
                rate = stage_dilation(li + 2, output_stride)
                names = []
                for b in range(n_blocks):
                    # layer1 always has a 1x1 downsample (pretrainedmodels
                    # passes downsample_kernel_size=1 for layer1)
                    name = f"layer{li + 1}_{b}"
                    setattr(self, name, _SEBottleneck(
                        c, planes[li], style, stride=2 if (li > 0 and b == 0) else 1,
                        groups=groups, reduction=reduction,
                        downsample_kernel=1 if li == 0 else downsample_kernel, dilation=rate,
                        dtype=dtype))
                    names.append(name)
                    c = planes[li] * 4
                self.stage_blocks.append(names)
                maps += 1

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        for name in self.stem:
            x = getattr(self, name)(x, train)
        features.append(x)
        for li, names in enumerate(self.stage_blocks):
            if li == 0:
                # pretrainedmodels' MaxPool2d(3, stride=2, ceil_mode=True):
                # pad 0 and the trailing partial window, (0, 1)
                x = _max_pool(x, 3, 2, (0, 1))
            for name in names:
                x = getattr(self, name)(x, train)
            features.append(x)
        return features[:self.depth + 1]


# ---------------------------------------------------------------------------
# Xception (pretrainedmodels xception.py, smp-corrected padding)
# ---------------------------------------------------------------------------

class _SeparableConv(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int = 3):
        super().__init__()
        add_conv_kernel(self, "depthwise", (c_in, 1, kernel, kernel))
        add_conv_kernel(self, "pointwise", (c_out, c_in, 1, 1))

    def forward(self, x):
        x = conv2d(x, self.depthwise.to(x.dtype), groups=self.depthwise.shape[0])
        return conv2d(x, self.pointwise.to(x.dtype))


class _XceptionBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, reps: int, stride: int = 1,
                 start_with_relu: bool = True, grow_first: bool = True, dtype=None):
        super().__init__()
        self.stride, self.start_with_relu = stride, start_with_relu
        if c_out != c_in or stride != 1:
            self.skip = ConvBnAct(c_in, c_out, kernel=1, stride=stride, act=False,
                                  padding=(0, 0), dtype=dtype)
        widths = [c_out] * reps if grow_first else [c_in] * (reps - 1) + [c_out]
        self.reps = len(widths)
        c = c_in
        for i, w in enumerate(widths):
            setattr(self, f"sep{i}", _SeparableConv(c, w))
            setattr(self, f"bn{i}", BatchNorm(w, dtype=dtype))
            c = w

    def forward(self, x, train: bool = False):
        skip = self.skip(x, train) if hasattr(self, "skip") else x
        y = x
        for i in range(self.reps):
            if i > 0 or self.start_with_relu:
                y = relu(y)
            y = getattr(self, f"bn{i}")(getattr(self, f"sep{i}")(y), train)
        if self.stride != 1:
            y = _max_pool(y, 3, self.stride, 1)
        return y + skip


class XceptionEncoder(nn.Module):
    """Xception pyramid (smp xception.py get_stages): stem (64, s2), block1
    (128, s4), block2 (256, s8), block3..11 (728, s16), block12 + conv3/4
    (2048, s32; ends on bn4, no final relu)."""

    def __init__(self, in_channels: int, depth: int = 5, dtype=None):
        super().__init__()
        self.depth = depth
        if depth >= 1:
            self.conv1 = ConvBnAct(in_channels, 32, 3, stride=2, dtype=dtype)
            self.conv2 = ConvBnAct(32, 64, 3, dtype=dtype)
        if depth >= 2:
            self.block1 = _XceptionBlock(64, 128, 2, stride=2, start_with_relu=False, dtype=dtype)
        if depth >= 3:
            self.block2 = _XceptionBlock(128, 256, 2, stride=2, dtype=dtype)
        if depth >= 4:
            self.block3 = _XceptionBlock(256, 728, 2, stride=2, dtype=dtype)
            for i in range(4, 12):
                setattr(self, f"block{i}", _XceptionBlock(728, 728, 3, dtype=dtype))
        if depth >= 5:
            self.block12 = _XceptionBlock(728, 1024, 2, stride=2, grow_first=False, dtype=dtype)
            self.conv3 = _SeparableConv(1024, 1536)
            self.bn3 = BatchNorm(1536, dtype=dtype)
            self.conv4 = _SeparableConv(1536, 2048)
            self.bn4 = BatchNorm(2048, dtype=dtype)

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        x = self.conv2(self.conv1(x, train), train)
        features.append(x)
        if self.depth >= 2:
            x = self.block1(x, train)
            features.append(x)
        if self.depth >= 3:
            x = self.block2(x, train)
            features.append(x)
        if self.depth >= 4:
            for i in range(3, 12):
                x = getattr(self, f"block{i}")(x, train)
            features.append(x)
        if self.depth >= 5:
            x = self.block12(x, train)
            x = relu(self.bn3(self.conv3(x), train))
            x = self.bn4(self.conv4(x), train)
            features.append(x)
        return features[:self.depth + 1]


# ---------------------------------------------------------------------------
# InceptionV4 (pretrainedmodels inceptionv4.py, smp stage_idxs (3,5,9,15))
# ---------------------------------------------------------------------------

class _InceptionMixed(nn.Module):
    """Concat of branches. Each branch is a list of (c_out, kernel, stride,
    padding) conv specs, or "maxpool" / "avgpool+<c>" for the pooling
    branches."""

    def __init__(self, c_in: int, branches: Sequence, dtype=None):
        super().__init__()
        self.branches = []
        self.c_out = 0
        for bi, branch in enumerate(branches):
            if branch == "maxpool":
                self.branches.append("maxpool")
                self.c_out += c_in
            elif isinstance(branch, str) and branch.startswith("avgpool+"):
                c = int(branch.split("+")[1])
                setattr(self, f"b{bi}_pool_conv", ConvBnAct(c_in, c, kernel=1, dtype=dtype))
                self.branches.append(("avgpool", f"b{bi}_pool_conv"))
                self.c_out += c
            else:
                c, names = c_in, []
                for ci, (co, k, s, p) in enumerate(branch):
                    setattr(self, f"b{bi}_{ci}", ConvBnAct(c, co, kernel=k, stride=s, padding=p,
                                                           dtype=dtype))
                    names.append(f"b{bi}_{ci}")
                    c = co
                self.branches.append(("convs", names))
                self.c_out += c

    def forward(self, x, train: bool = False):
        outs = []
        for branch in self.branches:
            if branch == "maxpool":
                y = _max_pool(x, 3, 2, 1)
            elif branch[0] == "avgpool":
                y = getattr(self, branch[1])(_avg_pool_same(x, 3), train)
            else:
                y = x
                for name in branch[1]:
                    y = getattr(self, name)(y, train)
            outs.append(y)
        return torch.cat(outs, dim=1)


def _conv_spec(c, k=3, s=1, p=None):
    return (c, k, s, p)


_INCEPTION_A = (
    [_conv_spec(96, 1)],
    [_conv_spec(64, 1), _conv_spec(96, 3)],
    [_conv_spec(64, 1), _conv_spec(96, 3), _conv_spec(96, 3)],
    "avgpool+96")
_INCEPTION_B = (
    [_conv_spec(384, 1)],
    [_conv_spec(192, 1), _conv_spec(224, (1, 7), 1, (0, 3)), _conv_spec(256, (7, 1), 1, (3, 0))],
    [_conv_spec(192, 1), _conv_spec(192, (7, 1), 1, (3, 0)), _conv_spec(224, (1, 7), 1, (0, 3)),
     _conv_spec(224, (7, 1), 1, (3, 0)), _conv_spec(256, (1, 7), 1, (0, 3))],
    "avgpool+128")


def _iv4_feature_blocks():
    """The 19 blocks of InceptionV4's features list before its Inception-C
    blocks, as (name, kind, spec): kind "conv" (c_out, kernel, stride) or
    "mixed" (the branches)."""
    blocks = [
        ("f0", "conv", (32, 3, 2)),
        ("f1", "conv", (32, 3, 1)),
        ("f2", "conv", (64, 3, 1)),
        # Mixed_3a: maxpool || conv 3x3 s2 96 -> 160
        ("mixed_3a", "mixed", ("maxpool", [_conv_spec(96, 3, 2)])),
        # Mixed_4a: (1x1 64, 3x3 96) || (1x1 64, 1x7, 7x1, 3x3 96) -> 192;
        # pretrainedmodels leaves the final 3x3s unpadded, smp pads every
        # 3x3 conv by 1 (inceptionv4.py:42-47)
        ("mixed_4a", "mixed", (
            [_conv_spec(64, 1), _conv_spec(96, 3, 1, (1, 1))],
            [_conv_spec(64, 1), _conv_spec(64, (1, 7), 1, (0, 3)),
             _conv_spec(64, (7, 1), 1, (3, 0)), _conv_spec(96, 3, 1, (1, 1))])),
        # Mixed_5a: conv 3x3 s2 192 || maxpool -> 384
        ("mixed_5a", "mixed", ([_conv_spec(192, 3, 2)], "maxpool")),
    ]
    blocks += [(f"inception_a{i}", "mixed", _INCEPTION_A) for i in range(4)]
    blocks.append(("reduction_a", "mixed", (
        [_conv_spec(384, 3, 2)],
        [_conv_spec(192, 1), _conv_spec(224, 3), _conv_spec(256, 3, 2)],
        "maxpool")))
    blocks += [(f"inception_b{i}", "mixed", _INCEPTION_B) for i in range(7)]
    blocks.append(("reduction_b", "mixed", (
        [_conv_spec(192, 1), _conv_spec(192, 3, 2)],
        [_conv_spec(256, 1), _conv_spec(256, (1, 7), 1, (0, 3)),
         _conv_spec(320, (7, 1), 1, (3, 0)), _conv_spec(320, 3, 2)],
        "maxpool")))
    return blocks


class _InceptionC(nn.Module):
    """Inception-C: branches with internal splits (1536 out)."""

    def __init__(self, c_in: int, dtype=None):
        super().__init__()
        C = lambda ci, co, k, p=None: ConvBnAct(ci, co, k, padding=p, dtype=dtype)
        self.b0 = C(c_in, 256, 1)
        self.b1_0 = C(c_in, 384, 1)
        self.b1_1a = C(384, 256, (1, 3), (0, 1))
        self.b1_1b = C(384, 256, (3, 1), (1, 0))
        self.b2_0 = C(c_in, 384, 1)
        self.b2_1 = C(384, 448, (3, 1), (1, 0))
        self.b2_2 = C(448, 512, (1, 3), (0, 1))
        self.b2_3a = C(512, 256, (1, 3), (0, 1))
        self.b2_3b = C(512, 256, (3, 1), (1, 0))
        self.b3_1 = C(c_in, 256, 1)

    def forward(self, x, train: bool = False):
        b0 = self.b0(x, train)
        y1 = self.b1_0(x, train)
        b1a, b1b = self.b1_1a(y1, train), self.b1_1b(y1, train)
        y2 = self.b2_2(self.b2_1(self.b2_0(x, train), train), train)
        b2a, b2b = self.b2_3a(y2, train), self.b2_3b(y2, train)
        b3 = self.b3_1(_avg_pool_same(x, 3), train)
        return torch.cat([b0, b1a, b1b, b2a, b2b, b3], dim=1)


class InceptionV4Encoder(nn.Module):
    """InceptionV4 pyramid, smp's stage split (3, 5, 9, 15) over the
    features list; out_channels (3, 64, 192, 384, 1024, 1536). Every 3x3
    conv and stride-2 max pool pads by 1 (smp inceptionv4.py:42-47)."""

    def __init__(self, in_channels: int, depth: int = 5, dtype=None):
        super().__init__()
        self.depth = depth
        blocks = _iv4_feature_blocks()
        self.stage_ends = (3, 5, 9, 15, len(blocks) + 3)
        maps, c = 1, in_channels
        self.blocks: List[str] = []
        for idx, (name, kind, spec) in enumerate(blocks, start=1):
            if maps > depth:
                break
            if kind == "conv":
                co, k, s = spec
                setattr(self, name, ConvBnAct(c, co, k, stride=s, dtype=dtype))
                c = co
            else:
                setattr(self, name, _InceptionMixed(c, spec, dtype=dtype))
                c = getattr(self, name).c_out
            self.blocks.append(name)
            if idx in self.stage_ends:
                maps += 1
        self.n_c = 0
        for i in range(3):
            if maps > depth:
                break
            setattr(self, f"inception_c{i}", _InceptionC(c, dtype=dtype))
            c = 1536
            self.n_c += 1
            if i == 2:
                maps += 1

    def forward(self, x, train: bool = False):
        features = [x]
        for idx, name in enumerate(self.blocks, start=1):
            x = getattr(self, name)(x, train)
            if idx in self.stage_ends:
                features.append(x)
        for i in range(self.n_c):
            x = getattr(self, f"inception_c{i}")(x, train)
            if i == 2:
                features.append(x)
        return features[:self.depth + 1]


# ---------------------------------------------------------------------------
# InceptionResNetV2 (pretrainedmodels inceptionresnetv2.py)
# ---------------------------------------------------------------------------

class _ResBlock(nn.Module):
    """Block35/Block17/Block8: branches -> concat -> 1x1 conv (bias, no BN),
    scaled residual -> optional relu. The scale multiplies in the map's
    dtype, as JAX's weak-typed Python float does."""

    def __init__(self, c_in: int, branches: Sequence, c_out: int, scale: float,
                 final_relu: bool = True, dtype=None):
        super().__init__()
        self.scale, self.final_relu = scale, final_relu
        self.branch_names = []
        c_cat = 0
        for bi, branch in enumerate(branches):
            c, names = c_in, []
            for ci, (co, k, s, p) in enumerate(branch):
                setattr(self, f"b{bi}_{ci}", ConvBnAct(c, co, kernel=k, stride=s, padding=p,
                                                       dtype=dtype))
                names.append(f"b{bi}_{ci}")
                c = co
            self.branch_names.append(names)
            c_cat += c
        add_conv_kernel(self, "conv2d", (c_out, c_cat, 1, 1))
        add_bias(self, "conv2d_b", c_out)

    def forward(self, x, train: bool = False):
        outs = []
        for names in self.branch_names:
            y = x
            for name in names:
                y = getattr(self, name)(y, train)
            outs.append(y)
        y = torch.cat(outs, dim=1)
        y = _conv(y, self.conv2d, padding=(0, 0)) + self.conv2d_b.to(y.dtype)[:, None, None]
        out = x + scalar(self.scale, y) * y
        return relu(out) if self.final_relu else out


_BLOCK35 = ([(32, 1, 1, None)],
            [(32, 1, 1, None), (32, 3, 1, (1, 1))],
            [(32, 1, 1, None), (48, 3, 1, (1, 1)), (64, 3, 1, (1, 1))])
_BLOCK17 = ([(192, 1, 1, None)],
            [(128, 1, 1, None), (160, (1, 7), 1, (0, 3)), (192, (7, 1), 1, (3, 0))])
_BLOCK8 = ([(192, 1, 1, None)],
           [(192, 1, 1, None), (224, (1, 3), 1, (0, 1)), (256, (3, 1), 1, (1, 0))])


class InceptionResNetV2Encoder(nn.Module):
    """InceptionResNetV2 pyramid (smp inceptionresnetv2.py get_stages):
    out_channels (3, 64, 192, 320, 1088, 1536)."""

    def __init__(self, in_channels: int, depth: int = 5, dtype=None):
        super().__init__()
        self.depth = depth
        C = lambda ci, co, k, s=1: ConvBnAct(ci, co, k, stride=s, dtype=dtype)
        if depth >= 1:
            self.conv2d_1a = C(in_channels, 32, 3, 2)
            self.conv2d_2a = C(32, 32, 3)
            self.conv2d_2b = C(32, 64, 3)
        if depth >= 2:
            self.conv2d_3b = C(64, 80, 1)
            self.conv2d_4a = C(80, 192, 3)
        if depth >= 3:
            self.mixed_5b = _InceptionMixed(192, (
                [(96, 1, 1, None)],
                [(48, 1, 1, None), (64, 5, 1, (2, 2))],
                [(64, 1, 1, None), (96, 3, 1, (1, 1)), (96, 3, 1, (1, 1))],
                "avgpool+64"), dtype=dtype)
            for i in range(10):
                setattr(self, f"block35_{i}", _ResBlock(320, _BLOCK35, 320, 0.17, dtype=dtype))
        if depth >= 4:
            self.mixed_6a = _InceptionMixed(320, (
                [(384, 3, 2, (1, 1))],
                [(256, 1, 1, None), (256, 3, 1, (1, 1)), (384, 3, 2, (1, 1))],
                "maxpool"), dtype=dtype)
            for i in range(20):
                setattr(self, f"block17_{i}", _ResBlock(1088, _BLOCK17, 1088, 0.10, dtype=dtype))
        if depth >= 5:
            self.mixed_7a = _InceptionMixed(1088, (
                [(256, 1, 1, None), (384, 3, 2, (1, 1))],
                [(256, 1, 1, None), (288, 3, 2, (1, 1))],
                [(256, 1, 1, None), (288, 3, 1, (1, 1)), (320, 3, 2, (1, 1))],
                "maxpool"), dtype=dtype)
            for i in range(9):
                setattr(self, f"block8_{i}", _ResBlock(2080, _BLOCK8, 2080, 0.20, dtype=dtype))
            self.block8_final = _ResBlock(2080, _BLOCK8, 2080, 1.0, final_relu=False,
                                          dtype=dtype)
            self.conv2d_7b = C(2080, 1536, 1)

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        for name in ("conv2d_1a", "conv2d_2a", "conv2d_2b"):
            x = getattr(self, name)(x, train)
        features.append(x)
        if self.depth >= 2:
            x = _max_pool(x, 3, 2, 1)
            x = self.conv2d_4a(self.conv2d_3b(x, train), train)
            features.append(x)
        if self.depth >= 3:
            x = self.mixed_5b(_max_pool(x, 3, 2, 1), train)
            for i in range(10):
                x = getattr(self, f"block35_{i}")(x, train)
            features.append(x)
        if self.depth >= 4:
            x = self.mixed_6a(x, train)
            for i in range(20):
                x = getattr(self, f"block17_{i}")(x, train)
            features.append(x)
        if self.depth >= 5:
            x = self.mixed_7a(x, train)
            for i in range(9):
                x = getattr(self, f"block8_{i}")(x, train)
            x = self.conv2d_7b(self.block8_final(x, train), train)
            features.append(x)
        return features[:self.depth + 1]


# ---------------------------------------------------------------------------
# DPN (pretrainedmodels dpn.py semantics)
# ---------------------------------------------------------------------------

class _BnActConv(nn.Module):
    """Pre-activation conv: BN -> ReLU -> conv (no bias)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 1, stride: int = 1, groups: int = 1,
                 dilation: int = 1, dtype=None):
        super().__init__()
        self.stride = 1 if dilation > 1 else stride
        self.groups, self.dilation = groups, dilation
        self.bn = BatchNorm(c_in, dtype=dtype)
        add_conv_kernel(self, "kernel", (c_out, c_in // groups, kernel, kernel))

    def forward(self, x, train: bool = False):
        x = relu(self.bn(x, train))
        return _conv(x, self.kernel, stride=self.stride, groups=self.groups,
                     dilation=self.dilation)


class _DualPathBlock(nn.Module):
    """(residual, dense) pair in, pair out (pretrainedmodels DualPathBlock);
    the first block of a group takes one map. block_type: "proj" (stride 1,
    projected skip), "down" (stride 2, projected skip) or "normal"."""

    def __init__(self, c_in: int, num_1x1_a: int, num_3x3_b: int, num_1x1_c: int, inc: int,
                 groups: int, block_type: str = "normal", b: bool = False, dilation: int = 1,
                 dtype=None):
        super().__init__()
        self.num_1x1_c, self.b = num_1x1_c, b
        stride = 2 if block_type == "down" else 1
        d = dilation
        self.has_proj = block_type in ("proj", "down")
        if self.has_proj:
            self.c1x1_w = _BnActConv(c_in, num_1x1_c + 2 * inc, 1, stride, dilation=d,
                                     dtype=dtype)
        self.c1x1_a = _BnActConv(c_in, num_1x1_a, 1, 1, dilation=d, dtype=dtype)
        self.c3x3_b = _BnActConv(num_1x1_a, num_3x3_b, 3, stride, groups=groups, dilation=d,
                                 dtype=dtype)
        if b:
            self.cat_bn = BatchNorm(num_3x3_b, dtype=dtype)
            add_conv_kernel(self, "c1x1_c1", (num_1x1_c, num_3x3_b, 1, 1))
            add_conv_kernel(self, "c1x1_c2", (inc, num_3x3_b, 1, 1))
        else:
            self.c1x1_c = _BnActConv(num_3x3_b, num_1x1_c + inc, 1, 1, dtype=dtype)

    def forward(self, x, train: bool = False):
        x_in = torch.cat(x, dim=1) if isinstance(x, (list, tuple)) else x
        if self.has_proj:
            s = self.c1x1_w(x_in, train)
            x_s1, x_s2 = s[:, :self.num_1x1_c], s[:, self.num_1x1_c:]
        else:
            x_s1, x_s2 = x
        y = self.c3x3_b(self.c1x1_a(x_in, train), train)
        if self.b:
            y = relu(self.cat_bn(y, train))
            out1, out2 = _conv(y, self.c1x1_c1), _conv(y, self.c1x1_c2)
        else:
            y = self.c1x1_c(y, train)
            out1, out2 = y[:, :self.num_1x1_c], y[:, self.num_1x1_c:]
        return (x_s1 + out1, torch.cat([x_s2, out2], dim=1))


class DPNEncoder(nn.Module):
    """Dual-path network pyramid (smp dpn.py get_stages): stage1 = the stem
    conv+bn+relu, stage2 = maxpool + the first block group, stages 3-5 the
    other groups; a pair surfaces as relu(concat), as the smp wrapper's
    forward does, the last after its CatBnAct."""

    def __init__(self, in_channels: int, k_sec: Sequence[int], inc_sec: Sequence[int], k_r: int,
                 groups: int, num_init_features: int, small: bool = False, b: bool = False,
                 depth: int = 5, output_stride: int = 32, dtype=None):
        super().__init__()
        self.depth = depth
        maps = 1   # the maps the forward returns so far
        self.group_blocks: List[List[str]] = []
        self.final = False
        if depth > 0:
            k = 3 if small else 7
            add_conv_kernel(self, "stem_conv", (num_init_features, in_channels, k, k))
            self.stem_bn = BatchNorm(num_init_features, dtype=dtype)
            maps += 1
            bw_factor = 1 if small else 4
            c_res, c_dense = num_init_features, 0
            for gi in range(len(k_sec)):
                if maps > depth:
                    break
                bw = 64 * (2 ** gi) * bw_factor
                inc = inc_sec[gi]
                r = (k_r * bw) // (64 * bw_factor)
                block_type = "proj" if gi == 0 else "down"
                rate = stage_dilation(gi + 2, output_stride)
                names = []
                for bi in range(k_sec[gi]):
                    bt = block_type if bi == 0 else "normal"
                    c_in = c_res + c_dense
                    setattr(self, f"group{gi}_block{bi}", _DualPathBlock(
                        c_in, r, r, bw, inc, groups, block_type=bt, b=b, dilation=rate,
                        dtype=dtype))
                    names.append(f"group{gi}_block{bi}")
                    c_dense = (2 * inc if bt != "normal" else c_dense) + inc
                    c_res = bw
                self.group_blocks.append(names)
                if gi == len(k_sec) - 1:
                    self.final_bn = BatchNorm(c_res + c_dense, dtype=dtype)
                    self.final = True
                maps += 1

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        x = _conv(x, self.stem_conv, stride=2)
        x = relu(self.stem_bn(x, train))
        features.append(x)
        t = x
        for gi, names in enumerate(self.group_blocks):
            if gi == 0:
                t = _max_pool(t, 3, 2, 1)
            for name in names:
                t = getattr(self, name)(t, train)
            cat = torch.cat(t, dim=1)
            if self.final and gi == len(self.group_blocks) - 1:
                cat = self.final_bn(cat, train)
            features.append(relu(cat))
        return features[:self.depth + 1]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

FAMILY_ENCODERS = {
    "senet154": dict(cls=SENetEncoder, kw=dict(
        layers=(3, 8, 36, 3), style="senet", groups=64, input_3x3=True,
        downsample_kernel=3)),
    "se_resnet50": dict(cls=SENetEncoder, kw=dict(layers=(3, 4, 6, 3), style="resnet")),
    "se_resnet101": dict(cls=SENetEncoder, kw=dict(layers=(3, 4, 23, 3), style="resnet")),
    "se_resnet152": dict(cls=SENetEncoder, kw=dict(layers=(3, 8, 36, 3), style="resnet")),
    "se_resnext50_32x4d": dict(cls=SENetEncoder, kw=dict(
        layers=(3, 4, 6, 3), style="resnext", groups=32)),
    "se_resnext101_32x4d": dict(cls=SENetEncoder, kw=dict(
        layers=(3, 4, 23, 3), style="resnext", groups=32)),
    "xception": dict(cls=XceptionEncoder, kw=dict()),
    "inceptionv4": dict(cls=InceptionV4Encoder, kw=dict()),
    "inceptionresnetv2": dict(cls=InceptionResNetV2Encoder, kw=dict()),
    "dpn68": dict(cls=DPNEncoder, kw=dict(
        k_sec=(3, 4, 12, 3), inc_sec=(16, 32, 32, 64), k_r=128, groups=32,
        num_init_features=10, small=True)),
    "dpn68b": dict(cls=DPNEncoder, kw=dict(
        k_sec=(3, 4, 12, 3), inc_sec=(16, 32, 32, 64), k_r=128, groups=32,
        num_init_features=10, small=True, b=True)),
    "dpn92": dict(cls=DPNEncoder, kw=dict(
        k_sec=(3, 4, 20, 3), inc_sec=(16, 32, 24, 128), k_r=96, groups=32,
        num_init_features=64)),
    "dpn98": dict(cls=DPNEncoder, kw=dict(
        k_sec=(3, 6, 20, 3), inc_sec=(16, 32, 32, 128), k_r=160, groups=40,
        num_init_features=96)),
    "dpn107": dict(cls=DPNEncoder, kw=dict(
        k_sec=(4, 8, 20, 3), inc_sec=(20, 64, 64, 128), k_r=200, groups=50,
        num_init_features=128)),
    "dpn131": dict(cls=DPNEncoder, kw=dict(
        k_sec=(4, 8, 28, 3), inc_sec=(16, 32, 32, 128), k_r=160, groups=40,
        num_init_features=128)),
}
