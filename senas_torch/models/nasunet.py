"""NasUnet baseline (a prior-work NAS model) in PyTorch (NCHW inside).

Port of `senas_tpu/models/nasunet.py` (the reference's models/nasunet/:
nas_unet.py:8-139, prim_ops_set.py:4-22): its own op vocabulary (cweight
SE gates, dilated and depthwise convs, GroupNorm(c//16) and the
weight_norm_act order), the NAS_UNET_V3 genotype, stem_multiplier 4, and
the merge of two node inputs of different sizes by an integer nearest pick
(the up-transpose convs use output_padding 0, so they give 2H-1 maps).
Submodules carry the flax names (`stem0`, `stem1`, `down_{i}`, `up_{i}`,
`head`, each cell's `preprocess0/1` and `op_{i}`); `NasUnet.forward` keeps
the NHWC boundary.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from senas_torch.core.device import resolve_device
from senas_torch.core.genotype import Genotype
from senas_torch.ops.primitives import (Dense, GroupNorm, add_conv_kernel, conv2d,
                                        conv_transpose2d, init_params_, relu)

NAS_UNET_V3 = Genotype(
    down=[('down_dil_conv', 1), ('down_cweight', 0), ('down_cweight', 0),
          ('down_cweight', 1), ('down_cweight', 0), ('conv', 3),
          ('down_cweight', 0), ('conv', 4)],
    down_concat=range(2, 6),
    up=[('cweight', 0), ('up_cweight', 1), ('conv', 2), ('up_cweight', 1),
        ('up_cweight', 1), ('conv', 3), ('up_cweight', 1), ('conv', 4)],
    up_concat=range(2, 6),
    gamma=[])

NASUNET = NAS_UNET_V3


def _gn_groups(c: int) -> int:
    return c // 16 if c % 16 == 0 else 1


class ConvOps(nn.Module):
    """prim_ops_set.ConvOps: the ops of `ops_order` ("act", "weight",
    "norm") in turn; the weight is a conv, a transposed conv (output
    padding 0: 2H-1 rows at stride 2), or a depthwise (transposed) conv
    followed by a pointwise one. senas_tpu's `use_norm`, `act` and
    `output_padding` options keep their defaults at every caller."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, use_transpose: bool = False, use_depthwise: bool = False,
                 ops_order: str = "weight_norm_act"):
        super().__init__()
        self.ops = ops_order.split("_")
        self.stride, self.dilation, self.c_in = stride, dilation, c_in
        self.use_transpose, self.use_depthwise = use_transpose, use_depthwise
        k = kernel_size
        if use_depthwise:
            add_conv_kernel(self, "depth_conv", (c_in, 1, k, k))
            if use_transpose:
                self.flax_layout = {"depth_conv": "dw_t"}
            add_conv_kernel(self, "point_conv", (c_out, c_in, 1, 1))
        elif use_transpose:
            add_conv_kernel(self, "conv", (c_in, c_out, k, k))
            self.flax_layout = {"conv": "hwio_t"}
        else:
            add_conv_kernel(self, "conv", (c_out, c_in, k, k))
        if "norm" in self.ops:
            self.GroupNorm_0 = GroupNorm(c_out, _gn_groups(c_out))

    def _weight(self, x):
        if self.use_depthwise:
            if self.use_transpose:
                x = conv_transpose2d(x, self.depth_conv, stride=self.stride, output_padding=0,
                                     groups=self.c_in)
            else:
                x = conv2d(x, self.depth_conv, stride=self.stride, dilation=self.dilation,
                           groups=self.c_in)
            return conv2d(x, self.point_conv)
        if self.use_transpose:
            return conv_transpose2d(x, self.conv, stride=self.stride, dilation=self.dilation,
                                    output_padding=0)
        return conv2d(x, self.conv, stride=self.stride, dilation=self.dilation)

    def forward(self, x, train: bool = False):
        for op in self.ops:
            if op == "act":
                x = relu(x)
            elif op == "weight":
                x = self._weight(x)
            elif op == "norm":
                x = self.GroupNorm_0(x)
        return x


class CWeightOp(nn.Module):
    """SE channel gate; stride >= 2 adds a 3x3 (transposed) conv and
    GroupNorm after the gate (prim_ops_set.py:247-310). Its two Linear
    layers are xavier_normal with zero biases (weights_init)."""

    def __init__(self, c: int, c_out: int, stride: int = 1, use_transpose: bool = False):
        super().__init__()
        self.stride, self.use_transpose = stride, use_transpose
        mid = max(1, c // 16)
        self.Dense_0 = Dense(c, mid, bias=True)
        self.Dense_1 = Dense(mid, c_out, bias=True)
        if stride >= 2:
            if use_transpose:
                add_conv_kernel(self, "conv", (c, c_out, 3, 3))
                self.flax_layout = {"conv": "hwio_t"}
            else:
                add_conv_kernel(self, "conv", (c_out, c, 3, 3))
            self.GroupNorm_0 = GroupNorm(c_out, _gn_groups(c_out))

    def forward(self, x, train: bool = False):
        y = torch.sigmoid(self.Dense_1(relu(self.Dense_0(x.mean(dim=(2, 3))))))
        gated = x * y[:, :, None, None]
        if self.stride < 2:
            return gated
        if self.use_transpose:
            out = conv_transpose2d(gated, self.conv, stride=self.stride, output_padding=0)
        else:
            out = conv2d(gated, self.conv, stride=self.stride)
        return self.GroupNorm_0(out)


class PoolingOp(nn.Module):
    """2x2 stride-2 max or average pool, no padding."""

    def __init__(self, pool_type: str):
        super().__init__()
        self.pool_type = pool_type

    def forward(self, x, train: bool = False):
        if self.pool_type == "max":
            return F.max_pool2d(x, 2, 2)
        return F.avg_pool2d(x, 2, 2)


class ZeroOp(nn.Module):
    def forward(self, x, train: bool = False):
        return x * 0.0


class IdentityOp(nn.Module):
    def forward(self, x, train: bool = False):
        return x


def make_nasunet_op(name: str, c: int) -> nn.Module:
    table = {
        "none": lambda: ZeroOp(),
        "identity": lambda: IdentityOp(),
        "cweight": lambda: CWeightOp(c, c),
        "dil_conv": lambda: ConvOps(c, c, dilation=2),
        "dep_conv": lambda: ConvOps(c, c, use_depthwise=True),
        "shuffle_conv": lambda: ConvOps(c, c),
        "conv": lambda: ConvOps(c, c),
        "avg_pool": lambda: PoolingOp("avg"),
        "max_pool": lambda: PoolingOp("max"),
        "down_cweight": lambda: CWeightOp(c, c, stride=2),
        "down_dil_conv": lambda: ConvOps(c, c, stride=2, dilation=2),
        "down_dep_conv": lambda: ConvOps(c, c, stride=2, use_depthwise=True),
        "down_conv": lambda: ConvOps(c, c, stride=2),
        "up_cweight": lambda: CWeightOp(c, c, stride=2, use_transpose=True),
        "up_dep_conv": lambda: ConvOps(c, c, stride=2, use_transpose=True, use_depthwise=True),
        "up_conv": lambda: ConvOps(c, c, stride=2, use_transpose=True),
        "up_dil_conv": lambda: ConvOps(c, c, stride=2, dilation=2, use_transpose=True),
    }
    return table[name]()


def _nearest(x, th: int, tw: int):
    """torch F.interpolate(mode='nearest')'s convention in integers:
    src = floor(dst * in / out), exact at every ratio (senas_tpu's
    `_nearest`)."""
    h, w = x.shape[2], x.shape[3]
    yi = (torch.arange(th, device=x.device) * h) // th
    xi = (torch.arange(tw, device=x.device) * w) // tw
    return x[:, :, yi][:, :, :, xi]


def _match(h1, h2):
    """The smaller map resized to the larger (nas_unet.py:58-64)."""
    if h1.shape[2:] == h2.shape[2:]:
        return h1, h2
    b1, a1 = h1.shape[2], h1.shape[3]
    b2, a2 = h2.shape[2], h2.shape[3]
    if b1 > b2 or a1 > a2:
        h2 = _nearest(h2, b1, a1)
    else:
        h1 = _nearest(h1, b2, a2)
    return h1, h2


class NasUnetCell(nn.Module):
    def __init__(self, genotype: Genotype, c_in0: int, c_in1: int, c: int, cell_type: str):
        super().__init__()
        if cell_type == "down":
            self.preprocess0 = ConvOps(c_in0, c, kernel_size=1, stride=2,
                                       ops_order="act_weight_norm")
            names, idx = zip(*genotype.down)
            concat = genotype.down_concat
        else:
            self.preprocess0 = ConvOps(c_in0, c, kernel_size=1, ops_order="act_weight_norm")
            names, idx = zip(*genotype.up)
            concat = genotype.up_concat
        self.preprocess1 = ConvOps(c_in1, c, kernel_size=1, ops_order="act_weight_norm")
        self._indices = list(idx)
        self._concat = list(concat)
        self._num_meta_node = len(names) // 2
        for i, nm in enumerate(names):
            setattr(self, f"op_{i}", make_nasunet_op(nm, c))

    def forward(self, s0, s1, train: bool = False):
        states = [self.preprocess0(s0, train), self.preprocess1(s1, train)]
        for i in range(self._num_meta_node):
            h1 = getattr(self, f"op_{2 * i}")(states[self._indices[2 * i]], train)
            h2 = getattr(self, f"op_{2 * i + 1}")(states[self._indices[2 * i + 1]], train)
            h1, h2 = _match(h1, h2)
            states.append(h1 + h2)
        outs = [states[i] for i in self._concat]
        ref = outs[0]
        outs = [o if o.shape[2:] == ref.shape[2:] else _nearest(o, ref.shape[2], ref.shape[3])
                for o in outs]
        return torch.cat(outs, dim=1)


class NasUnet(nn.Module):
    """forward(x [B,H,W,in_channels], train) -> [logits [B,H,W,nclass]].
    Built on `device` (None means the card) with its kernels drawn from
    `generator` (a fixed seed when None)."""

    def __init__(self, nclass: int, in_channels: int, c: int = 32, depth: int = 5,
                 dtype=None, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if dtype is not None:
            raise NotImplementedError("bf16 is not ported yet (ROADMAP.md Queue 1, item 5)")
        dev = resolve_device(device)
        # every cell and stem is 4c wide: stem_multiplier 4, and the cells
        # concatenate 4 nodes of c (senas_tpu's double_down_channel, which
        # no caller sets, is not ported)
        wide = 4 * c
        self.stem0 = ConvOps(in_channels, wide, kernel_size=1, ops_order="weight_norm")
        self.stem1 = ConvOps(in_channels, wide, kernel_size=3, stride=2, ops_order="weight_norm")
        self.depth = depth
        for i in range(depth):
            setattr(self, f"down_{i}", NasUnetCell(NASUNET, wide, wide, c, "down"))
        for i in range(depth + 1):
            setattr(self, f"up_{i}", NasUnetCell(NASUNET, wide, wide, c, "up"))
        self.head = ConvOps(wide, nclass, kernel_size=1, ops_order="weight")
        init_params_(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.to(dev)

    def forward(self, x, train: bool = False, rng: Optional[torch.Generator] = None):
        x = x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
        s0, s1 = self.stem0(x, train), self.stem1(x, train)
        down_cs = [s0, s1]
        for i in range(self.depth):
            s0, s1 = s1, getattr(self, f"down_{i}")(s0, s1, train)
            down_cs.append(s1)
        for i in range(self.depth + 1):
            s1 = getattr(self, f"up_{i}")(down_cs[-(i + 2)], s1, train)
        return [self.head(s1, train).permute(0, 2, 3, 1)]
