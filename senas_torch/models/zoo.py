"""Baseline segmentation-model zoo in PyTorch: Unet, Unet++, MAnet, Linknet,
FPN, PSPNet, DeepLabV3+, PAN.

Port of `senas_tpu/models/zoo.py` (the reference's vendored smp
*/decoder.py) over the encoders of `models/encoders.py` (every name
senas_tpu builds). Every model
is a `SegmentationModel`: NHWC in, a singleton list of NHWC logits out
(`([masks], labels)` with `aux_params`), NCHW inside. A torch module is
built with its channel counts, so each model plans its decoder's widths
from the encoder's pyramid (`encoder_out_channels`) where the flax modules
read them off their inputs. Submodules and parameters carry the flax names
(`dec_{i}`, `x_{d}_{l}`, `PAB_0`, `ASPP_0`, `FPABlock_0`, `gau{k}`, ...),
and weights are drawn from `generator` by the JAX package's init rules.

Where senas_tpu departs from smp, the port follows senas_tpu:
  * bilinear resizes are align_corners=True;
  * PSPNet pools a map that the pool size does not divide with
    jax.image.resize's antialiased linear filter, not smp's
    AdaptiveAvgPool2d (ROADMAP.md Queue 3, F3);
  * FPN's GroupNorm has eps 1e-5; Linknet's transposed conv output_padding
    0; DeepLabV3+'s ASPP applies Dropout(0.5) in train mode.

`dtype` (torch.bfloat16, or None for f32) is each model's compute dtype,
with f32 weights, as in senas_tpu: the encoder's blocks cast their input
to it, and every BatchNorm and GroupNorm rounds its output to it; a conv
runs in its input's dtype. senas_tpu's align-corners resizes keep f32
weights, so a bf16 map leaves them in f32 and the blocks after one compute
in f32 until the next norm: FPN and PAN return f32 logits from a bf16
model, the other seven bf16 ones, as senas_tpu's do.

Under the mesh's row split (ROADMAP.md M13c) each map is this rank's block
of image rows, and every target size is the level's global one
(`global_height`). The global pools' 1x1 maps and PSPNet's pyramid are
whole on every rank (`whole_maps`: their BatchNorms reduce over the data
subgroup); MAnet's position attention and PSPNet's pooling read the whole
deepest level (`whole_level`, a gather), and each rank resizes or cuts the
result back to its own rows.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from senas_torch.models.base import (Attention, Conv2dReLU, SegmentationHead,
                                     SegmentationModel, resize_bilinear, upsample_nearest2x)
from senas_torch.models.encoders import encoder_out_channels, get_encoder
from senas_torch.ops.primitives import (BatchNorm, Dropout, GroupNorm, add_bias,
                                        add_conv_kernel, conv2d, conv_transpose2d, image_mean,
                                        max_pool_2x2, on_whole_level, relu, sigmoid, softmax,
                                        whole_level)
from senas_torch.ops.resize import PSP_SIZES, adaptive_avg_pool
from senas_torch.parallel.collectives import global_height, whole_maps


def _bias(b, like):
    """A [C] bias against an NCHW map, in the map's dtype."""
    return b.to(like.dtype)[:, None, None]


def _conv(x, w, **kw):
    """conv2d with the f32 kernel cast to x's dtype."""
    return conv2d(x, w.to(x.dtype), **kw)


def _aligned_resize(x, size_hw, whole: bool = False):
    """senas_tpu's `_resize_bilinear` with align_corners=True: f32 weights,
    so a bf16 map comes out f32 (a 1x1 map is broadcast in its dtype).
    `size_hw` is global; `whole`: x is a map every rank holds whole
    (`resize_bilinear`)."""
    return resize_bilinear(x, size_hw, weight_dtype=torch.float32, whole=whole)


def _pooled(block, x, train):
    """block (a conv -> BN stack) on x's global mean [B, C, 1, 1], a map
    that every rank of a data index computes whole (`whole_maps`)."""
    mean = image_mean(x)[:, :, None, None]
    with whole_maps():
        return block(mean, train)


# ---------------------------------------------------------------------------
# U-Net (unet/decoder.py:8-121)
# ---------------------------------------------------------------------------

class UnetDecoderBlock(nn.Module):
    """nearest 2x -> [concat skip -> attention] -> 2 x Conv2dReLU -> attention."""

    def __init__(self, c_in: int, c_skip: int, c_out: int,
                 attention_type: Optional[str] = None, dtype=None):
        super().__init__()
        # flax numbers the attentions it makes: the skip's only with a skip
        self.attentions = ("Attention_0", "Attention_1") if c_skip else (None, "Attention_0")
        if c_skip:
            self.Attention_0 = Attention(c_in + c_skip, attention_type, dtype=dtype)
        setattr(self, self.attentions[1], Attention(c_out, attention_type, dtype=dtype))
        self.Conv2dReLU_0 = Conv2dReLU(c_in + c_skip, c_out, dtype=dtype)
        self.Conv2dReLU_1 = Conv2dReLU(c_out, c_out, dtype=dtype)

    def forward(self, x, skip=None, train: bool = False):
        x = upsample_nearest2x(x)
        if skip is not None:
            x = getattr(self, self.attentions[0])(torch.cat([x, skip], dim=1))
        x = self.Conv2dReLU_1(self.Conv2dReLU_0(x, train), train)
        return getattr(self, self.attentions[1])(x)


def _pyramid(encoder_name: str, in_channels: int, depth: int) -> List[int]:
    """Channels of the encoder's maps deepest first, without the input
    (the decoders' `feats = enc_feats[1:][::-1]`)."""
    return list(encoder_out_channels(encoder_name, depth, in_channels)[1:][::-1])


class Unet(SegmentationModel):
    def __init__(self, classes: int, in_channels: int = 3, encoder_name: str = "resnet10",
                 encoder_depth: int = 5, decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 decoder_attention_type: Optional[str] = None, activation: Optional[Any] = None,
                 aux_params: Optional[dict] = None, dtype=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = get_encoder(encoder_name, encoder_depth, dtype, in_channels=in_channels)
        feats = _pyramid(encoder_name, in_channels, encoder_depth)
        skips = feats[1:]
        self.n_dec = len(decoder_channels)
        c = feats[0]
        for i, c_out in enumerate(decoder_channels):
            c_skip = skips[i] if i < len(skips) else 0
            setattr(self, f"dec_{i}", UnetDecoderBlock(c, c_skip, c_out, decoder_attention_type,
                                                       dtype))
            c = c_out
        self.SegmentationHead_0 = SegmentationHead(c, classes)
        self._finish_init(aux_params, feats[0], activation, device, generator, dtype)

    def decode(self, x, train, rng):
        enc = self.encoder(x, train)
        feats = enc[1:][::-1]
        y, skips = feats[0], feats[1:]
        for i in range(self.n_dec):
            y = getattr(self, f"dec_{i}")(y, skips[i] if i < len(skips) else None, train)
        return self.SegmentationHead_0(y), enc


# ---------------------------------------------------------------------------
# U-Net++ (unetplusplus/decoder.py:65-136)
# ---------------------------------------------------------------------------

def _unetpp_plan(n: int) -> List[Tuple[str, Any, List[Any], str, int]]:
    """The nested decoder's blocks in call order, for `n` decoder widths:
    (block name, its input, its skip parts, which out-channel table, index).
    An input or a skip part is ("f", i) for feats[i] or ("x", name) for an
    earlier block's output; senas_tpu/models/zoo.py:111-140."""
    depth = n - 1
    plan = []
    for layer_idx in range(depth):
        for depth_idx in range(depth - layer_idx):
            if layer_idx == 0:
                plan.append((f"x_{depth_idx}_{depth_idx}", ("f", depth_idx),
                             [("f", depth_idx + 1)],
                             "out" if depth_idx == 0 else "skip", depth_idx))
            else:
                li = depth_idx + layer_idx
                cat = [("x", f"x_{idx}_{li}") for idx in range(depth_idx + 1, li + 1)]
                plan.append((f"x_{depth_idx}_{li}", ("x", f"x_{depth_idx}_{li - 1}"),
                             cat + [("f", li + 1)], "out" if depth_idx == 0 else "skip", li))
    plan.append((f"x_0_{depth}", ("x", f"x_0_{depth - 1}"), [], "out", -1))
    return plan


class UnetPlusPlus(SegmentationModel):
    def __init__(self, classes: int, in_channels: int = 3, encoder_name: str = "resnet10",
                 encoder_depth: int = 5, decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 decoder_attention_type: Optional[str] = None, activation: Optional[Any] = None,
                 aux_params: Optional[dict] = None, dtype=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = get_encoder(encoder_name, encoder_depth, dtype, in_channels=in_channels)
        feats = _pyramid(encoder_name, in_channels, encoder_depth)
        table = {"out": list(decoder_channels), "skip": feats[1:] + [0]}
        self.plan = _unetpp_plan(len(decoder_channels))
        ch: Dict[Any, int] = {("f", i): c for i, c in enumerate(feats)}
        for name, src, parts, which, idx in self.plan:
            c_out = table[which][idx]
            setattr(self, name, UnetDecoderBlock(ch[src], sum(ch[p] for p in parts), c_out,
                                                 decoder_attention_type, dtype))
            ch[("x", name)] = c_out
        self.SegmentationHead_0 = SegmentationHead(decoder_channels[-1], classes)
        self._finish_init(aux_params, feats[0], activation, device, generator, dtype)

    def decode(self, x, train, rng):
        enc = self.encoder(x, train)
        out: Dict[Any, torch.Tensor] = {("f", i): f for i, f in enumerate(enc[1:][::-1])}
        y = None
        for name, src, parts, _, _ in self.plan:
            skip = torch.cat([out[p] for p in parts], dim=1) if parts else None
            y = out[("x", name)] = getattr(self, name)(out[src], skip, train)
        return self.SegmentationHead_0(y), enc


# ---------------------------------------------------------------------------
# MAnet (manet/decoder.py)
# ---------------------------------------------------------------------------

class PAB(nn.Module):
    """Position-attention block (manet/decoder.py:7-37)."""

    def __init__(self, c: int, pab_channels: int = 64):
        super().__init__()
        self.pab_channels = pab_channels
        for name, cout, k in (("top", pab_channels, 1), ("center", pab_channels, 1),
                              ("bottom", c, 3)):
            add_conv_kernel(self, name, (cout, c, k, k))
            add_bias(self, name + "_b", cout)
        add_conv_kernel(self, "out", (c, c, 3, 3))
        add_bias(self, "out_bias", c)

    def forward(self, x):
        b, c, h, w = x.shape
        hw, pc = h * w, self.pab_channels
        proj = lambda name: _conv(x, getattr(self, name)) + _bias(getattr(self, name + "_b"), x)
        top = proj("top").reshape(b, pc, hw).transpose(1, 2)
        center = proj("center").reshape(b, pc, hw).transpose(1, 2)
        bottom = proj("bottom").reshape(b, c, hw).transpose(1, 2)
        sp = torch.bmm(center, top.transpose(1, 2))              # [B, HW, HW]
        sp = softmax(sp.reshape(b, -1)).reshape(b, hw, hw)
        attn = torch.bmm(sp, bottom)                             # [B, HW, C]
        # the reference's quirk (manet/decoder.py:34): the [B,HW,C] map is
        # reshaped to (B,C,H,W) without a transpose
        y = x + attn.reshape(b, c, h, w)
        return _conv(y, self.out) + _bias(self.out_bias, y)


class MFAB(nn.Module):
    """Multi-scale fusion attention block (manet/decoder.py:40-101)."""

    def __init__(self, c_in: int, skip_channels: int, c_out: int, reduction: int = 16,
                 dtype=None):
        super().__init__()
        sc = skip_channels
        red = max(1, sc // reduction)
        self.Conv2dReLU_0 = Conv2dReLU(c_in, c_in, dtype=dtype)
        self.Conv2dReLU_1 = Conv2dReLU(c_in, sc, kernel_size=1, dtype=dtype)
        for tag in ("hl", "ll"):
            add_conv_kernel(self, f"{tag}_w1", (red, sc, 1, 1))
            add_bias(self, f"{tag}_b1", red)
            add_conv_kernel(self, f"{tag}_w2", (sc, red, 1, 1))
            add_bias(self, f"{tag}_b2", sc)
        self.Conv2dReLU_2 = Conv2dReLU(2 * sc, c_out, dtype=dtype)
        self.Conv2dReLU_3 = Conv2dReLU(c_out, c_out, dtype=dtype)

    def _se(self, t, tag):
        """The SE gate in t's dtype (senas_tpu casts the weights to it)."""
        y = image_mean(t)
        w1, w2 = (getattr(self, f"{tag}_{k}").to(t.dtype) for k in ("w1", "w2"))
        b1, b2 = (getattr(self, f"{tag}_{k}").to(t.dtype) for k in ("b1", "b2"))
        y = relu(y @ w1[:, :, 0, 0].t() + b1)
        y = sigmoid(y @ w2[:, :, 0, 0].t() + b2)
        return y[:, :, None, None]

    def forward(self, x, skip, train: bool = False):
        x = self.Conv2dReLU_1(self.Conv2dReLU_0(x, train), train)
        x = upsample_nearest2x(x)
        x = x * (self._se(x, "hl") + self._se(skip, "ll"))
        x = torch.cat([x, skip], dim=1)
        return self.Conv2dReLU_3(self.Conv2dReLU_2(x, train), train)


class MAnet(SegmentationModel):
    def __init__(self, classes: int, in_channels: int = 3, encoder_name: str = "resnet10",
                 encoder_depth: int = 5, decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 pab_channels: int = 64, activation: Optional[Any] = None,
                 aux_params: Optional[dict] = None, dtype=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = get_encoder(encoder_name, encoder_depth, dtype, in_channels=in_channels)
        feats = _pyramid(encoder_name, in_channels, encoder_depth)
        skips = feats[1:]
        self.PAB_0 = PAB(feats[0], pab_channels)
        self.n_dec = len(decoder_channels)
        c = feats[0]
        for i, c_out in enumerate(decoder_channels):
            blk = (MFAB(c, skips[i], c_out, dtype=dtype) if i < len(skips)
                   else UnetDecoderBlock(c, 0, c_out, dtype=dtype))
            setattr(self, f"dec_{i}", blk)
            c = c_out
        self.SegmentationHead_0 = SegmentationHead(c, classes)
        self._finish_init(aux_params, feats[0], activation, device, generator, dtype)

    def decode(self, x, train, rng):
        enc = self.encoder(x, train)
        feats = enc[1:][::-1]
        y, skips = on_whole_level(self.PAB_0, feats[0]), feats[1:]
        for i in range(self.n_dec):
            blk = getattr(self, f"dec_{i}")
            y = blk(y, skips[i], train) if i < len(skips) else blk(y, None, train)
        return self.SegmentationHead_0(y), enc


# ---------------------------------------------------------------------------
# Linknet (linknet/decoder.py)
# ---------------------------------------------------------------------------

class LinknetBlock(nn.Module):
    """1x1 Conv2dReLU -> 4x4 stride-2 transposed conv (+bias) -> BN -> ReLU
    -> 1x1 Conv2dReLU [-> + skip]."""

    def __init__(self, c_in: int, c_out: int, dtype=None):
        super().__init__()
        mid = c_in // 4
        self.Conv2dReLU_0 = Conv2dReLU(c_in, mid, kernel_size=1, dtype=dtype)
        add_conv_kernel(self, "tkernel", (mid, mid, 4, 4))
        self.flax_layout = {"tkernel": "hwio_t"}
        add_bias(self, "tbias", mid, fan_in=mid * 16)
        self.BatchNorm_0 = BatchNorm(mid, dtype=dtype)
        self.Conv2dReLU_1 = Conv2dReLU(mid, c_out, kernel_size=1, dtype=dtype)

    def forward(self, x, skip=None, train: bool = False):
        x = self.Conv2dReLU_0(x, train)
        x = conv_transpose2d(x, self.tkernel.to(x.dtype), stride=2, output_padding=0,
                             torch_padding=1) + _bias(self.tbias, x)
        x = self.Conv2dReLU_1(relu(self.BatchNorm_0(x, train)), train)
        return x + skip if skip is not None else x


class Linknet(SegmentationModel):
    def __init__(self, classes: int, in_channels: int = 3, encoder_name: str = "resnet10",
                 encoder_depth: int = 5, prefinal_channels: int = 32,
                 activation: Optional[Any] = None, aux_params: Optional[dict] = None,
                 dtype=None, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = get_encoder(encoder_name, encoder_depth, dtype, in_channels=in_channels)
        feats = _pyramid(encoder_name, in_channels, encoder_depth)
        channels = feats + [prefinal_channels]
        self.n_dec = encoder_depth
        for i in range(encoder_depth):
            setattr(self, f"dec_{i}", LinknetBlock(channels[i], channels[i + 1], dtype))
        self.SegmentationHead_0 = SegmentationHead(prefinal_channels, classes)
        self._finish_init(aux_params, feats[0], activation, device, generator, dtype)

    def decode(self, x, train, rng):
        enc = self.encoder(x, train)
        feats = enc[1:][::-1]
        y, skips = feats[0], feats[1:]
        for i in range(self.n_dec):
            y = getattr(self, f"dec_{i}")(y, skips[i] if i < len(skips) else None, train)
        return self.SegmentationHead_0(y), enc


# ---------------------------------------------------------------------------
# FPN (fpn/decoder.py)
# ---------------------------------------------------------------------------

class Conv3x3GNReLU(nn.Module):
    """3x3 conv (in x's dtype) -> GroupNorm(32, eps 1e-5; rounds to
    `dtype`) -> ReLU [-> bilinear 2x with f32 weights]."""

    def __init__(self, c_in: int, c_out: int, upsample: bool = False, dtype=None):
        super().__init__()
        self.upsample = upsample
        add_conv_kernel(self, "kernel", (c_out, c_in, 3, 3))
        self.GroupNorm_0 = GroupNorm(c_out, 32, dtype=dtype)

    def forward(self, x):
        x = relu(self.GroupNorm_0(_conv(x, self.kernel)))
        if self.upsample:
            x = _aligned_resize(x, (global_height(x) * 2, x.shape[3] * 2))
        return x


class FPN(SegmentationModel):
    def __init__(self, classes: int, in_channels: int = 3, encoder_name: str = "resnet10",
                 encoder_depth: int = 5, pyramid_channels: int = 256,
                 segmentation_channels: int = 128,
                 upsampling: int = 4, activation: Optional[Any] = None,
                 aux_params: Optional[dict] = None, dtype=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = get_encoder(encoder_name, encoder_depth, dtype, in_channels=in_channels)
        full = encoder_out_channels(encoder_name, encoder_depth, in_channels)
        c2, c3, c4, c5 = full[-4:]
        pc, sc = pyramid_channels, segmentation_channels
        for name, c in (("p5", c5), ("p4_skip", c4), ("p3_skip", c3), ("p2_skip", c2)):
            add_conv_kernel(self, name, (pc, c, 1, 1))
            add_bias(self, name + "_b", pc)
        for i, ups in enumerate((3, 2, 1, 0)):
            setattr(self, f"seg_{i}_0", Conv3x3GNReLU(pc, sc, upsample=bool(ups), dtype=dtype))
            for j in range(1, ups):
                setattr(self, f"seg_{i}_{j}", Conv3x3GNReLU(sc, sc, upsample=True, dtype=dtype))
        # the "add" merge (senas_tpu's "cat" option has no caller)
        self.SegmentationHead_0 = SegmentationHead(sc, classes, upsampling=upsampling)
        self._finish_init(aux_params, c5, activation, device, generator, dtype)

    def _p(self, name, t):
        return _conv(t, getattr(self, name)) + _bias(getattr(self, name + "_b"), t)

    def decode(self, x, train, rng):
        feats = self.encoder(x, train)
        c2, c3, c4, c5 = feats[-4:]
        p5 = self._p("p5", c5)
        p4 = upsample_nearest2x(p5) + self._p("p4_skip", c4)
        p3 = upsample_nearest2x(p4) + self._p("p3_skip", c3)
        p2 = upsample_nearest2x(p3) + self._p("p2_skip", c2)
        outs = []
        for i, (p, ups) in enumerate(zip((p5, p4, p3, p2), (3, 2, 1, 0))):
            y = getattr(self, f"seg_{i}_0")(p)
            for j in range(1, ups):
                y = getattr(self, f"seg_{i}_{j}")(y)
            outs.append(y)
        return self.SegmentationHead_0(sum(outs)), feats


# ---------------------------------------------------------------------------
# PSPNet (pspnet/decoder.py)
# ---------------------------------------------------------------------------

# the pyramid's pooling to size x size, as senas_tpu does it (models/zoo.py:
# 414-419): smp's AdaptiveAvgPool2d differs where size does not divide the map
psp_pool = adaptive_avg_pool


class PSPNet(SegmentationModel):
    def __init__(self, classes: int, in_channels: int = 3, encoder_name: str = "resnet10",
                 encoder_depth: int = 5, psp_out_channels: int = 512, upsampling: int = 8,
                 activation: Optional[Any] = None, aux_params: Optional[dict] = None,
                 dtype=None, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = get_encoder(encoder_name, encoder_depth, dtype, in_channels=in_channels)
        c = encoder_out_channels(encoder_name, encoder_depth, in_channels)[-1]
        for si, size in enumerate(PSP_SIZES):
            setattr(self, f"psp_{si}", Conv2dReLU(c, c // len(PSP_SIZES), kernel_size=1,
                                                  use_batchnorm=size != 1, dtype=dtype))
        self.Conv2dReLU_0 = Conv2dReLU(c + len(PSP_SIZES) * (c // len(PSP_SIZES)),
                                       psp_out_channels, kernel_size=1, dtype=dtype)
        self.SegmentationHead_0 = SegmentationHead(psp_out_channels, classes,
                                                   upsampling=upsampling)
        self._finish_init(aux_params, c, activation, device, generator, dtype)

    def decode(self, x, train, rng):
        feats = self.encoder(x, train)
        y = feats[-1]
        h, w = global_height(y), y.shape[3]
        # the pyramid pools the whole map on every rank (a gather under a
        # row split), and each rank resizes the branches into its own rows
        full = whole_level(y)
        with whole_maps():
            pooled = [getattr(self, f"psp_{si}")(psp_pool(full, size), train)
                      for si, size in enumerate(PSP_SIZES)]
        branches = [_aligned_resize(p, (h, w), whole=True) for p in pooled]
        y = self.Conv2dReLU_0(torch.cat(branches + [y], dim=1), train)
        return self.SegmentationHead_0(y), feats


# ---------------------------------------------------------------------------
# DeepLabV3+ (deeplabv3/decoder.py:54-195)
# ---------------------------------------------------------------------------

class _SeparableConvBnReLU(nn.Module):
    """depthwise kxk (dilated) -> pointwise 1x1 -> BN -> ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3, dilation: int = 1,
                 dtype=None):
        super().__init__()
        self.dilation, self.c_in = dilation, c_in
        add_conv_kernel(self, "dw", (c_in, 1, kernel_size, kernel_size))
        add_conv_kernel(self, "pw", (c_out, c_in, 1, 1))
        self.BatchNorm_0 = BatchNorm(c_out, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = _conv(x, self.dw, dilation=self.dilation, groups=self.c_in)
        return relu(self.BatchNorm_0(_conv(x, self.pw), train))


class ASPP(nn.Module):
    """1x1 branch, three separable atrous branches, the image-pool branch,
    the 1x1 projection, then Dropout(0.5) in train mode (senas_tpu's ASPP
    as DeepLabV3+ builds it: separable; its dense-branch option has no
    caller)."""

    def __init__(self, c_in: int, c_out: int, atrous_rates: Tuple[int, int, int] = (12, 24, 36),
                 dtype=None):
        super().__init__()
        self.c_out, self.n_rates = c_out, len(atrous_rates)
        self.conv1x1 = Conv2dReLU(c_in, c_out, kernel_size=1, dtype=dtype)
        for i, rate in enumerate(atrous_rates):
            setattr(self, f"aspp_{i}", _SeparableConvBnReLU(c_in, c_out, 3, rate, dtype))
        self.pool_conv = Conv2dReLU(c_in, c_out, kernel_size=1, dtype=dtype)
        self.project = Conv2dReLU((2 + len(atrous_rates)) * c_out, c_out, kernel_size=1,
                                  dtype=dtype)
        self.dropout = Dropout(0.5)

    def forward(self, x, train: bool = False, rng: Optional[torch.Generator] = None):
        b, _, h, w = x.shape
        res = [self.conv1x1(x, train)]
        res += [getattr(self, f"aspp_{i}")(x, train) for i in range(self.n_rates)]
        res.append(_pooled(self.pool_conv, x, train).expand(b, self.c_out, h, w))
        y = self.project(torch.cat(res, dim=1), train)
        return self.dropout(y, train, rng)


class DeepLabV3Plus(SegmentationModel):
    def __init__(self, classes: int, in_channels: int = 3, encoder_name: str = "resnet10",
                 encoder_depth: int = 5, decoder_channels: int = 256,
                 atrous_rates: Tuple[int, int, int] = (12, 24, 36), output_stride: int = 16,
                 upsampling: int = 4, activation: Optional[Any] = None,
                 aux_params: Optional[dict] = None, dtype=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if output_stride not in (8, 16):
            raise ValueError("Encoder output stride should be 8 or 16, "
                             "got {}".format(output_stride))
        self.scale = 2 if output_stride == 8 else 4
        self.encoder = get_encoder(encoder_name, encoder_depth, dtype,
                                   output_stride=output_stride, in_channels=in_channels)
        full = encoder_out_channels(encoder_name, encoder_depth, in_channels)
        dc = decoder_channels
        self.ASPP_0 = ASPP(full[-1], dc, atrous_rates, dtype)
        self.aspp_post = _SeparableConvBnReLU(dc, dc, dtype=dtype)
        self.highres = Conv2dReLU(full[-4], 48, kernel_size=1, dtype=dtype)
        self.fuse = _SeparableConvBnReLU(dc + 48, dc, dtype=dtype)
        self.SegmentationHead_0 = SegmentationHead(dc, classes, upsampling=upsampling)
        self._finish_init(aux_params, full[-1], activation, device, generator, dtype)

    def decode(self, x, train, rng):
        feats = self.encoder(x, train)
        y = self.aspp_post(self.ASPP_0(feats[-1], train, rng), train)
        y = _aligned_resize(y, (global_height(y) * self.scale, y.shape[3] * self.scale))
        y = torch.cat([y, self.highres(feats[-4], train)], dim=1)
        return self.SegmentationHead_0(self.fuse(y, train)), feats


# ---------------------------------------------------------------------------
# PAN (pan/decoder.py)
# ---------------------------------------------------------------------------

class ConvBnReLU(nn.Module):
    """conv (+bias, torch's default init) -> BN [-> ReLU]."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 1, add_relu: bool = True,
                 dtype=None):
        super().__init__()
        k = kernel_size
        self.add_relu = add_relu
        add_conv_kernel(self, "kernel", (c_out, c_in, k, k))
        add_bias(self, "bias", c_out, fan_in=c_in * k * k)
        self.BatchNorm_0 = BatchNorm(c_out, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = self.BatchNorm_0(_conv(x, self.kernel) + _bias(self.bias, x), train)
        return relu(x) if self.add_relu else x


class FPABlock(nn.Module):
    """Feature pyramid attention: global-pool, mid and 3-level pyramid
    branches (pan/decoder.py:41-99)."""

    def __init__(self, c_in: int, c_out: int, dtype=None):
        super().__init__()
        self.c_out = c_out
        self.branch1 = ConvBnReLU(c_in, c_out, 1, dtype=dtype)
        self.mid = ConvBnReLU(c_in, c_out, 1, dtype=dtype)
        self.down1 = ConvBnReLU(c_in, 1, 7, dtype=dtype)
        self.down2 = ConvBnReLU(1, 1, 5, dtype=dtype)
        self.down3a = ConvBnReLU(1, 1, 3, dtype=dtype)
        self.down3b = ConvBnReLU(1, 1, 3, dtype=dtype)
        self.conv2 = ConvBnReLU(1, 1, 5, dtype=dtype)
        self.conv1 = ConvBnReLU(1, 1, 7, dtype=dtype)

    def forward(self, x, train: bool = False):
        b, _, rows, w = x.shape
        h = global_height(x)
        b1 = _pooled(self.branch1, x, train).expand(b, self.c_out, rows, w)
        mid = self.mid(x, train)
        x1 = self.down1(max_pool_2x2(x), train)
        x2 = self.down2(max_pool_2x2(x1), train)
        x3 = self.down3b(self.down3a(max_pool_2x2(x2), train), train)
        x3 = _aligned_resize(x3, (h // 4, w // 4))
        y = self.conv2(x2, train) + x3
        y = _aligned_resize(y, (h // 2, w // 2))
        y = y + self.conv1(x1, train)
        y = _aligned_resize(y, (h, w))
        return y * mid + b1


class GAUBlock(nn.Module):
    """Global attention upsample (pan/decoder.py:102-140)."""

    def __init__(self, c_in: int, c_out: int, dtype=None):
        super().__init__()
        self.conv2 = ConvBnReLU(c_in, c_out, 3, dtype=dtype)
        self.conv1 = ConvBnReLU(c_out, c_out, 1, add_relu=False, dtype=dtype)

    def forward(self, x, y, train: bool = False):
        y_up = _aligned_resize(y, (global_height(x), x.shape[3]))
        x = self.conv2(x, train)
        ya = sigmoid(_pooled(self.conv1, y, train))
        return y_up + x * ya


class PAN(SegmentationModel):
    def __init__(self, classes: int, in_channels: int = 3, encoder_name: str = "resnet10",
                 encoder_depth: int = 5, encoder_output_stride: int = 16,
                 decoder_channels: int = 32, upsampling: int = 4,
                 activation: Optional[Any] = None, aux_params: Optional[dict] = None,
                 dtype=None, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if encoder_output_stride not in (16, 32):
            raise ValueError("PAN support output stride 16 or 32, got "
                             "{}".format(encoder_output_stride))
        self.encoder = get_encoder(encoder_name, encoder_depth, dtype,
                                   output_stride=encoder_output_stride, in_channels=in_channels)
        full = encoder_out_channels(encoder_name, encoder_depth, in_channels)
        dc = decoder_channels
        self.FPABlock_0 = FPABlock(full[-1], dc, dtype)
        self.gau3 = GAUBlock(full[-2], dc, dtype)
        self.gau2 = GAUBlock(full[-3], dc, dtype)
        self.gau1 = GAUBlock(full[-4], dc, dtype)
        self.SegmentationHead_0 = SegmentationHead(dc, classes, upsampling=upsampling)
        self._finish_init(aux_params, full[-1], activation, device, generator, dtype)

    def decode(self, x, train, rng):
        feats = self.encoder(x, train)
        y = self.FPABlock_0(feats[-1], train)
        y = self.gau3(feats[-2], y, train)
        y = self.gau2(feats[-3], y, train)
        y = self.gau1(feats[-4], y, train)
        return self.SegmentationHead_0(y), feats
