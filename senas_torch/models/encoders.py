"""ResNet / ResNeXt encoders of the baseline zoo in PyTorch (NCHW inside).

Port of the resnet part of `senas_tpu/models/encoders.py` (the reference's
modified smp encoder stack): the custom `resnet10` (BasicBlock,
layers (1,1,1,1)) that every factory model uses, resnet18/34, and the
Bottleneck family (resnet50/101/152, resnext*) with `groups` and
`width_per_group`. Stages follow ResNetEncoder.get_stages (smp
encoders/resnet.py:47-56): [identity, conv7x7+bn+relu, maxpool+layer1,
layer2, layer3, layer4]; forward returns depth+1 feature maps. smp's
`make_dilated` (output stride 16 or 8) replaces a stage's strides by
dilation. Grouped convolutions are `F.conv2d(groups=)`.

The other encoder families of senas_tpu (VGG, DenseNet, MobileNet,
EfficientNet, SE-Net, Xception, Inception, DPN, ResNeSt, Res2Net, RegNet,
SK-Net, GERNet) are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from torch import nn

from senas_torch.ops.primitives import (BasicBlock, BatchNorm, add_conv_kernel, conv2d,
                                        max_pool_3x3, relu)

NEXT_SLICE = "ROADMAP.md Queue 1, M15b: the other encoder families"


def stage_dilation(stage: int, output_stride: int) -> int:
    """Dilation rate smp's ``EncoderMixin.make_dilated`` gives the 1-based
    pyramid `stage` (encoders/_base.py:35-53): output stride 16 dilates
    stage 5 by 2; output stride 8 dilates stages 4 and 5 by 2 and 4."""
    if output_stride == 32:
        return 1
    if output_stride == 16:
        return 2 if stage == 5 else 1
    if output_stride == 8:
        return {4: 2, 5: 4}.get(stage, 1)
    raise ValueError(
        "Output stride should be 16 or 8, got {}.".format(output_stride))


class Bottleneck(nn.Module):
    """torchvision Bottleneck (1x1 -> 3x3 (groups) -> 1x1, expansion 4).
    Returns the pre-activation sum; the encoder applies the ReLU."""

    expansion = 4

    def __init__(self, c_in: int, planes: int, stride: int = 1, dilation: int = 1,
                 groups: int = 1, width_per_group: int = 64, use_downsample: bool = False):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        width = int(planes * (width_per_group / 64.0)) * groups
        out = planes * self.expansion
        add_conv_kernel(self, "conv1", (width, c_in, 1, 1))
        self.bn1 = BatchNorm(width)
        add_conv_kernel(self, "conv2", (width, width // groups, 3, 3))
        self.bn2 = BatchNorm(width)
        add_conv_kernel(self, "conv3", (out, width, 1, 1))
        self.bn3 = BatchNorm(out)
        self.use_downsample = use_downsample
        if use_downsample:
            add_conv_kernel(self, "down_conv", (out, c_in, 1, 1))
            self.down_bn = BatchNorm(out)

    def forward(self, x, train: bool = False):
        out = relu(self.bn1(conv2d(x, self.conv1), train))
        out = conv2d(out, self.conv2, stride=self.stride, dilation=self.dilation,
                     groups=self.groups)
        out = relu(self.bn2(out, train))
        out = self.bn3(conv2d(out, self.conv3), train)
        residual = x
        if self.use_downsample:
            residual = self.down_bn(conv2d(x, self.down_conv, stride=self.stride), train)
        return out + residual


_WIDTHS = (64, 128, 256, 512)


class ResNetEncoder(nn.Module):
    """forward(x NCHW, train) -> [x, f1, ..., f_depth] (NCHW)."""

    def __init__(self, in_channels: int, layers: Sequence[int], depth: int = 5,
                 block: str = "basic", groups: int = 1, width_per_group: int = 64,
                 output_stride: int = 32):
        super().__init__()
        self.depth = depth
        self.out_channels = resnet_out_channels(in_channels, depth, block)
        if depth == 0:
            return
        add_conv_kernel(self, "conv1", (64, in_channels, 7, 7))
        self.bn1 = BatchNorm(64)
        self.stage_blocks: List[List[str]] = []
        c = 64
        for stage in range(2, depth + 1):
            gi = stage - 2
            dilation = stage_dilation(stage, output_stride)
            stride = 1 if stage == 2 or dilation > 1 else 2
            planes = _WIDTHS[gi]
            names = []
            for b in range(layers[gi]):
                s = stride if b == 0 else 1
                name = f"layer{gi + 1}_{b}"
                if block == "bottleneck":
                    out = planes * Bottleneck.expansion
                    blk = Bottleneck(c, planes, stride=s, dilation=dilation, groups=groups,
                                     width_per_group=width_per_group,
                                     use_downsample=s != 1 or c != out)
                else:
                    out = planes
                    blk = BasicBlock(c, planes, stride=s, dilation=dilation,
                                     use_downsample=s != 1 or c != out)
                setattr(self, name, blk)
                names.append(name)
                c = out
            self.stage_blocks.append(names)

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        x = relu(self.bn1(conv2d(x, self.conv1, stride=2), train))
        features.append(x)
        for i, names in enumerate(self.stage_blocks):
            if i == 0:
                x = max_pool_3x3(x, stride=2)
            for name in names:
                x = relu(getattr(self, name)(x, train))
            features.append(x)
        return features


_ENCODERS = {
    "resnet10": {"layers": (1, 1, 1, 1)},
    "resnet18": {"layers": (2, 2, 2, 2)},
    "resnet34": {"layers": (3, 4, 6, 3)},
    "resnet50": {"layers": (3, 4, 6, 3), "block": "bottleneck"},
    "resnet101": {"layers": (3, 4, 23, 3), "block": "bottleneck"},
    "resnet152": {"layers": (3, 8, 36, 3), "block": "bottleneck"},
    "resnext50_32x4d": {"layers": (3, 4, 6, 3), "block": "bottleneck",
                        "groups": 32, "width_per_group": 4},
    "resnext101_32x4d": {"layers": (3, 4, 23, 3), "block": "bottleneck",
                         "groups": 32, "width_per_group": 4},
    "resnext101_32x8d": {"layers": (3, 4, 23, 3), "block": "bottleneck",
                         "groups": 32, "width_per_group": 8},
    "resnext101_32x16d": {"layers": (3, 4, 23, 3), "block": "bottleneck",
                          "groups": 32, "width_per_group": 16},
    "resnext101_32x32d": {"layers": (3, 4, 23, 3), "block": "bottleneck",
                          "groups": 32, "width_per_group": 32},
    "resnext101_32x48d": {"layers": (3, 4, 23, 3), "block": "bottleneck",
                          "groups": 32, "width_per_group": 48},
}

# The names of senas_tpu's other registries (models/encoders_extra.py,
# encoders_families.py, encoders_mnv3.py, encoders_resnest.py,
# encoders_timm2.py) and its timm prefixes: known, not ported yet.
_UNPORTED_PREFIXES = (
    "vgg", "densenet", "mobilenet", "efficientnet", "timm-", "tu-", "se_resnet",
    "se_resnext", "senet", "xception", "inception", "dpn", "res2net", "res2next",
    "regnet", "skresnet", "skresnext", "gernet", "resnest")


def resnet_out_channels(in_channels: int, depth: int, block: str = "basic") -> Tuple[int, ...]:
    e = 1 if block == "basic" else Bottleneck.expansion
    return (in_channels, 64, 64 * e, 128 * e, 256 * e, 512 * e)[:depth + 1]


def get_encoder_names() -> List[str]:
    """The encoder names the port builds."""
    return list(_ENCODERS)


def get_encoder(name: str, depth: int = 5, dtype=None, output_stride: int = 32,
                weights: Optional[str] = None, in_channels: int = 3) -> ResNetEncoder:
    """The encoder `name` over `in_channels` input channels (the JAX package
    infers them from its first input; a torch module is built with them).
    senas_tpu's `dilate_last` alias of output_stride=16 has no caller and
    is not ported."""
    if weights is not None:
        # smp loads ImageNet weights by URL here (encoders/__init__.py:64-71)
        raise ValueError(
            f"pretrained weights {weights!r} are unavailable in this "
            "environment (no network egress); pass weights=None and "
            "initialize randomly, exactly as the reference does offline")
    if dtype is not None:
        raise NotImplementedError("bf16 is not ported yet (ROADMAP.md Queue 1, item 5)")
    if output_stride not in (8, 16, 32):
        raise ValueError(
            "Output stride should be 16 or 8, got {}.".format(output_stride))
    if name in _ENCODERS:
        return ResNetEncoder(in_channels, depth=depth, output_stride=output_stride,
                             **_ENCODERS[name])
    if name.startswith(_UNPORTED_PREFIXES):
        raise NotImplementedError(f"encoder {name!r} is not ported yet ({NEXT_SLICE})")
    raise KeyError(f"unknown encoder {name!r}; available: {sorted(_ENCODERS)}")


def encoder_out_channels(name: str, depth: int = 5, in_channels: int = 3) -> Tuple[int, ...]:
    """Per-stage channel pyramid of the named encoder (smp's
    `out_channels`): the channels of the depth+1 maps its forward returns.
    Names that `get_encoder` refuses raise the same here."""
    if name not in _ENCODERS:
        get_encoder(name, depth=depth, in_channels=in_channels)
    return resnet_out_channels(in_channels, depth, _ENCODERS[name].get("block", "basic"))
