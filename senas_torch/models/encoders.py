"""The encoders of the baseline zoo in PyTorch (NCHW inside), and their
registry.

Port of `senas_tpu/models/encoders.py` (the reference's modified smp
encoder stack). This file holds the resnet family: the custom `resnet10`
(BasicBlock, layers (1,1,1,1)) that every factory model uses, resnet18/34,
and the Bottleneck family (resnet50/101/152, resnext*) with `groups` and
`width_per_group`. Stages follow ResNetEncoder.get_stages (smp
encoders/resnet.py:47-56): [identity, conv7x7+bn+relu, maxpool+layer1,
layer2, layer3, layer4]; forward returns depth+1 feature maps. smp's
`make_dilated` (output stride 16 or 8) replaces a stage's strides by
dilation. Grouped convolutions are `F.conv2d(groups=)`.

`get_encoder` also builds the families of `encoders_extra.py` (VGG,
DenseNet, MobileNetV2, EfficientNet), `encoders_families.py` (SE-Net,
Xception, InceptionV4, InceptionResNetV2, DPN), `encoders_resnest.py`
(ResNeSt), `encoders_timm2.py` (Res2Net, RegNet X/Y, SK-Net, GERNet) and
`encoders_mnv3.py` (MobileNetV3), and the `tu-` names that resolve to one
of them: every encoder name of senas_tpu, in its order. Every one of them
runs under the mesh's image-H split: its convs, pools and means go through
`primitives`, which take their row-shard forms there.
"""

from __future__ import annotations

import functools
import inspect
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from senas_torch.ops.primitives import (BasicBlock, BatchNorm, add_conv_kernel, cast, conv2d,
                                        max_pool_3x3, relu)

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
    Returns the pre-activation sum; the encoder applies the ReLU. x is cast
    to `dtype` on entry, the kernels at use."""

    expansion = 4

    def __init__(self, c_in: int, planes: int, stride: int = 1, dilation: int = 1,
                 groups: int = 1, width_per_group: int = 64, use_downsample: bool = False,
                 dtype=None):
        super().__init__()
        self.stride, self.dilation, self.groups, self.dtype = stride, dilation, groups, dtype
        width = int(planes * (width_per_group / 64.0)) * groups
        out = planes * self.expansion
        add_conv_kernel(self, "conv1", (width, c_in, 1, 1))
        self.bn1 = BatchNorm(width, dtype=dtype)
        add_conv_kernel(self, "conv2", (width, width // groups, 3, 3))
        self.bn2 = BatchNorm(width, dtype=dtype)
        add_conv_kernel(self, "conv3", (out, width, 1, 1))
        self.bn3 = BatchNorm(out, dtype=dtype)
        self.use_downsample = use_downsample
        if use_downsample:
            add_conv_kernel(self, "down_conv", (out, c_in, 1, 1))
            self.down_bn = BatchNorm(out, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = cast(x, self.dtype)
        out = relu(self.bn1(conv2d(x, self.conv1.to(x.dtype)), train))
        out = conv2d(out, self.conv2.to(out.dtype), stride=self.stride, dilation=self.dilation,
                     groups=self.groups)
        out = relu(self.bn2(out, train))
        out = self.bn3(conv2d(out, self.conv3.to(out.dtype)), train)
        residual = x
        if self.use_downsample:
            residual = self.down_bn(conv2d(x, self.down_conv.to(x.dtype), stride=self.stride),
                                    train)
        return out + residual


_WIDTHS = (64, 128, 256, 512)


class ResNetEncoder(nn.Module):
    """forward(x NCHW, train) -> [x, f1, ..., f_depth] (NCHW). The stem's
    7x7 conv runs in x's dtype and its BN rounds to `dtype`; each block
    casts its input to `dtype` (senas_tpu/models/encoders.py:118-123,
    ops/primitives.py:612-614). Every op goes through `primitives`, so it
    runs under a row split."""

    def __init__(self, in_channels: int, layers: Sequence[int], depth: int = 5,
                 block: str = "basic", groups: int = 1, width_per_group: int = 64,
                 dilate_last: bool = False, output_stride: int = 32, dtype=None):
        super().__init__()
        self.depth = depth
        if depth == 0:
            return
        # dilate_last: senas_tpu's alias of output_stride=16 (smp's
        # make_dilated for DeepLabV3+)
        if dilate_last and output_stride == 32:
            output_stride = 16
        add_conv_kernel(self, "conv1", (64, in_channels, 7, 7))
        self.bn1 = BatchNorm(64, dtype=dtype)
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
                                     use_downsample=s != 1 or c != out, dtype=dtype)
                else:
                    out = planes
                    blk = BasicBlock(c, planes, stride=s, dilation=dilation,
                                     use_downsample=s != 1 or c != out, dtype=dtype)
                setattr(self, name, blk)
                names.append(name)
                c = out
            self.stage_blocks.append(names)

    def forward(self, x, train: bool = False):
        features = [x]
        if self.depth == 0:
            return features
        x = relu(self.bn1(conv2d(x, self.conv1.to(x.dtype), stride=2), train))
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


def _registries() -> tuple:
    from senas_torch.models.encoders_extra import EXTRA_ENCODERS
    from senas_torch.models.encoders_families import FAMILY_ENCODERS
    from senas_torch.models.encoders_mnv3 import MNV3_ENCODERS
    from senas_torch.models.encoders_resnest import RESNEST_ENCODERS
    from senas_torch.models.encoders_timm2 import TIMM2_ENCODERS
    return EXTRA_ENCODERS, FAMILY_ENCODERS, RESNEST_ENCODERS, TIMM2_ENCODERS, MNV3_ENCODERS


def _resolve_tu_alias(name: str, known) -> Optional[str]:
    """Map a ``tu-<timm_name>`` onto a name in `known`.

    The reference's TimmUniversalEncoder (encoders/timm_universal.py) is a
    thin ``timm.create_model(features_only=True)`` wrapper whose forward
    returns ``[x] + features``, the pyramid every encoder here returns; so
    ``tu-<name>`` resolves to the ported architecture of that timm name
    (senas_tpu/models/encoders.py:183-209)."""
    base = name[3:]
    candidates = [base, f"timm-{base}"]
    # timm underscore spellings -> smp registry spellings
    if base.startswith("efficientnet_b"):
        candidates.append("efficientnet-" + base[len("efficientnet_"):])
    if base.startswith("seresnet"):
        candidates.append("se_resnet" + base[len("seresnet"):])
    if base.startswith("seresnext"):
        candidates.append("se_resnext" + base[len("seresnext"):])
    if base.startswith("mobilenetv2"):
        candidates.append("mobilenet_v2")
    return next((c for c in candidates if c in known), None)


# the reference's error text for the encoders whose make_dilated raises
# (encoders/{densenet,vgg,inceptionv4,inceptionresnetv2,xception,
# timm_res2net,timm_resnest}.py)
_DILATED_UNSUPPORTED_MSG = {
    "DenseNetEncoder": "DenseNet encoders do not support dilated mode "
                       "due to pooling operation for downsampling!",
    "VGGEncoder": "'VGG' models do not support dilated mode due to Max "
                  "Pooling operations for downsampling!",
    "InceptionV4Encoder": "InceptionV4 encoder does not support dilated "
                          "mode due to pooling operation for downsampling!",
    "InceptionResNetV2Encoder": "InceptionResNetV2 encoder does not "
                                "support dilated mode "
                                "due to pooling operation for downsampling!",
    "XceptionEncoder": "Xception encoder does not support dilated mode "
                       "due to pooling operation for downsampling!",
    "Res2NetEncoder": "Res2Net encoders do not support dilated mode",
    "ResNestEncoder": "ResNest encoders do not support dilated mode",
}


def get_encoder_names() -> List[str]:
    """The encoder names (smp encoders/__init__.py:85-86), in senas_tpu's
    order."""
    names = list(_ENCODERS)
    for r in _registries():
        names.extend(r)
    return names


def get_encoder(name: str, depth: int = 5, dtype=None, dilate_last: bool = False,
                output_stride: int = 32, weights: Optional[str] = None,
                in_channels: int = 3) -> nn.Module:
    """The encoder `name` over `in_channels` input channels (the JAX package
    infers them from its first input; a torch module is built with them),
    computing in `dtype` (None: the input's). `dilate_last` is senas_tpu's
    alias of output_stride=16. A family without dilated mode raises the
    reference's ValueError at output stride 16 or 8."""
    if weights is not None:
        # smp loads ImageNet weights by URL here (encoders/__init__.py:64-71)
        raise ValueError(
            f"pretrained weights {weights!r} are unavailable in this "
            "environment (no network egress); pass weights=None and "
            "initialize randomly, exactly as the reference does offline")
    if dilate_last and output_stride == 32:
        output_stride = 16
    if output_stride not in (8, 16, 32):
        raise ValueError(
            "Output stride should be 16 or 8, got {}.".format(output_stride))
    if name in _ENCODERS:
        return ResNetEncoder(in_channels, depth=depth, output_stride=output_stride,
                             dtype=dtype, **_ENCODERS[name])
    registries = _registries()
    entry = next((r[name] for r in registries if name in r), None)
    if entry is not None:
        cls = entry["cls"]
        dilatable = "output_stride" in inspect.signature(cls).parameters
        if output_stride != 32 and not dilatable:
            raise ValueError(_DILATED_UNSUPPORTED_MSG.get(
                cls.__name__, f"{name!r} does not support dilated mode"))
        kw = dict(entry["kw"])
        if dilatable:
            kw["output_stride"] = output_stride
        return cls(in_channels, depth=depth, dtype=dtype, **kw)
    if name.startswith("tu-"):
        known = set(_ENCODERS).union(*registries)
        resolved = _resolve_tu_alias(name, known)
        if resolved is not None:
            return get_encoder(resolved, depth=depth, dtype=dtype, output_stride=output_stride,
                               in_channels=in_channels)
        from senas_torch.models.encoders_extra import GATED_FAMILIES
        if name.startswith(GATED_FAMILIES):
            raise KeyError(
                f"{name!r} names a timm model with no natively-ported "
                "architecture; the timm pretrained registry "
                "(TimmUniversalEncoder) is not available in this environment. "
                "tu-<name> works for every natively-ported architecture "
                "(e.g. tu-resnet34, tu-resnest50d, tu-tf_efficientnet_lite0); "
                "see senas_torch/models/encoders_extra.py GATED_FAMILIES")
    raise KeyError(f"unknown encoder {name!r}; available: {sorted(get_encoder_names())}")


@functools.lru_cache(maxsize=None)
def encoder_out_channels(name: str, depth: int = 5, in_channels: int = 3) -> Tuple[int, ...]:
    """Per-stage channel pyramid of the named encoder (smp's
    `out_channels`): the channels of the depth+1 maps its forward returns,
    read off a forward of the encoder built on the meta device at 256x256
    (no memory, no arithmetic), as senas_tpu reads them off `jax.eval_shape`.
    Names that `get_encoder` refuses raise the same here."""
    with torch.device("meta"):
        enc = get_encoder(name, depth=depth, in_channels=in_channels)
        feats = enc(torch.empty(1, in_channels, 256, 256), train=False)
    return tuple(int(f.shape[1]) for f in feats)
