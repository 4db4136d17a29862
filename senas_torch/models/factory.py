"""Model factory: name -> constructed module.

Port of `senas_tpu/models/factory.py` (the reference's models/__init__.py:
8-105): the same model names, the depth -> decoder-channel truncation
(256, 128, ...)[:depth], the resnet10 encoder for every smp baseline,
FPN/PAN upsampling 2^(depth-3), and the classes and input channels from
the dataset registry. DeepLabV3+ keeps its encoder depth 5 whatever
`depth` says, as senas_tpu's factory does. Options a model does not take
(`c`, `genotype`, `supervision`, ... for the zoo) are ignored, as there.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from senas_torch.data.base import get_dataset_spec
from senas_torch.models import zoo
from senas_torch.models.nasunet import NasUnet
from senas_torch.models.senas_model import SenasModel

ZOO = ("nasunet", "unet", "unet_plus_plus", "manet", "linknet", "fpn", "pspnet", "pan",
       "deeplab_v3_plus")

_DECODER_CHANNELS = (256, 128, 64, 32, 16, 8, 4, 2)


def get_segmentation_model(name: str, dataset: str = "promise12", *, device=None,
                           generator: Optional[torch.Generator] = None, **kwargs: Any):
    """The model `name` for `dataset`, built on `device` (None means the
    card) with its kernels drawn from `generator`. `dtype` other than None
    (bf16) raises."""
    spec = get_dataset_spec(dataset)
    nclass, in_ch = spec.num_class, spec.in_channels
    depth = kwargs.get("depth", 5)
    dtype = kwargs.get("dtype")
    decod = _DECODER_CHANNELS[:depth]
    built = dict(device=device, generator=generator)
    name = name.lower()
    if name == "senas":
        if dtype is not None:
            raise NotImplementedError("bf16 is not ported yet (ROADMAP.md Queue 1, item 5)")
        return SenasModel(nclass=nclass, in_channels=in_ch,
                          c=kwargs.get("c", 32), depth=depth,
                          dropout_prob=kwargs.get("dropout_prob", 0.0),
                          supervision=kwargs.get("supervision", False),
                          genotype=kwargs["genotype"],
                          double_down_channel=kwargs.get("double_down_channel", False),
                          remat=kwargs.get("remat", False), **built)
    if name == "nasunet":
        return NasUnet(nclass=nclass, in_channels=in_ch, depth=depth, dtype=dtype, **built)
    common = dict(classes=nclass, in_channels=in_ch, dtype=dtype, **built)
    if name == "unet":
        return zoo.Unet(encoder_depth=depth, decoder_channels=decod, **common)
    if name == "unet_plus_plus":
        return zoo.UnetPlusPlus(encoder_depth=depth, decoder_channels=decod, **common)
    if name == "manet":
        return zoo.MAnet(encoder_depth=depth, decoder_channels=decod, **common)
    if name == "linknet":
        return zoo.Linknet(encoder_depth=depth, **common)
    if name == "fpn":
        return zoo.FPN(encoder_depth=depth, upsampling=2 ** (depth - 3), **common)
    if name == "pspnet":
        return zoo.PSPNet(encoder_depth=depth, **common)
    if name == "pan":
        return zoo.PAN(encoder_depth=depth, upsampling=2 ** (depth - 3), **common)
    if name == "deeplab_v3_plus":
        return zoo.DeepLabV3Plus(**common)
    raise KeyError(f"unknown model {name!r}")
