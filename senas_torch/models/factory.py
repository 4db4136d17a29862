"""Model factory: name -> constructed module.

Port of `senas_tpu/models/factory.py`: the model's classes and input
channels come from the dataset registry. Only `senas` is ported; the
baseline zoo (nasunet, unet, unet_plus_plus, manet, linknet, fpn, pspnet,
pan, deeplab_v3_plus) waits for ROADMAP.md M15 and raises.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from senas_torch.data.base import get_dataset_spec
from senas_torch.models.senas_model import SenasModel

ZOO = ("nasunet", "unet", "unet_plus_plus", "manet", "linknet", "fpn", "pspnet", "pan",
       "deeplab_v3_plus")


def get_segmentation_model(name: str, dataset: str = "promise12", *, device=None,
                           generator: Optional[torch.Generator] = None, **kwargs: Any):
    """The model `name` for `dataset`, built on `device` (None means the
    card) with its kernels drawn from `generator`."""
    spec = get_dataset_spec(dataset)
    name = name.lower()
    if name == "senas":
        return SenasModel(nclass=spec.num_class, in_channels=spec.in_channels,
                          c=kwargs.get("c", 32), depth=kwargs.get("depth", 5),
                          dropout_prob=kwargs.get("dropout_prob", 0.0),
                          supervision=kwargs.get("supervision", False),
                          genotype=kwargs["genotype"],
                          double_down_channel=kwargs.get("double_down_channel", False),
                          remat=kwargs.get("remat", False),
                          device=device, generator=generator)
    if name in ZOO:
        raise NotImplementedError(f"model {name!r} is not ported yet (ROADMAP.md Queue 1, "
                                  "M15: the baseline zoo)")
    raise KeyError(f"unknown model {name!r}")
