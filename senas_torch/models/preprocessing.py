"""Per-encoder input-preprocessing registry (smp parity).

A copy of `senas_tpu/models/preprocessing.py` (numpy), whose name check
asks the port's encoder table (`encoder_out_channels`, which builds no
weights): the encoder families that are not ported yet raise
NotImplementedError there.

Mirrors segmentation_models_pytorch/encoders/__init__.py:89-110
(`get_preprocessing_params` / `get_preprocessing_fn`) and
encoders/_preprocessing.py (`preprocess_input`). In the reference the
mean/std/input-range settings come from each encoder's
`pretrained_settings[pretrained]` dict (sourced from the `pretrainedmodels`
package); pretrained weights themselves are unavailable in this zero-egress
environment, but the normalization registry is plain data and is ported
verbatim so user pipelines behave identically.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np

_IMAGENET = {
    "input_space": "RGB",
    "input_range": [0, 1],
    "mean": [0.485, 0.456, 0.406],
    "std": [0.229, 0.224, 0.225],
}
# inception-family nets (pretrainedmodels inceptionv4/inceptionresnetv2/
# xception settings): symmetric [-1, 1] scaling
_INCEPTION = {
    "input_space": "RGB",
    "input_range": [0, 1],
    "mean": [0.5, 0.5, 0.5],
    "std": [0.5, 0.5, 0.5],
}
# pretrainedmodels.models.dpn settings (imagenet ds variant)
_DPN = {
    "input_space": "RGB",
    "input_range": [0, 1],
    "mean": [124 / 255, 117 / 255, 104 / 255],
    "std": [1 / (0.0167 * 255)] * 3,
}

_FAMILY_SETTINGS = [
    (("inceptionv4", "inceptionresnetv2", "xception"), _INCEPTION),
    # timm tf_-ported weights (tf_efficientnet_lite*) use the TF/inception
    # 0.5-mean/0.5-std convention (timm default_cfgs via prepare_settings,
    # smp timm_efficientnet.py:146-153)
    (("timm-tf_",), _INCEPTION),
    (("dpn",), _DPN),
]


def _settings_for(encoder_name: str) -> Dict:
    for prefixes, settings in _FAMILY_SETTINGS:
        if any(encoder_name.startswith(p) for p in prefixes):
            return settings
    return _IMAGENET


def get_preprocessing_params(encoder_name: str,
                             pretrained: str = "imagenet") -> Dict:
    """smp get_preprocessing_params: {input_space, input_range, mean, std}.

    `pretrained` selects the settings variant; only the default "imagenet"
    statistics exist here (weights are not downloadable in this image), and
    "advprop" for efficientnet-* (encoders/efficientnet.py:93-99, which is
    the inception-style [0.5, 0.5, 0.5] normalization).
    """
    from senas_torch.models.encoders import encoder_out_channels

    encoder_out_channels(encoder_name)  # raises KeyError for unknown names
    if pretrained == "advprop" and encoder_name.startswith("efficientnet"):
        return dict(_INCEPTION)
    if pretrained != "imagenet":
        raise ValueError(
            f"Available pretrained options for {encoder_name!r}: ['imagenet']"
            + (" + ['advprop']" if encoder_name.startswith("efficientnet") else ""))
    return dict(_settings_for(encoder_name))


def preprocess_input(x, mean: Optional[List[float]] = None,
                     std: Optional[List[float]] = None,
                     input_space: str = "RGB",
                     input_range: Optional[List[float]] = None, **kwargs):
    """encoders/_preprocessing.py:4-23, numpy-for-numpy."""
    if input_space == "BGR":
        x = x[..., ::-1].copy()
    if input_range is not None:
        if x.max() > 1 and input_range[1] == 1:
            x = x / 255.0
    if mean is not None:
        x = x - np.array(mean)
    if std is not None:
        x = x / np.array(std)
    return x


def get_preprocessing_fn(encoder_name: str, pretrained: str = "imagenet"):
    params = get_preprocessing_params(encoder_name, pretrained=pretrained)
    return functools.partial(preprocess_input, **params)
