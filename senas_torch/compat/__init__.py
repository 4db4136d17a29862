"""Interop with the PyTorch reference framework: its trained checkpoints
(`checkpint.pth.tar` / `model_best.pth.tar`, utils/utils.py:138-143) into
the port.

Public surface:

- ``load_torch_checkpoint(path)`` — torch.load a reference checkpoint.
- ``classify_checkpoint(ckpt)`` — 'search' | 'train' | 'state_dict'.
- ``import_fixed_checkpoint(path_or_ckpt, genotype, depth)`` — fixed
  SenasModel weights (+ run meta) from a train-CLI checkpoint.
- ``import_search_checkpoint(path_or_ckpt, depth, meta_node_num)`` —
  supernet weights (naive or grouped layout) + architecture tables from a
  search-CLI checkpoint.
- ``import_zoo_checkpoint(path_or_ckpt, model_name)`` — baseline-zoo
  (vendored smp, and nasunet) weights from a train-CLI checkpoint, for the
  factory's nine zoo names (``ZOO_MODEL_NAMES``).
- ``translate_resnet_encoder(sd)`` / ``set_encoder_variables`` — a
  torchvision-style ResNet / ResNeXt state_dict into the zoo's encoder.
- ``translate_senas_model`` / ``translate_senas_search`` /
  ``translate_arch_params`` / ``translate_zoo_model`` /
  ``state_dict_to_numpy`` — the steps under them.

Weights come out as numpy trees with flax names; `senas_torch.convert`
loads them into the port's models. CLI: ``python -m
senas_torch.import_torch_checkpoint`` writes a port checkpoint that the
runners resume from.
"""

from senas_torch.compat.torch_import import (classify_checkpoint,
                                             import_fixed_checkpoint,
                                             import_search_checkpoint,
                                             load_torch_checkpoint,
                                             set_encoder_variables,
                                             state_dict_to_numpy,
                                             translate_arch_params,
                                             translate_resnet_encoder,
                                             translate_senas_model,
                                             translate_senas_search)
from senas_torch.compat.zoo_import import (ZOO_MODEL_NAMES, import_zoo_checkpoint,
                                           translate_zoo_model)

__all__ = [
    "ZOO_MODEL_NAMES",
    "classify_checkpoint",
    "import_fixed_checkpoint",
    "import_search_checkpoint",
    "import_zoo_checkpoint",
    "load_torch_checkpoint",
    "set_encoder_variables",
    "state_dict_to_numpy",
    "translate_arch_params",
    "translate_resnet_encoder",
    "translate_senas_model",
    "translate_senas_search",
    "translate_zoo_model",
]
