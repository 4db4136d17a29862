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
- ``translate_senas_model`` / ``translate_senas_search`` /
  ``translate_arch_params`` / ``state_dict_to_numpy`` — the steps under them.

Weights come out as numpy trees with flax names; `senas_torch.convert`
loads them into the port's models. CLI: ``python -m
senas_torch.import_torch_checkpoint`` writes a port checkpoint that the
runners resume from. The baseline zoo's translators wait for the zoo
(ROADMAP.md Queue 1, M15).
"""

from senas_torch.compat.torch_import import (classify_checkpoint,
                                             import_fixed_checkpoint,
                                             import_search_checkpoint,
                                             load_torch_checkpoint,
                                             state_dict_to_numpy,
                                             translate_arch_params,
                                             translate_senas_model,
                                             translate_senas_search)

__all__ = [
    "classify_checkpoint",
    "import_fixed_checkpoint",
    "import_search_checkpoint",
    "load_torch_checkpoint",
    "state_dict_to_numpy",
    "translate_arch_params",
    "translate_senas_model",
    "translate_senas_search",
]
