"""The program of `senas-search-promise12`: senas_torch's bilevel search
step (`train/trainer.py` `make_search_step`) on `SenasSearch`, whose
grouped mixed ops run K1a-K1d, with `normalize_arch`, fed by the runners'
batch placer.

Found by the configuration's name (`perfbench.lib.cells.load_program`).
The loops reach the program through what this file defines, and through
nothing else; a configuration with another program brings a file of its
own.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.lib import precision, trainer_state

# a step takes (train batch, val batch)
BATCHES_PER_STEP = 2

set_precision = precision.float32
first_gradients = trainer_state.first_gradients
state_change = trainer_state.state_change


def arch_shapes(ref, cfg: dict) -> Dict[str, tuple]:
    """The architecture tables, which the benchmark draws from the seed."""
    return ref.arch_shapes(cfg["meta_node_num"], cfg["depth"], cfg["sharing_normal"])


def batch_placer(device):
    from senas_torch.runner.common import make_batch_placer
    return make_batch_placer(device)


def build_step(cfg: dict, state: Dict[str, torch.Tensor], arch: Dict[str, torch.Tensor],
               device):
    """(training state, step(state, (train batch, val batch) placed))."""
    from senas_torch.search.supernet import SenasSearch, normalize_arch
    from senas_torch.train.loss import build_loss
    from senas_torch.train.trainer import SearchTrainState, make_search_step

    model = SenasSearch(cfg["in_channels"], cfg["init_channels"], cfg["nclass"], cfg["depth"],
                        cfg["meta_node_num"], double_down_channel=cfg["double_down_channel"],
                        supervision=cfg["deep_supervision"], device=device,
                        generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state)
    tables = {k: v.clone() for k, v in arch.items()}
    st = SearchTrainState.create(model, tables, cfg["model_optimizer"], cfg["arch_optimizer"],
                                 cfg["arch_in_weight_step"])
    meta, mode = cfg["meta_node_num"], cfg["beta_mode"]
    step = make_search_step(lambda a: normalize_arch(a, meta, mode),
                            build_loss(cfg["loss"], cfg["deep_supervision"]),
                            grad_clip=cfg["grad_clip"])
    do_arch = cfg["do_arch"]
    return st, lambda s, unit: step(s, unit[0], unit[1], do_arch)


def losses(cfg: dict, metrics: dict) -> List[float]:
    """A step's losses in the reference's order: the arch step's, then the
    weight step's."""
    return ([float(metrics["arch_loss"])] if cfg["do_arch"] else []) + [float(metrics["loss"])]


def flops_per_step(cfg: dict) -> float:
    f = cfg["counts"]["flops_per_image"]
    return cfg["batch_size"] * (f["train"] + (f["arch"] if cfg["do_arch"] else 0))
