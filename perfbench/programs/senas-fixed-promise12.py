"""The program of `senas-fixed-promise12`: senas_torch's `SenasModel` of
the searched genotype that the configuration names, trained by
`train/trainer.py` `make_train_step` and fed by the runners' batch placer,
and served through `serve.py`: exported by `export_predict_fn`, saved,
and loaded into a `Predictor`.

Found by the configuration's name (`perfbench.lib.cells.load_program`).
The loops reach the program through what this file defines, and through
nothing else; a configuration with another program brings a file of its
own.
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Callable, Dict, List

import torch

from perfbench.lib import precision, trainer_state

# a step takes (train batch,)
BATCHES_PER_STEP = 1

set_precision = precision.float32
first_gradients = trainer_state.first_gradients
state_change = trainer_state.state_change


def arch_shapes(ref, cfg: dict) -> None:
    """No architecture tables: the genotype is fixed."""
    return None


def batch_placer(device):
    from senas_torch.runner.common import make_batch_placer
    return make_batch_placer(device)


def _model(cfg: dict, state: Dict[str, torch.Tensor], device):
    from senas_torch.models import geno_searched
    from senas_torch.models.senas_model import SenasModel

    model = SenasModel(cfg["nclass"], cfg["in_channels"], cfg["init_channels"], cfg["depth"],
                       dropout_prob=cfg["dropout_prob"], supervision=cfg["deep_supervision"],
                       genotype=getattr(geno_searched, cfg["geno_type"]),
                       double_down_channel=cfg["double_down_channel"], device=device,
                       generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state)
    return model


def build_step(cfg: dict, state: Dict[str, torch.Tensor], arch: None, device):
    """(training state, step(state, (train batch,) placed))."""
    from senas_torch.train.loss import build_loss
    from senas_torch.train.trainer import FixedTrainState, make_train_step

    st = FixedTrainState.create(_model(cfg, state, device), cfg["model_optimizer"])
    step = make_train_step(build_loss(cfg["loss"], cfg["deep_supervision"]),
                           grad_clip=cfg["grad_clip"])
    return st, lambda s, unit: step(s, unit[0])


def losses(cfg: dict, metrics: dict) -> List[float]:
    return [float(metrics["loss"])]


def flops_per_step(cfg: dict) -> float:
    return cfg["batch_size"] * cfg["counts"]["flops_per_image"]["train"]


def build_predict(cfg: dict, state: Dict[str, torch.Tensor], device,
                  mark: Callable[[str], None] = lambda _: None):
    """predict(host volume [n, H, W, C_in]) -> host uint8 masks: the network
    with `state` in eval mode, exported at the configuration's precision,
    saved under TMPDIR and loaded into a Predictor on `device`."""
    from senas_torch.serve import Predictor, export_predict_fn, save_artifact

    hw, c = cfg["image_size"], cfg["in_channels"]
    model = _model(cfg, state, device)
    mark("program")
    exported = export_predict_fn(model, (hw, hw, c), matmul_precision=cfg["precision"])
    mark("export")
    out_dir = tempfile.mkdtemp(prefix="perfbench_artifact_")
    try:
        save_artifact(exported, {"hw": hw, "in_channels": c, "nclass": cfg["nclass"]}, out_dir)
        del model, exported
        mark("save")
        predictor = Predictor(out_dir, device=device)
        mark("load")
        return predictor.predict_masks
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
