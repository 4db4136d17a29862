"""Shared runner plumbing: config resolution, batch placement, eval loop.

Port of the parts of `senas_tpu/runner/common.py` that the search, train
and test runners use. The device mesh (`multi_gpus`, `mesh_spatial`) is not
ported.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from senas_torch.data import DataLoader
from senas_torch.train.metrics import AverageMeter, SegmentationMetric

# Run directories go under the checkout's git-ignored logs/ unless the
# caller names another root; the CLIs' default config is the checkout's.
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_LOG_ROOT = os.path.join(_CHECKOUT, "logs")
DEFAULT_CONFIG = os.path.join(_CHECKOUT, "configs", "senas", "senas_promise12.yml")


def make_batch_placer(device: torch.device) -> Callable[[Dict[str, np.ndarray]], Dict[str, torch.Tensor]]:
    """Returns place(batch) -> the batch's numpy arrays as tensors on `device`."""

    def place(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {"image": torch.from_numpy(batch["image"]).to(device),
                "label": torch.from_numpy(batch["label"]).to(device)}

    return place


class DeferredMetrics:
    """Batches device->host metric readbacks so that the step stream stays
    asynchronous: the metric dicts of the steps queue here and are read
    back every `drain_every` pushes (and at report and epoch boundaries
    through an explicit `drain()`)."""

    _KEYS = ("loss", "tp", "fp", "fn", "acc")

    def __init__(self, metric: SegmentationMetric, loss_meter: AverageMeter,
                 drain_every: int = 16):
        self.metric = metric
        self.loss_meter = loss_meter
        self.drain_every = drain_every
        self._pending: List[Dict[str, Any]] = []
        self._sizes: List[int] = []

    def push(self, m: Dict[str, Any], n: int = 1) -> None:
        self._pending.append({k: m[k] for k in self._KEYS if k in m})
        self._sizes.append(n)
        if len(self._pending) >= self.drain_every:
            self.drain()

    def drain(self) -> None:
        if not self._pending:
            return
        for m, n in zip(self._pending, self._sizes):
            m = {k: v.detach().cpu().numpy() for k, v in m.items()}
            self.loss_meter.update(float(m["loss"]), n=n)
            self.metric.update_counts(m["tp"], m["fp"], m["fn"], float(m["acc"]))
        self._pending.clear()
        self._sizes.clear()


def run_eval_loop(eval_step_fn, loader: DataLoader, nclass: int, place_fn):
    """Evaluation epoch: returns (metric, loss_meter)."""
    metric = SegmentationMetric(nclass)
    loss_meter = AverageMeter()
    acc = DeferredMetrics(metric, loss_meter)
    for batch in loader:
        out = eval_step_fn(place_fn(batch))
        acc.push(out, n=batch["image"].shape[0])
    acc.drain()
    return metric, loss_meter


def check_unported(section: Dict[str, Any]) -> None:
    """Raise on the options of a `searching:` or `training:` section that the
    port does not have yet."""
    if section.get("multi_gpus", False) or int(section.get("mesh_spatial", 1)) > 1:
        raise NotImplementedError("multi_gpus / mesh_spatial are not ported yet "
                                  "(ROADMAP.md Queue 1, M13)")
    if section.get("remat", False):
        raise NotImplementedError("remat is not ported yet (ROADMAP.md Queue 1)")
    resolve_precision(section.get("precision"))


def resolve_precision(name):
    """Config `precision:` -> module compute dtype: None (f32, the
    reference's numerics) or torch.bfloat16 (the parameters stay f32
    masters). Anything else raises ValueError."""
    if name in (None, "", "f32", "fp32", "float32"):
        return None
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"unknown precision {name!r} (use f32 or bf16)")


def resolve_dataset_kwargs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Dataset-specific constructor kwargs from config (synthetic knobs)."""
    name = cfg["data"]["dataset"].lower()
    if name == "synthetic":
        return {key: cfg["data"][key] for key in ("hw", "size", "num_class", "in_channels")
                if key in cfg["data"]}
    return {}
