"""Shared runner plumbing: config resolution, batch placement, eval loop.

Port of the parts of `senas_tpu/runner/common.py` that the search, train
and test runners use. `multi_gpus` runs on the one visible device, as the
JAX runner does without a second one; a mesh over two or more cards is not
ported (ROADMAP.md M13) and raises.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

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


def visible_devices(device: torch.device) -> int:
    """The devices a mesh on `device`'s kind could span: the visible cards,
    or 1 for the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def multi_gpus_note(section: Dict[str, Any], device: torch.device) -> Optional[str]:
    """`multi_gpus` of a `searching:` or `training:` section, for a run on
    `device`. With `multi_gpus: true` and one visible device the run stays
    on it, and the line the JAX runner logs then is returned for the
    caller's log (`mesh_spatial` is read only for a mesh); with two or more
    it raises, rather than use one of them quietly. None otherwise."""
    if not section.get("multi_gpus", False):
        return None
    n = visible_devices(device)
    if n >= 2:
        raise NotImplementedError(f"multi_gpus over {n} {device.type} devices is not "
                                  "ported yet (ROADMAP.md M13)")
    return f"multi_gpus requested but only {n} device visible — running single-device"


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
