"""Shared runner plumbing: config resolution, the mesh, batch placement,
rank-0 outputs, eval loop.

Port of the parts of `senas_tpu/runner/common.py` that the search, train
and test runners use. `multi_gpus: true` runs over the ranks of a
torch.distributed process group, one process per device (`setup_mesh`;
the CLIs spawn them), laid out as `MeshSpec(data=N // mesh_spatial,
spatial=mesh_spatial)`: the config batch size is the global batch, every
rank loads it and keeps the rows of its data index and, with a spatial
axis, its block of image rows, and rank 0 alone writes the logs, scalars,
checkpoints and images. With one device the run stays on it, as the JAX
runner does without a second one.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from senas_torch.data import DataLoader
from senas_torch.models.factory import check_model_name
from senas_torch.parallel.collectives import broadcast_object
from senas_torch.parallel.mesh import (REPLICATED, ROW_SPLIT, MeshSpec, initialize_distributed,
                                       make_mesh, shard_batch)
from senas_torch.train.metrics import AverageMeter, SegmentationMetric
from senas_torch.utils.logging import get_logger
from senas_torch.utils.spans import span

# Run directories go under the checkout's git-ignored logs/ unless the
# caller names another root; the CLIs' default config is the checkout's.
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_LOG_ROOT = os.path.join(_CHECKOUT, "logs")
DEFAULT_CONFIG = os.path.join(_CHECKOUT, "configs", "senas", "senas_promise12.yml")


def visible_devices(device: torch.device) -> int:
    """The devices a mesh on `device`'s kind could span: the visible cards,
    or 1 for the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def setup_mesh(section: Dict[str, Any], device: torch.device,
               model_name: Optional[str] = None):
    """`multi_gpus` of a `searching:` or `training:` section, for a run on
    `device` of `model_name` (None: the SENAS model of the section)
    (senas_tpu/runner/common.py:30-69). Returns (mesh or None, the line for
    the run's log or None).

    Without `multi_gpus`: (None, None). With it, the process joins the
    group that the SENAS_* environment describes (`initialize_distributed`)
    unless one is initialised already. A group of R >= 2 ranks gives the
    mesh MeshSpec(data=R // mesh_spatial, spatial=mesh_spatial) on this
    rank's device and the JAX runner's "mesh: ..." line. One rank or one
    visible device gives (None, the JAX runner's single-device line).
    Raises where `mesh_spatial` does not divide R, where R >= 2 and the
    factory does not build `model_name` (its KeyError,
    `factory.check_model_name`), and where two or more devices are visible
    but no group is: one process drives one device, and the CLIs start
    them. Every model the factory builds runs under both axes."""
    if not section.get("multi_gpus", False):
        return None, None
    import torch.distributed as dist

    joined = initialize_distributed(device=device)
    n = dist.get_world_size() if joined else visible_devices(device)
    if n < 2:
        return None, f"multi_gpus requested but only {n} device visible — running single-device"
    spatial = int(section.get("mesh_spatial", 1))
    if spatial < 1 or n % spatial != 0:
        raise ValueError(f"mesh_spatial={spatial} does not divide {n} devices")
    check_model_name(model_name)
    if not joined:
        raise RuntimeError(
            f"multi_gpus over {n} {device.type} devices runs one process per device: start "
            "the run through its CLI (python -m senas_torch.search_arc, train_model or "
            "testing_model), which spawns them, or join a process group first "
            "(SENAS_COORDINATOR, SENAS_NUM_PROCESSES, SENAS_PROCESS_ID)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(spec=MeshSpec(data=n // spatial, spatial=spatial), device=device)
    platform = "gpu" if device.type == "cuda" else device.type
    return mesh, f"mesh: {mesh.shape} over {n} {platform} devices"


def check_global_batch(mesh, batch_size: int, what: str = "batch_size") -> None:
    """The config batch size is the GLOBAL batch (reference semantics:
    DataParallel splits the loader batch across GPUs)."""
    if mesh is None:
        return
    data = mesh.shape["data"]
    if batch_size % data != 0:
        raise ValueError(
            f"{what}={batch_size} is not divisible by the mesh data axis "
            f"({data}); pick a multiple so every device gets equal work")


def make_batch_placer(device: torch.device, mesh=None, spatial: bool = False
                      ) -> Callable[[Dict[str, np.ndarray]], Dict[str, Any]]:
    """Returns place(batch) -> the batch's numpy arrays as tensors on
    `device`. With a mesh, this rank's rows of the global batch (those of
    its data index), and with `spatial` (the runners pass mesh_spatial > 1)
    its block of image rows where the spatial size divides the image's H,
    marked `ROW_SPLIT` (senas_tpu/runner/common.py:98-106); where it does
    not, the data index's rows whole on each of its ranks, which the step
    then reduces over the data axis only (`shard_train_step`). A batch the
    data axis does not divide (a trailing eval batch) goes whole to every
    rank, marked so that `shard_train_step` runs it as a single-device step
    (the JAX placer's replicated case): its metrics count once. A call is
    the span `place`, each copy to the device an `h2d` inside it."""

    def place(batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        with span("place"):
            batch = {"image": batch["image"], "label": batch["label"]}
            b, h = batch["image"].shape[:2]
            whole = mesh is not None and not mesh.divides(b)
            if mesh is not None and not whole:
                batch = shard_batch(mesh, batch, spatial=spatial and h % mesh.spec.spatial == 0)
            out = {}
            for k in ("image", "label"):
                host = torch.from_numpy(np.ascontiguousarray(batch[k]))
                with span("h2d"):
                    out[k] = host.to(device)
            if whole:
                out[REPLICATED] = True
            if ROW_SPLIT in batch:
                out[ROW_SPLIT] = batch[ROW_SPLIT]
            return out

    return place


def is_main(mesh) -> bool:
    """Whether this process writes the run's outputs: rank 0, or the only
    process."""
    return mesh is None or mesh.rank == 0


class NullWriter:
    """A `ScalarWriter` that keeps nothing: a rank other than 0."""

    def add_scalar(self, *args, **kw):
        pass

    def add_image_grid(self, *args, **kw):
        pass

    def export_scalars_to_json(self, *args, **kw):
        pass

    def close(self):
        pass


def run_outputs(mesh, make_dir: Callable[[], str]):
    """(run_dir, logger) of a run: rank 0 makes the directory and logs to
    it; every other rank learns the directory's path (it reads checkpoints
    there) and logs nowhere."""
    if is_main(mesh):
        run_dir = make_dir()
        broadcast_object(run_dir, mesh)
        return run_dir, get_logger(run_dir)
    run_dir = broadcast_object(None, mesh)
    logger = logging.getLogger(f"senas_torch.rank{mesh.rank}:{run_dir}")
    logger.propagate = False
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return run_dir, logger


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
