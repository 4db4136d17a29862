"""The collectives of a data-parallel step: what GSPMD inserts in the JAX
package, placed by hand at every reduction over the batch axis.

`senas_tpu`'s sharded step computes every batch reduction over the GLOBAL
batch (each BatchNorm, the fused epilogue's sums, the loss, the metrics),
so its result is the single-device step on the global batch. The port
runs one process per device (`senas_torch.parallel.mesh`), each holding
its own rows, and puts a collective where GSPMD would:

  * `all_reduce_sum`: a batch statistic summed over the ranks. Forward and
    backward are both a sum over ranks: every rank's cotangent of the
    global statistic reaches every rank's rows.
  * `gather_batch`: the global batch of a per-row tensor (the logits, the
    labels), for the loss and the metrics. Its backward returns the local
    rows of the cotangent, with no collective. Every rank then computes
    the same global loss; its autograd yields the partial gradient through
    its own rows, and the step's gradient is the sum of the partials
    (`all_reduce_flat_`, one call before the clip).

Only `all_reduce` (sum) and `broadcast` are used: a gloo group takes CUDA
tensors for these two and not for `all_gather`, so one code path serves
NCCL between cards and gloo on the CPU or on one shared card. A gather is
the sum of zero-padded buffers, exact in every dtype.

`active_mesh()` is the mesh of the step that is running (`activate`), or
None. Every module asks it, as BatchNorm asks `use_pallas_bn()`. Without
one, or for a mesh of one process and no group, every caller keeps its
single-device code path and numerics. The active mesh is a process-wide
setting, not a thread-local one: autograd runs a CUDA backward (and a
remat recompute inside it) on a device thread of its own.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_ACTIVE = None


def active_mesh():
    """The mesh of the running step, or None (single-device semantics)."""
    return _ACTIVE


@contextlib.contextmanager
def activate(mesh):
    """Make `mesh` the active one while the block runs. A mesh without a
    process group (one process) activates nothing."""
    global _ACTIVE
    before = _ACTIVE
    _ACTIVE = mesh if mesh is not None and mesh.group is not None else None
    try:
        yield
    finally:
        _ACTIVE = before


def global_count(local: int) -> int:
    """The number of values a batch statistic spans: `local` values on each
    rank (every rank holds the same number of rows)."""
    mesh = _ACTIVE
    return local if mesh is None else local * mesh.world_size


def _all_reduce_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum `t` over the mesh's ranks, in place."""
    import torch.distributed as dist
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; dx = sum over ranks of dy."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce_(x.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce_(dy.contiguous().clone(), ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """x summed over the ranks of `mesh` (default: the active one); x
    itself without a mesh. Differentiable: the backward sums the cotangent
    over the ranks too."""
    mesh = mesh if mesh is not None else _ACTIVE
    if mesh is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x, mesh)
    return _all_reduce_(x.contiguous().clone(), mesh)


def _gather(x: torch.Tensor, mesh) -> torch.Tensor:
    b = x.shape[0]
    buf = x.new_zeros((b * mesh.world_size,) + tuple(x.shape[1:]))
    buf[mesh.rank * b:(mesh.rank + 1) * b] = x
    return _all_reduce_(buf, mesh)


class _GatherBatch(torch.autograd.Function):
    """y = the rows of every rank in rank order; dx = this rank's rows of dy."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows = slice(mesh.rank * x.shape[0], (mesh.rank + 1) * x.shape[0])
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, dy):
        return dy[ctx.rows], None


def gather_batch(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The global batch of a per-row tensor x [b, ...]: every rank's b rows
    in rank order (rank r's at [r*b, (r+1)*b)), the same on every rank; x
    itself without a mesh. Differentiable in x."""
    mesh = mesh if mesh is not None else _ACTIVE
    if mesh is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherBatch.apply(x, mesh)
    return _gather(x, mesh)


def gather_outputs(outputs, mesh=None):
    """`gather_batch` of a model's output: one tensor or a list of heads."""
    if isinstance(outputs, (list, tuple)):
        return type(outputs)(gather_batch(o, mesh) for o in outputs)
    return gather_batch(outputs, mesh)


def _buckets(tensors: Sequence[torch.Tensor]) -> Dict[Tuple, List[int]]:
    out: Dict[Tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault((t.dtype, t.device), []).append(i)
    return out


@torch.no_grad()
def all_reduce_flat_(tensors: Sequence[torch.Tensor], mesh=None) -> None:
    """Sum each tensor over the ranks, in place: one collective for each
    dtype and device, over the tensors laid end to end."""
    mesh = mesh if mesh is not None else _ACTIVE
    if mesh is None:
        return
    for idx in _buckets(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _all_reduce_(flat, mesh)
        offset = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], mesh, src: int = 0) -> None:
    """Give every rank rank `src`'s values of `tensors`, in place: one
    collective for each dtype and device. A tensor off the mesh's device (an
    optimizer's step count on the host) travels through a copy there."""
    import torch.distributed as dist
    if mesh is None or mesh.group is None:
        return
    for (dtype, _), idx in _buckets(tensors).items():
        flat = torch.cat([tensors[i].reshape(-1).to(mesh.device) for i in idx])
        dist.broadcast(flat, src=src, group=mesh.group)
        offset = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast_object(obj, mesh, src: int = 0):
    """A picklable object of rank `src` on every rank (a run directory's
    path, a checkpoint's counters), through two tensor broadcasts."""
    import pickle

    import torch.distributed as dist
    if mesh is None or mesh.group is None:
        return obj
    payload = pickle.dumps(obj) if mesh.rank == src else b""
    size = torch.tensor([len(payload)], dtype=torch.int64, device=mesh.device)
    dist.broadcast(size, src=src, group=mesh.group)
    buf = (torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(mesh.device)
           if mesh.rank == src else
           torch.empty(int(size.item()), dtype=torch.uint8, device=mesh.device))
    dist.broadcast(buf, src=src, group=mesh.group)
    return pickle.loads(buf.cpu().numpy().tobytes())
