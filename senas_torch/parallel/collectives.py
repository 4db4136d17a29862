"""The collectives of a sharded step: what GSPMD inserts in the JAX
package, placed by hand at every reduction over the batch axis and every
spatial op over a split image.

`senas_tpu`'s sharded step computes every batch reduction over the GLOBAL
batch (each BatchNorm, the fused epilogue's sums, the loss, the metrics),
so its result is the single-device step on the global batch. The port
runs one process per device (`senas_torch.parallel.mesh`), each holding
its own batch rows and, with the image rows split over the spatial axis,
its own block of them, and puts a collective where GSPMD would:

  * `all_reduce_sum`: a batch statistic summed over the ranks. Forward and
    backward are both a sum over ranks: every rank's cotangent of the
    global statistic reaches every rank's rows.
  * `spatial_sum`: a per-image sum over H, W (the SE blocks' means), summed
    over the ranks of one data index.
  * `gather_batch`: the global batch of a per-row tensor (the logits, the
    labels), over both axes, for the loss and the metrics. Its backward
    returns the local block of the cotangent, with no collective. Every
    rank then computes the same global loss; its autograd yields the
    partial gradient through its own block, and the step's gradient is the
    sum of the partials (`all_reduce_flat_`, one call before the clip).
  * the halo exchanges of `senas_torch.parallel.spatial`, around every
    convolution, pooling and resize of a split image.

Only `all_reduce` (sum) and `broadcast` are used: a gloo group takes CUDA
tensors for these two and not for `all_gather`, so one code path serves
NCCL between cards and gloo on the CPU or on one shared card. A gather is
the sum of zero-padded buffers, exact in every dtype. Every sum goes
through `_all_reduce_`.

`active_mesh()` is the mesh of the step that is running (`activate`), or
None, and `active_split()` the layout of its image rows, or None;
`whole_maps()` turns the split off (and narrows the mesh to the data
subgroup) for maps every spatial rank computes whole. Every
module asks them, as BatchNorm asks `use_pallas_bn()`. Without a mesh, or
for a mesh of one process and no group, every caller keeps its
single-device code path and numerics. The active mesh is a process-wide
setting, not a thread-local one: autograd runs a CUDA backward (and a
remat recompute inside it) on a device thread of its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

_ACTIVE = None
_SPLIT = None


def row_bounds(height: int, size: int, index: int) -> Tuple[int, int]:
    """Rows [lo, hi) of spatial index `index` of `size` in a level `height`
    rows high: [index*H/size, (index+1)*H/size) rounded down. Blocks differ
    by at most one row; a level lower than `size` leaves some empty. Every
    level of a split image, the outputs of a stride-2 op included, is cut
    by this rule, and every op indexes rows globally."""
    return (index * height) // size, ((index + 1) * height) // size


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """How the running step's image rows lie over the spatial axis: the
    spatial subgroup of this rank, its size S and this rank's index s in
    it, and the global height of each level by its width.

    `levels` starts with the image, {W: H}; every row-shard op enters the
    level it makes (`enter`), by the rule that op applies (a stride-2
    convolution's ceil(H/2), a 2x2 pool's floor(H/2), a transposed
    convolution's 2H or 2H - 1, a resize's target), so that the next op
    finds a map's global height by its width. A width that two levels of
    one step share maps to None, and a map of that width raises."""

    group: Any
    size: int
    index: int
    levels: Dict[int, Optional[int]]

    def height(self, width: int) -> int:
        """The global height of the level whose maps are `width` wide."""
        h = self.levels.get(width)
        if h is None:
            raise ValueError(f"a map {width} wide is no level of the split image "
                             f"({self.levels}): its global height is unknown")
        return h

    def enter(self, width: int, height: int) -> None:
        """Record that a map `width` wide has `height` rows: None where
        another level of the same width was entered before."""
        if self.levels.get(width, height) != height:
            self.levels[width] = None
        elif width not in self.levels:
            self.levels[width] = height

    def bounds(self, height: int, index: Optional[int] = None) -> Tuple[int, int]:
        """Rows [lo, hi) of spatial index `index` (default: this rank's)."""
        return row_bounds(height, self.size, self.index if index is None else index)


def active_mesh():
    """The mesh of the running step, or None (single-device semantics)."""
    return _ACTIVE


def active_split() -> Optional[RowSplit]:
    """The row layout of the running step's images, or None: their rows
    are whole on each rank."""
    return _SPLIT


@contextlib.contextmanager
def activate(mesh, image_hw: Optional[Tuple[int, int]] = None):
    """Make `mesh` the active one while the block runs; with `image_hw`,
    the global (H, W) of a batch whose image rows are split over the mesh's
    spatial axis, the row split too. A mesh without a process group (one
    process) activates nothing."""
    global _ACTIVE, _SPLIT
    before = _ACTIVE, _SPLIT
    _ACTIVE = mesh if mesh is not None and mesh.group is not None else None
    _SPLIT = None
    if _ACTIVE is not None and image_hw is not None and mesh.spec.spatial > 1:
        _SPLIT = RowSplit(group=mesh.spatial_group, size=mesh.spec.spatial,
                          index=mesh.spatial_index,
                          levels={image_hw[1]: image_hw[0]})
    try:
        yield
    finally:
        _ACTIVE, _SPLIT = before


@contextlib.contextmanager
def whole_maps():
    """Inside the block, maps are whole on every rank of a data index: the
    row split is off and the mesh is the data subgroup's
    (`Mesh.data_view`), so that a train-mode BatchNorm over a map that
    every spatial rank computes whole (a global pool's 1x1 map, PSPNet's
    pyramid) counts each image once. Every rank of the spatial subgroup
    computes the same values there; each back-propagates only the
    cotangent of its own rows, and the sums over the ranks (the collectives'
    adjoints, the step's gradient all-reduce) add them up. Without a row
    split the block runs as it is."""
    global _ACTIVE, _SPLIT
    if _SPLIT is None:
        yield
        return
    before = _ACTIVE, _SPLIT
    view = _ACTIVE.data_view()
    _ACTIVE, _SPLIT = (view if view.group is not None else None), None
    try:
        yield
    finally:
        _ACTIVE, _SPLIT = before


def global_rows(local: int) -> int:
    """The rows of the global batch, of which each data index holds
    `local`."""
    mesh = _ACTIVE
    return local if mesh is None else local * mesh.spec.data


def global_height(x: torch.Tensor) -> int:
    """The rows of the global image of a map x [..., H, W]: its own under
    no row split, else its level's (`RowSplit.height`)."""
    return x.shape[-2] if _SPLIT is None else _SPLIT.height(x.shape[-1])


def plane_size(x: torch.Tensor) -> int:
    """H*W of the global image of a map x [B, C, H, W]: its own under no
    row split."""
    return global_height(x) * x.shape[-1]


def global_count(x: torch.Tensor) -> int:
    """The number of values a per-channel statistic of x [B, C, ...] spans
    over the global batch: every rank's batch rows and, under a row split,
    the global image's rows (computed from the level's global height, not
    from this rank's block, which may be shorter or empty)."""
    mesh = _ACTIVE
    per = x.numel() // x.shape[1] if x.shape[1] else 0
    if mesh is None:
        return per
    if _SPLIT is not None and x.dim() == 4:
        return global_rows(x.shape[0]) * plane_size(x)
    return per * mesh.world_size


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over the ranks of `group`, in place."""
    import torch.distributed as dist
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; dx = sum over ranks of dy."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce_(dy.contiguous().clone(), ctx.group), None


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x, group)
    return _all_reduce_(x.contiguous().clone(), group)


def all_reduce_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """x summed over the ranks of `mesh` (default: the active one); x
    itself without a mesh. Differentiable: the backward sums the cotangent
    over the ranks too."""
    mesh = mesh if mesh is not None else _ACTIVE
    return x if mesh is None else _sum_over(x, mesh.group)


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """x, a per-image sum over this rank's image rows, summed over the
    ranks of its data index under a row split: the global image's sum;
    x itself without one. Differentiable, as `all_reduce_sum`."""
    return x if _SPLIT is None else _sum_over(x, _SPLIT.group)


def _block(x: torch.Tensor, mesh, split) -> Tuple[tuple, tuple]:
    """(global shape, this rank's index into it) of a per-row tensor x
    [b, ...]: batch rows over the data axis and, under a row split, image
    rows on axis 1 of a tensor of 3 or more axes (NHWC logits, [B, H, W]
    labels). A tensor the row split does not cut is held whole by every
    rank of a data index and placed by spatial index 0 alone (the index is
    None on the others)."""
    b = x.shape[0]
    d = mesh.rank // mesh.spec.spatial
    shape = [b * mesh.spec.data] + list(x.shape[1:])
    index = [slice(d * b, (d + 1) * b)]
    if split is not None and x.dim() >= 3:
        shape[1] = split.height(x.shape[2])
        index.append(slice(*split.bounds(shape[1])))
    elif split is not None and split.index != 0:
        return tuple(shape), None
    return tuple(shape), tuple(index)


def _gather(x: torch.Tensor, mesh, split) -> torch.Tensor:
    shape, index = _block(x, mesh, split)
    buf = x.new_zeros(shape)
    if index is not None:
        buf[index] = x
    return _all_reduce_(buf, mesh.group)


class _GatherBatch(torch.autograd.Function):
    """y = every rank's block in place; dx = this rank's block of dy."""

    @staticmethod
    def forward(ctx, x, mesh, split):
        _, ctx.index = _block(x, mesh, split)
        ctx.shape = x.shape
        return _gather(x, mesh, split)

    @staticmethod
    def backward(ctx, dy):
        dx = dy.new_zeros(ctx.shape) if ctx.index is None else dy[ctx.index]
        return dx, None, None


def gather_batch(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The global batch of a per-row tensor x [b, ...]: every rank's rows
    in data order (data index d's at [d*b, (d+1)*b)) and, under the active
    row split, every rank's image rows in place, the same on every rank; x
    itself without a mesh. Differentiable in x."""
    split = _SPLIT if mesh is None else None
    mesh = mesh if mesh is not None else _ACTIVE
    if mesh is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherBatch.apply(x, mesh, split)
    return _gather(x, mesh, split)


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
        _all_reduce_(flat, mesh.group)
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
