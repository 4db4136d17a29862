"""The mesh: one process per device, each a rank of a torch.distributed
process group, laid out over a "data" axis (the batch) and a "spatial"
one (image rows).

Port of `senas_tpu/parallel/mesh.py`. The JAX package names a
`jax.sharding.Mesh` of `np.array(devices).reshape(data, spatial)` and lets
GSPMD insert the collectives. Here a `Mesh` holds the process group, this
process's rank and device, the spec, and the subgroups of its two axes:
rank r sits at data index d = r // spatial and spatial index s = r %
spatial. The batch is split by rows over the data axis and, where asked,
the image rows over the spatial one (`shard_batch`); the state is
replicated (`place_state`, broadcast from rank 0) and stays so because
every rank applies the same summed gradient; `shard_train_step` runs a step
with the mesh active, so that every reduction over the batch, and every
convolution, pooling and resize over a split image, goes through
`senas_torch.parallel.collectives` and `senas_torch.parallel.spatial` as
GSPMD would place them.

The backend follows the device: NCCL between cards, gloo on the CPU
(`backend_for`). A caller may pass its own initialised group, such as two
gloo ranks sharing one card.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Callable, Dict, Optional

import torch

from senas_torch.parallel.collectives import activate, broadcast_, row_bounds

# every process group gets a timeout, so that a rank that failed before a
# collective leaves the others waiting for at most this long
INIT_TIMEOUT = timedelta(seconds=60)
# the key `make_batch_placer` gives a batch that it placed whole on every
# rank (a trailing eval batch the ranks do not divide)
REPLICATED = "replicated"
# the key `shard_batch` gives a batch whose image rows it split over the
# spatial axis; its value is the global image's (H, W)
ROW_SPLIT = "row_split"


def backend_for(device: torch.device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> bool:
    """Join the process group that the arguments, else the environment,
    describe: `SENAS_COORDINATOR` (host:port of rank 0), `SENAS_NUM_PROCESSES`
    and `SENAS_PROCESS_ID`. Without them (one process) it does nothing and
    returns False; with a group already initialised it returns True.

    `device` (default: the card) picks the backend. On the card this
    process takes card `SENAS_LOCAL_RANK`, else `process_id` modulo the
    visible cards, as its current device."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    coord = coordinator_address or os.environ.get("SENAS_COORDINATOR")
    nproc = num_processes if num_processes is not None else (
        int(os.environ["SENAS_NUM_PROCESSES"]) if "SENAS_NUM_PROCESSES" in os.environ
        else None)
    pid = process_id if process_id is not None else (
        int(os.environ["SENAS_PROCESS_ID"]) if "SENAS_PROCESS_ID" in os.environ else None)
    if coord is None and nproc is None:
        return False  # single-process
    if coord is None or nproc is None or pid is None:
        raise ValueError("a process group needs SENAS_COORDINATOR, SENAS_NUM_PROCESSES and "
                         f"SENAS_PROCESS_ID; got {coord!r}, {nproc!r}, {pid!r}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_device_index(pid))
    dist.init_process_group(backend_for(dev), init_method=f"tcp://{coord}",
                            world_size=nproc, rank=pid, timeout=INIT_TIMEOUT)
    return True


def local_device_index(process_id: int) -> int:
    """The card of process `process_id` on its host."""
    if "SENAS_LOCAL_RANK" in os.environ:
        return int(os.environ["SENAS_LOCAL_RANK"])
    return process_id % max(torch.cuda.device_count(), 1)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh description. data*spatial must equal the ranks."""

    data: int
    spatial: int = 1

    @property
    def axis_names(self):
        return ("data", "spatial")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process group (None: one process, no group), this process's rank
    and device, the spec, and this rank's subgroups: the ranks of its data
    index (its image-row neighbours) and those of its spatial index. A
    subgroup of one rank is None."""

    spec: MeshSpec
    rank: int
    device: torch.device
    group: Any = None
    spatial_group: Any = None
    data_group: Any = None

    @property
    def world_size(self) -> int:
        return self.spec.data * self.spec.spatial

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.spec.data, "spatial": self.spec.spatial}

    @property
    def data_index(self) -> int:
        return self.rank // self.spec.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spec.spatial

    @property
    def backend(self) -> Optional[str]:
        import torch.distributed as dist
        return None if self.group is None else dist.get_backend(self.group)

    def divides(self, rows: int) -> bool:
        return rows % self.spec.data == 0

    def rows(self, rows: int) -> slice:
        """This rank's rows of a global batch of `rows`: those of its data
        index."""
        if not self.divides(rows):
            raise ValueError(f"{rows} rows do not split over the mesh data axis "
                             f"({self.spec.data})")
        b = rows // self.spec.data
        return slice(self.data_index * b, (self.data_index + 1) * b)

    def image_rows(self, height: int) -> slice:
        """This rank's image rows of a level `height` rows high, [s*H/S,
        (s+1)*H/S) rounded down (`collectives.row_bounds`): contiguous
        blocks that differ by at most one row, empty where H < S."""
        return slice(*row_bounds(height, self.spec.spatial, self.spatial_index))

    def data_view(self) -> "Mesh":
        """The mesh of this rank's data subgroup alone: a step whose batch
        rows went whole to every rank of a data index (the image H that the
        spatial axis does not divide) reduces over the data axis only, so
        that those rows count once."""
        group = self.group if self.spec.spatial == 1 else self.data_group
        return Mesh(spec=MeshSpec(data=self.spec.data), rank=self.data_index,
                    device=self.device, group=group)


def _subgroups(group, spec: MeshSpec, rank: int):
    """(spatial subgroup, data subgroup) of `rank`. Every rank creates every
    subgroup, in one order, those it is not in included."""
    import torch.distributed as dist
    ranks = dist.get_process_group_ranks(group)
    S, D = spec.spatial, spec.data
    found = {}
    for axis, members in (("spatial", [[d * S + s for s in range(S)] for d in range(D)]),
                          ("data", [[d * S + s for d in range(D)] for s in range(S)])):
        for idx in members:
            if len(idx) < 2:
                continue
            g = dist.new_group([ranks[i] for i in idx], timeout=INIT_TIMEOUT)
            if rank in idx:
                found[axis] = g
    return found.get("spatial"), found.get("data")


def make_mesh(group=None, spec: Optional[MeshSpec] = None, device=None) -> Mesh:
    """The mesh over `group` (default: the initialised default group; none
    initialised: one process). `spec` defaults to every rank on the data
    axis; with a spatial axis the subgroups of both axes are created here,
    by every rank. `device` defaults to the current card for an NCCL group
    and to the CPU otherwise."""
    import torch.distributed as dist

    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    if spec is None:
        spec = MeshSpec(data=world, spatial=1)
    if spec.data * spec.spatial != world:
        raise ValueError(f"mesh {spec} does not match {world} ranks")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if group is not None and dist.get_backend(group) == "nccl"
                  else torch.device("cpu"))
    spatial_group = data_group = None
    if group is not None and spec.spatial > 1:
        spatial_group, data_group = _subgroups(group, spec, rank)
    return Mesh(spec=spec, rank=rank, device=torch.device(device), group=group,
                spatial_group=spatial_group, data_group=data_group)


def shard_batch(mesh: Mesh, batch: Dict[str, Any], spatial: bool = False) -> Dict[str, Any]:
    """This rank's part of every array of a global batch dict: the rows
    [d*B/D, (d+1)*B/D) of its data index d, and with `spatial` also its
    image rows (axis 1 of an image [B, H, W, C] or a label map [B, H, W];
    arrays of fewer axes keep every column), marked with `ROW_SPLIT` (the
    global image's H, W). Raises where D does not divide B, or with
    `spatial` where the spatial size does not divide H (senas_tpu's
    placement needs both)."""
    out = {k: v[mesh.rows(v.shape[0])] for k, v in batch.items()}
    if not spatial or mesh.spec.spatial == 1:
        return out
    image = batch["image"]
    h, w = int(image.shape[1]), int(image.shape[2])
    if h % mesh.spec.spatial:
        raise ValueError(f"image height {h} does not split over the mesh spatial axis "
                         f"({mesh.spec.spatial})")
    rows = mesh.image_rows(h)
    out = {k: v[:, rows] if v.ndim >= 3 else v for k, v in out.items()}
    out[ROW_SPLIT] = (h, w)
    return out


def batch_sharding(mesh: Mesh, spatial: bool = True) -> Callable[[Any], Any]:
    """The placement senas_tpu's `batch_sharding` names for a [B, H, W, C]
    batch (B over the data axis, with `spatial` H over the spatial axis),
    as the function that cuts a global array to this rank's part, as
    `shard_batch` cuts its image."""
    return lambda v: shard_batch(mesh, {"image": v}, spatial)["image"]


def assemble_global_batch(mesh: Mesh, local_batch: Dict[str, Any], spatial: bool = False):
    """Per-process loading, where each process loads only its own part:
    returns (the local batch as given, the global shape of each array). The
    parts stand in rank order, as `shard_batch` cuts them (with `spatial`,
    the image rows of axis 1 too)."""
    def global_shape(v):
        shape = [v.shape[0] * mesh.spec.data] + list(v.shape[1:])
        if spatial and v.ndim >= 3:
            shape[1] *= mesh.spec.spatial
        return tuple(shape)

    return dict(local_batch), {k: global_shape(v) for k, v in local_batch.items()
                               if hasattr(v, "shape")}


def replicate(mesh: Mesh, tensors) -> None:
    """Rank 0's values of `tensors` on every rank, in place."""
    broadcast_(list(tensors), mesh)


def state_tensors(state) -> list:
    """Every tensor a train state carries: its model's parameters and
    buffers, its optimizers' state, its arch tables."""
    found = []

    def visit(v):
        if isinstance(v, torch.Tensor):
            found.append(v)
        elif isinstance(v, torch.nn.Module):
            found.extend(v.parameters())
            found.extend(v.buffers())
        elif isinstance(v, torch.optim.Optimizer):
            for p in (p for g in v.param_groups for p in g["params"]):
                for s in v.state.get(p, {}).values():
                    visit(s)
        elif isinstance(v, dict):
            for x in v.values():
                visit(x)

    for f in dataclasses.fields(state):
        visit(getattr(state, f.name))
    return found


def place_state(mesh: Mesh, state):
    """Replicate a train state (`FixedTrainState`, `SearchTrainState`)
    over the mesh: rank 0's values broadcast into every rank's tensors, in
    place. Returns the state."""
    replicate(mesh, state_tensors(state))
    return state


def _placement(args) -> tuple:
    """(whole, row split) of the batch dicts among a step's arguments: any
    placed whole on every rank; the global image (H, W) of those whose
    image rows are split, which every batch of the step must share."""
    batches = [a for a in args if isinstance(a, dict) and "image" in a]
    whole = any(b.get(REPLICATED) for b in batches)
    splits = {b.get(ROW_SPLIT) for b in batches}
    if len(splits) > 1:
        raise ValueError(f"a step's batches are placed differently: {splits}")
    return whole, (splits.pop() if splits else None)


def shard_train_step(step_fn, mesh: Optional[Mesh]):
    """`step_fn` run with `mesh` active, so that its batch reductions span
    every rank. A call whose batch was placed whole on every rank (marked
    by `make_batch_placer`) runs as a single-device step; one whose image
    rows were split (`ROW_SPLIT`) runs with the row split active; on a mesh
    with a spatial axis, one whose rows were not split runs over the data
    subgroup (`Mesh.data_view`). Without a mesh, or for one process with no
    group, `step_fn` itself."""
    if mesh is None or mesh.group is None:
        return step_fn

    def step(*args, **kw):
        whole, split = _placement(args)
        if whole:
            active = activate(None)
        elif split is not None:
            active = activate(mesh, image_hw=split)
        elif mesh.spec.spatial > 1:
            active = activate(mesh.data_view())
        else:
            active = activate(mesh)
        with active:
            return step_fn(*args, **kw)

    return step
