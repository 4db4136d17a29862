"""The data-parallel mesh: one process per device, each a rank of a
torch.distributed process group.

Port of `senas_tpu/parallel/mesh.py`. The JAX package names a
`jax.sharding.Mesh` with a "data" axis (the batch) and a "spatial" one
(image rows) and lets GSPMD insert the collectives. Here a `Mesh` holds the
process group, this process's rank and device, and the spec; the batch is
split by rows (`shard_batch`), the state is replicated (`place_state`,
broadcast from rank 0) and stays so because every rank applies the same
summed gradient, and `shard_train_step` runs a step with the mesh active,
so that every reduction over the batch axis goes through
`senas_torch.parallel.collectives` as GSPMD would place it.

The backend follows the device: NCCL between cards, gloo on the CPU
(`backend_for`). A caller may pass its own initialised group, such as two
gloo ranks sharing one card. The spatial axis (the image-H split with halo
exchanges around every convolution) has no counterpart yet: a spec with
`spatial` > 1 over two or more ranks raises (ROADMAP.md M13b).
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Dict, Optional

import torch

from senas_torch.parallel.collectives import activate, broadcast_

# every process group gets a timeout, so that a rank that failed before a
# collective leaves the others waiting for at most this long
INIT_TIMEOUT = timedelta(seconds=60)
# the key `make_batch_placer` gives a batch that it placed whole on every
# rank (a trailing eval batch the ranks do not divide)
REPLICATED = "replicated"


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
    and device, and the spec."""

    spec: MeshSpec
    rank: int
    device: torch.device
    group: Any = None

    @property
    def world_size(self) -> int:
        return self.spec.data * self.spec.spatial

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.spec.data, "spatial": self.spec.spatial}

    @property
    def backend(self) -> Optional[str]:
        import torch.distributed as dist
        return None if self.group is None else dist.get_backend(self.group)

    def divides(self, rows: int) -> bool:
        return rows % self.spec.data == 0

    def rows(self, rows: int) -> slice:
        """This rank's rows of a global batch of `rows`."""
        if not self.divides(rows):
            raise ValueError(f"{rows} rows do not split over the mesh data axis "
                             f"({self.spec.data})")
        b = rows // self.spec.data
        return slice(self.rank * b, (self.rank + 1) * b)


def spatial_not_ported(spatial: int, world: int) -> NotImplementedError:
    """The error for a spatial axis over two or more ranks."""
    return NotImplementedError(
        f"mesh_spatial={spatial} over {world} ranks (the image-H split, with halo exchanges "
        "around every convolution, pooling and resize) is not ported yet (ROADMAP.md M13b)")


def make_mesh(group=None, spec: Optional[MeshSpec] = None, device=None) -> Mesh:
    """The mesh over `group` (default: the initialised default group; none
    initialised: one process). `device` defaults to the current card for an
    NCCL group and to the CPU otherwise."""
    import torch.distributed as dist

    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    if spec is None:
        spec = MeshSpec(data=world, spatial=1)
    if spec.data * spec.spatial != world:
        raise ValueError(f"mesh {spec} does not match {world} ranks")
    if spec.spatial > 1 and world > 1:
        raise spatial_not_ported(spec.spatial, world)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if group is not None and dist.get_backend(group) == "nccl"
                  else torch.device("cpu"))
    return Mesh(spec=spec, rank=rank, device=torch.device(device), group=group)


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of every array of a global batch dict: rank r keeps
    rows [r*B/R, (r+1)*B/R). Raises where R does not divide B."""
    return {k: v[mesh.rows(v.shape[0])] for k, v in batch.items()}


def assemble_global_batch(mesh: Mesh, local_batch: Dict[str, Any]):
    """Per-process loading, where each process loads only its own rows:
    returns (the local batch as given, the global shape of each array).
    The ranks' rows stand in rank order, as `shard_batch` cuts them."""
    shapes = {k: (v.shape[0] * mesh.spec.data,) + tuple(v.shape[1:])
              for k, v in local_batch.items()}
    return dict(local_batch), shapes


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


def shard_train_step(step_fn, mesh: Optional[Mesh]):
    """`step_fn` run with `mesh` active, so that its batch reductions span
    every rank. A call whose batch was placed whole on every rank (marked
    by `make_batch_placer`) runs as a single-device step. Without a mesh,
    or for one process with no group, `step_fn` itself."""
    if mesh is None or mesh.group is None:
        return step_fn

    def step(*args, **kw):
        whole = any(isinstance(a, dict) and a.get(REPLICATED) for a in args)
        with activate(None if whole else mesh):
            return step_fn(*args, **kw)

    return step
