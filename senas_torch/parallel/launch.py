"""One process per card for the CLIs.

`python -m senas_torch.search_arc` (and `train_model`, `testing_model`)
with `multi_gpus: true` on a host with N >= 2 visible cards, and no process
group described by the environment, starts N copies of itself
(`launch`): process i joins the group at 127.0.0.1 as rank i through
`SENAS_COORDINATOR`, `SENAS_NUM_PROCESSES`, `SENAS_PROCESS_ID` and drives
card i. Across hosts, start one process per card on each host with those
variables set (and `SENAS_LOCAL_RANK`, the card on its host); the CLI then
joins as that rank and spawns nothing.

The ranks are the same N whatever `mesh_spatial` says: each process lays
itself out on the mesh (`runner/common.py` `setup_mesh`).

If any process exits with an error, the others are stopped and the CLI
exits with that process's code: no rank carries on alone.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

ENV_KEYS = ("SENAS_COORDINATOR", "SENAS_NUM_PROCESSES", "SENAS_PROCESS_ID")
# seconds a stopped process has to exit before it is killed
STOP_GRACE_S = 10.0


def ranks_to_spawn(section: Dict[str, Any], device: str) -> int:
    """N, the visible cards, where a CLI run with this config section and
    --device should start N processes; 0 where it runs in this process
    (no `multi_gpus`, the CPU, one card, or a group already described by
    the environment or initialised)."""
    import torch.distributed as dist

    if not section.get("multi_gpus", False) or torch.device(device).type != "cuda":
        return 0
    if any(k in os.environ for k in ENV_KEYS) or (dist.is_available()
                                                  and dist.is_initialized()):
        return 0
    n = torch.cuda.device_count()
    return n if n >= 2 else 0


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs: Sequence[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + STOP_GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(module: str, argv: Sequence[str], nprocs: int, device_type: str = "cuda",
           timeout: Optional[float] = None) -> int:
    """Run `python -m module *argv --device <its device>` as `nprocs`
    ranks of one process group on 127.0.0.1 (gloo on the CPU, NCCL on the
    cards: process i takes card i). Returns 0 when every process exits 0;
    else, as soon as one fails, stops the others and returns its exit code.
    Past `timeout` seconds every process is stopped and 124 returned."""
    env = {**os.environ, "SENAS_COORDINATOR": f"127.0.0.1:{free_port()}",
           "SENAS_NUM_PROCESSES": str(nprocs)}
    procs: List[subprocess.Popen] = []
    try:
        for i in range(nprocs):
            dev = f"cuda:{i}" if device_type == "cuda" else device_type
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv, "--device", dev],
                env={**env, "SENAS_PROCESS_ID": str(i), "SENAS_LOCAL_RANK": str(i)}))
        start = time.monotonic()
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                _stop(procs)
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            if timeout is not None and time.monotonic() - start > timeout:
                _stop(procs)
                return 124
            time.sleep(0.2)
    finally:
        _stop(procs)
