"""One run of a cell: its set-up clock, the measured window, the trace and
the checked numbers, and the result line built from them.

The window runs units (a step, or a request) back to back until
`seconds` have passed, and always whole units: its length is from the
start of the first to the end of the last. With `trace` a run of
`profiled` consecutive units inside it is profiled (CUDA activity only);
the other units' times are the unprofiled ones that `mfu.*` and
`serve_volume_ms.p50` read.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import torch

from perfbench.lib.profiling import Profiler, Trace


def sync(device) -> None:
    """The runners' synchronise at a step's end."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Run:
    cell: dict
    cfg: dict
    traffic: dict
    ref: ModuleType
    program: ModuleType            # perfbench/programs/<config>.py
    seed: int
    seconds: float
    trace: bool
    t_start: float                 # time.time() at the process's start
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    unit_s: List[float] = dataclasses.field(default_factory=list)
    unit_items: List[int] = dataclasses.field(default_factory=list)
    unit_flops: List[float] = dataclasses.field(default_factory=list)
    profiled: range = range(0)
    trace_data: Optional[Trace] = None
    peak_bytes: int = 0
    reference_s: float = 0.0
    reference_peak_bytes: int = 0
    compared: Dict[str, float] = dataclasses.field(default_factory=dict)
    # what the check compared, for perfbench/calibrate.py's controls
    checked: dict = dataclasses.field(default_factory=dict)
    # set-up's phases (seconds since the process's start) and other notes for stderr
    phases: dict = dataclasses.field(default_factory=dict)

    def mark(self, phase: str) -> None:
        self.phases[phase] = round(time.time() - self.t_start, 3)

    def window(self, unit: Callable[[int], Optional[Tuple[int, float, float]]], items: int,
               flops: float, n_profiled: int = 0, profile_from: int = 0) -> None:
        """Runs unit(i) for i = 0, 1, ... until `seconds` have passed. A
        unit returns None (it took `items` and `flops`, timed here) or
        (items, flops, its own latency in seconds)."""
        device_cuda = self.device.type == "cuda"
        if device_cuda:
            torch.cuda.reset_peak_memory_stats()
        prof = Profiler() if n_profiled else None
        self.setup_s = time.time() - self.t_start
        t_win = time.perf_counter()
        i = 0
        while True:
            if prof is not None and i == profile_from:
                prof.start()
            t0 = time.perf_counter()
            got = unit(i)
            t1 = time.perf_counter()
            if got is None:
                got = (items, flops, t1 - t0)
            self.unit_items.append(got[0])
            self.unit_flops.append(got[1])
            self.unit_s.append(got[2])
            if prof is not None and i == profile_from + n_profiled - 1:
                prof.stop(n_profiled)
                self.profiled = range(profile_from, profile_from + n_profiled)
            i += 1
            done_profiling = prof is None or i >= profile_from + n_profiled
            if t1 - t_win >= self.seconds and done_profiling:
                break
        self.window_s = time.perf_counter() - t_win
        if device_cuda:
            self.peak_bytes = torch.cuda.max_memory_allocated()
        if prof is not None:
            self.trace_data = prof.analyse()

    def free_program(self) -> None:
        """After the window, once the caller has dropped the program's
        state: give its memory back and start the reference's clock."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self._t_ref = time.perf_counter()

    def reference_done(self) -> None:
        self.reference_s = time.perf_counter() - self._t_ref
        if self.device.type == "cuda":
            self.reference_peak_bytes = torch.cuda.max_memory_allocated()

    def summary(self) -> str:
        return (f"setup_s {self.setup_s:.3f} window_s {self.window_s:.3f} units "
                f"{len(self.unit_s)} items {sum(self.unit_items)} peak_bytes {self.peak_bytes} "
                f"reference_s {self.reference_s:.3f} reference_peak_bytes "
                f"{self.reference_peak_bytes} phases {self.phases}")

    def unprofiled(self) -> List[int]:
        return [i for i in range(len(self.unit_s)) if i not in self.profiled]


def check(run: Run) -> Tuple[bool, Dict[str, dict]]:
    """correct, and each number that the configuration's `limits` name for
    the cell's loop beside its limit; a named number the run did not read
    is not correct."""
    limits = run.cfg.get("limits", {}).get(run.traffic["kind"], {})
    shown = {k: {"value": run.compared.get(k), "limit": lim} for k, lim in limits.items()}
    ok = bool(shown) and all(s["value"] is not None and s["value"] <= s["limit"]
                             for s in shown.values())
    return ok, shown


def result(run: Run, metrics: List[dict], readers: Dict[str, Callable],
           device_info: dict) -> dict:
    """The result line: the cell's metrics that read a number, the device,
    with `trace` the breakdown, and last the compared numbers."""
    values = {}
    for m in metrics:
        v = readers[m["name"]](run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=int(run.peak_bytes))
    out = {"attempted": len(run.unit_s), "failed": 0, "metrics": values, "device": device}
    if run.trace and run.trace_data is not None:
        t = run.trace_data
        device["busy_s"] = t.busy_us / 1e6
        device["window_s"] = t.wall_us / 1e6
        out["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
    ok, shown = check(run)
    return {"correct": ok, **out, "compared": shown}
