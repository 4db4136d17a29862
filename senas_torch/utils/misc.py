"""Seeding, parameter counting, step timing and the runners' trace.

The parts of `senas_tpu/utils/misc.py` that the runners and the loaders
use.
"""

from __future__ import annotations

import math
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn


def set_seed(seed: int):
    """Seed torch's default generators (CPU and every card), numpy's and
    Python's."""
    torch.manual_seed(seed)
    np.random.seed(seed)
    random.seed(seed)


def calc_parameters_count(model: nn.Module) -> float:
    """Parameter count in M (the reference's utils.py:155)."""
    return sum(p.numel() for p in model.parameters()) / 1e6


def create_class_weight(labels_dict: Dict[int, float], mu: float = 0.15) -> List[float]:
    """Log-scaled class weights, in key order: max(log(mu * total / count),
    1) (the reference's utils.py:302-310)."""
    total = sum(labels_dict.values())
    weights = []
    for key in sorted(labels_dict):
        score = math.log(mu * total / float(labels_dict[key]))
        weights.append(score if score > 1.0 else 1.0)
    return weights


def steady(xs: List[float]) -> List[float]:
    """The steps a StepTimer counts: the second half (the first ones warm
    up)."""
    return xs[max(1, len(xs) // 2):] or xs


def steady_share(part: List[float], whole: List[float]) -> float:
    """sum(part) / sum(whole) over the steps a StepTimer counts (0 without
    steps): e.g. a loop's per-step waits against its per-step wall times."""
    whole_s = sum(steady(whole))
    return sum(steady(part)) / whole_s if whole_s else 0.0


class StepTimer:
    """Wall-clock time of each step, with the JAX package's trace capture
    (senas_tpu/utils/misc.py:92-136). On a CUDA device the exit waits for
    the card (torch.cuda.synchronize), so a step's time is its device time
    and not only the host's time to enqueue it.

    With a trace directory (`trace_dir`, else the environment's
    `SENAS_TRACE_DIR`; none with `trace=False`, as a rank other than 0
    passes) a `torch.profiler` trace records the CPU, and the card where
    `device` is one, from entering step `trace_start` to leaving step
    `trace_start + trace_steps - 1` (steps [5, 8) by default, counted from
    0), and writes one Chrome trace file, `senas_trace_<pid>_<ns>.json`,
    into the directory (made if missing). The runners keep one timer an
    epoch, so each epoch of 6 or more steps writes one. A loop that ends
    inside the window stops the trace at `close()`, which the runners call
    after the loop: the file then holds the steps that ran."""

    def __init__(self, device: Optional[torch.device] = None, trace_dir: Optional[str] = None,
                 trace_start: int = 5, trace_steps: int = 3, trace: bool = True):
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.trace_dir = (trace_dir or os.environ.get("SENAS_TRACE_DIR")) if trace else None
        self.trace_start, self.trace_steps = trace_start, trace_steps
        self.trace_path: Optional[str] = None
        self._profiler = None
        self._step = 0
        self._t0 = 0.0
        self._times: List[float] = []

    def __enter__(self):
        if self.trace_dir and self._step == self.trace_start and self._profiler is None:
            self._start_trace()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._times.append(time.perf_counter() - self._t0)
        self._step += 1
        if self._profiler is not None and self._step >= self.trace_start + self.trace_steps:
            self.close()
        return False

    def _start_trace(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()

    def close(self) -> None:
        """Stop a running trace and write its file (nothing without one)."""
        if self._profiler is None:
            return
        prof, self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        self.trace_path = os.path.join(self.trace_dir,
                                       f"senas_trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(self.trace_path)

    @property
    def steps_per_sec(self) -> float:
        """Over the second half of the steps (the first ones warm up)."""
        if not self._times:
            return 0.0
        recent = steady(self._times)
        return 1.0 / (sum(recent) / len(recent))
