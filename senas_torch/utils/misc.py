"""Seeding, parameter counting, step timing and the runners' trace, the
cards' memory and a model's flop count. The trace's phase spans live in
`utils/spans.py`; `span` and `take` are re-exported here.

Port of `senas_tpu/utils/misc.py`: the device queries read the CUDA
allocator (`torch.cuda.mem_get_info`, `memory_allocated`,
`max_memory_allocated`) where the JAX package reads
`jax.Device.memory_stats()`, under the JAX package's keys.
"""

from __future__ import annotations

import gc
import math
import os
import random
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from senas_torch.core.device import resolve_device
from senas_torch.utils import spans
from senas_torch.utils.spans import span, take  # noqa: F401 (re-exported)


def set_seed(seed: int):
    """Seed torch's default generators (CPU and every card), numpy's and
    Python's."""
    torch.manual_seed(seed)
    np.random.seed(seed)
    random.seed(seed)


def calc_parameters_count(model: nn.Module) -> float:
    """Parameter count in M (the reference's utils.py:155)."""
    return sum(p.numel() for p in model.parameters()) / 1e6


def get_gpus_memory_info() -> Tuple[int, Dict]:
    """(the index of the card with the most free memory, stats of each
    card). A card's stats carry the JAX package's keys: `bytes_limit` (its
    memory, `mem_get_info`'s total), `bytes_in_use` (this process's
    tensors, `memory_allocated`) and `peak_bytes_in_use`
    (`max_memory_allocated`); the free memory it is picked by is
    `mem_get_info`'s (other processes' use included). Without a card it
    is the JAX package's answer on its CPU backend, (0, {0: {}})."""
    if not torch.cuda.is_available():
        return 0, {0: {}}
    best, best_free, stats = 0, -1, {}
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        stats[i] = {"bytes_limit": total, "bytes_in_use": torch.cuda.memory_allocated(i),
                    "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)}
        if free > best_free:
            best, best_free = i, free
    return best, stats


def _live_tensors(device: torch.device) -> List[torch.Tensor]:
    """The tensors on `device` that the garbage collector tracks (the
    reference's utils/gpu_memory_log.py walk). A tensor of symbolic shape
    (a traced program's placeholder, e.g. a `torch.export` program's fake
    values) holds no memory and is left out."""
    found = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # deprecated objects warn when inspected
        for obj in gc.get_objects():
            try:
                if (isinstance(obj, torch.Tensor) and obj.device == device
                        and all(type(d) is int for d in obj.shape)):
                    found.append(obj)
            except Exception:   # objects whose attributes cannot be read
                continue
    return found


def device_memory_log(logger=None, top_k: int = 20, device=None) -> Dict:
    """Log each card's memory and the largest live tensors on `device`
    (None means the card) by shape and dtype, in the JAX package's line
    formats (dtype names as `float32`). Returns `get_gpus_memory_info`'s
    stats."""
    emit = logger.info if logger else print
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _, stats = get_gpus_memory_info()
    for i, s in stats.items():
        emit(f"device {i}: in_use={s.get('bytes_in_use', 0)/2**20:.1f}MiB "
             f"limit={s.get('bytes_limit', 0)/2**20:.1f}MiB "
             f"peak={s.get('peak_bytes_in_use', 0)/2**20:.1f}MiB")
    by_shape: Dict[Tuple, Tuple[int, int]] = {}
    live = _live_tensors(dev)
    for t in live:
        key = (tuple(t.shape), str(t.dtype).removeprefix("torch."))
        count, size = by_shape.get(key, (0, 0))
        by_shape[key] = (count + 1, size + t.numel() * t.element_size())
    rows = sorted(by_shape.items(), key=lambda kv: -kv[1][1])[:top_k]
    total = sum(size for _, (_, size) in by_shape.items())
    emit(f"live arrays: {len(live)} ({total/2**20:.1f}MiB)")
    for (shape, dtype), (count, size) in rows:
        emit(f"  {count:4d} x {dtype}{list(shape)} = {size/2**20:.2f}MiB")
    return stats


def one_hot_encoding(labels: np.ndarray, nclass: int) -> np.ndarray:
    """[B,H,W] int -> [B,nclass,H,W] one-hot (utils.py:216-230 layout)."""
    out = np.zeros((labels.shape[0], nclass) + labels.shape[1:], np.float32)
    for c in range(nclass):
        out[:, c] = labels == c
    return out


def flops_params_info(model: nn.Module, example_input: torch.Tensor) -> Dict[str, float]:
    """The flops of one inference-mode forward of `model` on
    `example_input` (where it lies) and its parameter count in M (the
    reference's ptflops/torchstat report, utils.py:323-330).

    The flops are `torch.utils.flop_counter.FlopCounterMode`'s: 2 a
    multiply-add of the matrix products and of every convolution window
    (transposed ones included), the zero padding's products included, and
    nothing else; a kernel launched outside PyTorch's dispatcher (the
    epilogue's CUDA kernels) is not counted. The JAX package's number is
    XLA's `cost_analysis` of the compiled program, which counts only the
    taps that land inside the input and also one flop an element of each
    elementwise op and reduction (BatchNorm, activations, pooling,
    resizes), so either may be the larger: a padded 3x3 convolution of 3
    to 8 channels on 10x10 with a bias is 43200 here and 38432 in XLA's
    count (2*8*3*784 taps inside the input + 800 adds)."""
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(example_input)
    return {"flops": float(counter.get_total_flops()),
            "params_m": calc_parameters_count(model)}


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
    after the loop: the file then holds the steps that ran. The program's
    spans (`utils/spans.py`) show in the file as user annotations around
    their operators; `close()` clears their in-memory record."""

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
        """Stop a running trace and write its file (nothing without one), and
        clear the spans' in-memory record."""
        spans.clear()
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
