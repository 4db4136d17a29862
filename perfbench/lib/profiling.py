"""The device trace of a few whole steps or requests, and what it reads.

`Profiler` runs `torch.profiler` over CUDA activity only: with the host's
operators recorded, the analysis of one search step took 38-57 s. The busy
time is the union of the device events' intervals, the idle share its
complement over the host clock's wall time of the profiled units, and each
kernel falls into a class by its name. The arithmetic and the classes are
copied from chip_smoke.py `profile()` and `_KERNEL_CLASSES`, with two
changes: the K1a pattern is the prefix `branch_stats_`, which both of its
kernels (`branch_stats_cta_kernel`, `branch_stats_warp_kernel`) carry, and
cuDNN's convolution kernels are told from cuBLAS's matmuls by the
library's marks in their names before any "gemm" is matched. The marks
were checked on the card against the aten operator that launched each
kernel (a profile with host operators, which the traced run does not
take: it would slow the step it measures).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

# (class, substrings of the kernel's name); the first class that matches wins
KERNEL_CLASSES = (
    ("branch_stats (K1a)", ("branch_stats_",)),
    ("apply_mix (K1b)", ("apply_mix_kernel",)),
    ("bwd_reduce (K1c)", ("bwd_reduce_partial_kernel", "bwd_reduce_finish_kernel")),
    ("bwd_dx (K1d)", ("bwd_dx_kernel",)),
    ("norm_convs (K2)", ("norm_convs_kernel",)),
    ("norm_convs bf16 (K2)", ("norm_convs_bf16_kernel",)),
    # before "convolution": cuDNN's BN kernels carry "cudnn" in their names
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw")),
    # cuDNN's kernels (the layout transposes it runs for a convolution among
    # them), its FFT convolutions' kernels with the complex GEMMs ("cf32") it
    # has cuBLAS run for them, and PyTorch's own depthwise ones; before
    # "matmul", since some of these carry "sgemm", "gemm" or "cublas"
    ("convolution", ("cudnn", "implicit_convolve", "conv", "fprop", "dgrad", "wgrad",
                     "winograd", "fft", "cf32", "region_transform", "flip_filter")),
    # cuBLAS's and CUTLASS's matmul kernels. cuDNN has cuBLAS run a real f32
    # GEMM for some convolution gradients too, under a name no different
    # from a matmul's: those land here
    ("matmul", ("cublas", "gemm", "gemv")),
    ("pool / upsample", ("pool", "upsample", "interp")),
    ("copy / cat", ("copy", "memcpy", "memset", "cat", "Cat")),
    ("optimizer", ("foreach", "multi_tensor", "sgd", "adam")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
K1_CLASSES = ("branch_stats (K1a)", "apply_mix (K1b)", "bwd_reduce (K1c)", "bwd_dx (K1d)")


def kernel_class(name: str) -> str:
    low = name.lower()
    return next((cls for cls, keys in KERNEL_CLASSES if any(k.lower() in low for k in keys)),
                "other")


def busy_us(spans: List[Tuple[float, float]]) -> float:
    """The length of the union of the intervals."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


@dataclasses.dataclass
class Trace:
    """Device events (name, start us, end us) of `units` whole units whose
    host-clock wall time was `wall_us`."""

    events: List[Tuple[str, float, float]]
    wall_us: float
    units: int

    @property
    def busy_us(self) -> float:
        return busy_us([(s, e) for _, s, e in self.events])

    def class_us(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.events:
            cls = kernel_class(name)
            out[cls] = out.get(cls, 0.0) + (e - s)
        return out

    def top_ops(self, n: int = 10) -> List[list]:
        """[name, seconds] of the n kernels that take the most device time."""
        by: Dict[str, float] = {}
        for name, s, e in self.events:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k, v / 1e6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """[name, seconds] of the idle gaps between device events, summed by
        the kernel that ends each gap: the host was launching it."""
        spans = sorted((s, e, name) for name, s, e in self.events)
        by: Dict[str, float] = {}
        end = spans[0][1] if spans else 0.0
        for s, e, name in spans[1:]:
            if s > end:
                key = "before " + name[:120]
                by[key] = by.get(key, 0.0) + (s - end)
            end = max(end, e)
        return [[k, v / 1e6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class Profiler:
    """Profiles a run of consecutive units: `start()` before the first,
    `stop()` after the last one's synchronise. CUDA activity only."""

    def __init__(self):
        self._prof = None
        self._t0 = self._wall_us = 0.0
        self.units = 0

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, units: int):
        wall_us = (time.perf_counter() - self._t0) * 1e6
        self._prof.__exit__(None, None, None)
        self._wall_us, self.units = wall_us, units

    def analyse(self) -> Optional[Trace]:
        """The device events, after the window: None where the profiler
        recorded no device activity."""
        if self._prof is None:
            return None
        from torch.autograd import DeviceType
        events = [(e.name, float(e.time_range.start), float(e.time_range.end))
                  for e in self._prof.events() if e.device_type == DeviceType.CUDA]
        self._prof = None
        if not events:
            return None
        return Trace(events, self._wall_us, self.units)
