"""What the metric readers under perfbench/metrics share. Each reader is
`read(run) -> number or None`; None leaves the metric out of the line."""

from __future__ import annotations

from typing import Optional

import numpy as np

from perfbench.lib.peaks import PEAK_BYTES_PER_S, PEAK_F32_FLOPS
from perfbench.lib.profiling import K1_CLASSES


def rate(run) -> float:
    """Items (train images, slices) of the units completed in the window,
    over the window's whole length."""
    return sum(run.unit_items) / run.window_s


def percentile_ms(run, q: float, unprofiled: bool = False) -> Optional[float]:
    idx = run.unprofiled() if unprofiled else range(len(run.unit_s))
    times = [run.unit_s[i] for i in idx]
    return float(np.percentile(times, q)) * 1e3 if times else None


def mfu(run) -> Optional[float]:
    """% of the f32 peak: the units' FLOPs over their time, unprofiled units."""
    idx = run.unprofiled()
    seconds = sum(run.unit_s[i] for i in idx)
    if not idx or seconds <= 0 or run.device.type != "cuda":
        return None
    return 100 * sum(run.unit_flops[i] for i in idx) / seconds / PEAK_F32_FLOPS


def per_unit_ms(run, classes) -> Optional[float]:
    """Device ms a profiled unit in the kernel classes `classes`; None
    without a trace or where no kernel of them ran."""
    t = run.trace_data
    if t is None:
        return None
    by = t.class_us()
    if not any(c in by for c in classes):
        return None
    return sum(by.get(c, 0.0) for c in classes) / 1e3 / t.units


def k1_roofline(run) -> Optional[float]:
    """% of K1a-K1d's byte bound: their bytes a step at 3.35 TB/s over
    their device time a step."""
    ms = per_unit_ms(run, K1_CLASSES)
    if ms is None:
        return None
    return 100 * run.cfg["counts"]["k1_bytes_per_step"] / PEAK_BYTES_PER_S / (ms / 1e3)


def launches(run) -> Optional[float]:
    t = run.trace_data
    return None if t is None else len(t.events) / t.units


def idle_share(run) -> Optional[float]:
    t = run.trace_data
    return None if t is None else 100 * (1 - t.busy_us / t.wall_us)


def peak_gib(run) -> Optional[float]:
    return run.peak_bytes / 2**30 if run.peak_bytes else None
