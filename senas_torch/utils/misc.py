"""Seeding, parameter counting and step timing for the runners.

The parts of `senas_tpu/utils/misc.py` that the runners and the loaders
use.
"""

from __future__ import annotations

import math
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
    """Wall-clock time of each step. On a CUDA device the exit waits for
    the card (torch.cuda.synchronize), so a step's time is its device time
    and not only the host's time to enqueue it."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self._t0 = 0.0
        self._times: List[float] = []

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._times.append(time.perf_counter() - self._t0)
        return False

    @property
    def steps_per_sec(self) -> float:
        """Over the second half of the steps (the first ones warm up)."""
        if not self._times:
            return 0.0
        recent = steady(self._times)
        return 1.0 / (sum(recent) / len(recent))
