"""Run-dir logging and scalar logging for the runners.

The parts of `senas_tpu/utils/logging.py` that the search runner uses,
copied: stdout + run.log file logger, the run-dir layout
<log_root>/<model>/<phase>/<dataset>/<phase>-<timestamp>/ with the config
YAML copied in, and a JSONL scalar log (scalars.jsonl). TensorBoard output
is not ported.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
import time
from typing import Optional


def get_logger(log_dir: str, name: str = "senas_torch") -> logging.Logger:
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(f"{name}:{log_dir}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        fh = logging.FileHandler(os.path.join(log_dir, "run.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def close_logger(logger: logging.Logger) -> None:
    """Close and detach the logger's handlers (its run.log file)."""
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)


def make_run_dir(log_root: str, model: str, phase: str, dataset: str,
                 config_path: Optional[str] = None) -> str:
    """<log_root>/<model>/<phase>/<dataset>/<phase>-<timestamp>/ with the
    config copied in (search_arc.py:51-59 convention)."""
    stamp = time.strftime("%Y%m%d-%H%M%S")
    run_dir = os.path.join(log_root, model, phase, dataset, f"{phase}-{stamp}")
    os.makedirs(run_dir, exist_ok=True)
    if config_path and os.path.exists(config_path):
        shutil.copy(config_path, run_dir)
    return run_dir


def calc_time(seconds: float) -> str:
    m, s = divmod(int(seconds), 60)
    h, m = divmod(m, 60)
    d, h = divmod(h, 24)
    return f"{d}d {h}h {m}m {s}s"


class ScalarWriter:
    """Scalar logging to <log_dir>/scalars.jsonl, one JSON object a line."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": int(step), "t": time.time()}) + "\n")
        self._jsonl.flush()

    def export_scalars_to_json(self, path: str):
        # the JSONL is already on disk; the reference's export hook copies it
        shutil.copy(os.path.join(self.log_dir, "scalars.jsonl"), path)

    def close(self):
        self._jsonl.close()
