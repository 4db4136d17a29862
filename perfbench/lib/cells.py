"""Find a cell's files by name.

`BENCHMARK.json` at the checkout's root names the cells; everything that
belongs to one configuration, traffic mix or metric is a file of its own:

    perfbench/configs/<config>.json     sizes, optimizers, stored counts, limits
    perfbench/reference/<config>.py     the plain reference of the configuration
    perfbench/programs/<config>.py      how the configuration's program is built
                                        and driven, and its precision
    perfbench/traffic/<traffic>.json    its loop (`kind`) and the loop's parameters
    perfbench/loops/<kind>.py           drive(run, device, hook): set-up, window, check
    perfbench/metrics/<metric>.py       read(run) -> number or None

A later cell, configuration or metric is added as files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(there are {[c['name'] for c in bench['workloads']]})")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file of `name`, as BENCHMARK.json's `configs` names it."""
    entry = next((c for c in bench["configs"] if c["name"] == name), None)
    if entry is None:
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
    with open(root / entry["file"]) as f:
        return json.load(f)


def load_traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _load_file(path: Path, module_name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reference(config: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """perfbench/reference/<config>.py, which defines build, forward and loss."""
    return _load_file(bench_dir / "reference" / f"{config}.py",
                      "perfbench_reference_" + config.replace("-", "_").replace(".", "_"))


def load_program(config: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """perfbench/programs/<config>.py: what the loops call to build and
    drive the configuration's program."""
    return _load_file(bench_dir / "programs" / f"{config}.py",
                      "perfbench_program_" + config.replace("-", "_").replace(".", "_"))


def load_loop(kind: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """perfbench/loops/<kind>.py, which defines drive(run, device, hook)."""
    return _load_file(bench_dir / "loops" / f"{kind}.py",
                      "perfbench_loop_" + kind.replace("-", "_").replace(".", "_"))


def load_reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """The `read` function of perfbench/metrics/<metric>.py."""
    return _load_file(bench_dir / "metrics" / f"{metric}.py",
                      "perfbench_metric_" + metric.replace(".", "_").replace("-", "_")).read


def _listed(metric: dict, cell: str) -> Optional[bool]:
    return cell in metric["workloads"] if "workloads" in metric else None


def end_to_end(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics the cell reports: those that list it, and
    those that list no cells."""
    return [m for m in bench["end_to_end"] if _listed(m, cell) in (True, None)]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those that list no cells and move an end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if _listed(m, cell) or ("workloads" not in m and m["moves"] in moved)]


def readers(metrics: List[dict], bench_dir: Path = BENCH_DIR) -> Dict[str, Callable]:
    return {m["name"]: load_reader(m["name"], bench_dir) for m in metrics}
