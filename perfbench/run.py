"""Run one cell of the benchmark of senas_torch and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. The cell,
its configuration, traffic and metrics are found by name from
BENCHMARK.json (perfbench/README.md). With --trace 0 the result carries
the cell's end-to-end metrics, with --trace 1 its per-layer metrics, the
device's busy time and a breakdown. The last line of standard output is
one JSON object; the numbers compared to decide `correct` close standard
error, each beside its limit. Without a card, or with fewer than the cell
asks for, it exits with 2 and prints no result; with JAX or senas_tpu
loaded it exits with 3.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".perfbench_cache")
# every kernel cache at a fixed path inside the checkout; no JAX through transformers
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "senas_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device,
            hook=None, bench=None):
    """One run of the cell on `device`; returns the result line's object
    and the run. The cell's configuration, reference, program, traffic,
    loop and metric readers are files found by name.
    `hook` wraps the program's timed call (the tests plant faults with it)."""
    from perfbench.lib import cells
    from perfbench.lib.run import Run, result

    bench = bench or cells.load_benchmark()
    cell = cells.find_cell(bench, cell_name)
    cfg = cells.load_config(bench, cell["config"])
    traffic = cells.load_traffic(cell["traffic"])
    program = cells.load_program(cell["config"])
    program.set_precision(cfg)
    metrics = (cells.per_layer if trace else cells.end_to_end)(bench, cell_name)
    readers = cells.readers(metrics)
    run = Run(cell=cell, cfg=cfg, traffic=traffic, ref=cells.load_reference(cell["config"]),
              program=program, seed=seed, seconds=seconds, trace=trace, t_start=T_START,
              device=device)
    cells.load_loop(traffic["kind"]).drive(run, device, hook)
    print(f"perfbench: {cell_name} seed {seed}: {run.summary()}", file=sys.stderr)
    import torch
    info = ({"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
            if device.type == "cuda" else {"platform": "cpu", "kind": "cpu", "count": 1})
    return result(run, metrics, readers, info), run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from perfbench.lib import cells
    bench = cells.load_benchmark()
    chips = cells.find_cell(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    out, _ = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
