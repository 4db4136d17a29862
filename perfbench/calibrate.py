"""Readings that the limits of `correct` are set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \
        --control-seeds 11,12,13 [--seconds 2]

For each seed one run of the cell with a short window (the program's
numbers, as a run compares them), in one process. For each control seed
also, against the same f32 reference:

  control   the reference in the program's place with TF32 on for cuDNN
            and cuBLAS, the precision below the configuration's f32
  half      (step cells) the reference in the program's place with half of
            each batch left out, the mean taken over the rest
  altered   (serve cells) the served masks with one slice of one request
            flipped, an answer altered where it is produced

A step left unchanged reads 1 on `change_gap` by construction and needs no
run. Prints one JSON line a seed; the limits in the configuration files
are set from them (PERF.md gives the readings).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from perfbench import run as bench_run  # noqa: E402
from perfbench.lib import cells, compare  # noqa: E402
from perfbench.reference import training  # noqa: E402


@contextlib.contextmanager
def tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def half(units):
    return [tuple({k: v[:len(v) // 2] for k, v in b.items()} for b in unit) for unit in units]


def step_controls(run, device) -> dict:
    c = run.checked
    args = (run.ref, run.cfg, c["state0"], c["arch0"])
    with tf32():
        control = training.steps(*args, c["units"], device)
    fault = training.steps(*args, half(c["units"]), device)
    return {"control": compare.training_gaps(control, c["ref"]),
            "half": compare.training_gaps(fault, c["ref"])}


def serve_controls(run, device) -> dict:
    c = run.checked
    volume = cells.load_loop(run.traffic["kind"]).volume
    model = run.ref.build(run.cfg, device)
    model.load_state_dict(c["state0"])
    control, altered = [], []
    with torch.no_grad():
        for i, masks in c["kept"].items():
            n, start = c["requests"][i % len(c["requests"])]
            x = torch.from_numpy(volume(c["pool"], n, start)).to(device)
            logits = run.ref.forward(model, run.cfg, None, x, False)[-1]
            with tf32():
                low = run.ref.forward(model, run.cfg, None, x, False)[-1]
            control.append(compare.mask_gap(logits, low.argmax(dim=-1)))
            flipped = torch.from_numpy(masks).to(device).clone()
            flipped[0] = run.cfg["nclass"] - 1 - flipped[0]
            altered.append(compare.mask_gap(logits, flipped))
    return {"control": {"mask_gap": max(control)}, "altered": {"mask_gap": max(altered)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        out, run = bench_run.execute(args.workload, seed, args.seconds, False, device)
        line = {"workload": args.workload, "seed": seed, "program": run.compared,
                "gaps": run.checked.get("gaps"), "phases": run.phases,
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "peak_bytes": run.peak_bytes, "reference_s": run.reference_s,
                "reference_peak_bytes": run.reference_peak_bytes}
        if seed in controls:
            fn = serve_controls if run.traffic["kind"] == "serve_closed" else step_controls
            line.update(fn(run, device))
        print(json.dumps(line), flush=True)
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
