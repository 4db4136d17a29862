"""Where a benchmark cell's device idle time goes, phase by phase.

    python3 tools/span_report.py --workload search-promise12-b32 --seed 2147483701 --seconds 51

runs the cell as `perfbench/run.py --trace 1` does (same set-up, window,
profiled units and check), then prints the result line and one JSON object
per profiled run: the gap idle a unit, the idle charged to each span name
and to "outside" (perfbench/lib/spans.py), the host time and self time of
each span name a unit, the host time outside every span, and where the
first copy to the device lay in its `h2d` span. Needs an NVIDIA card.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def report(run) -> dict:
    from perfbench.lib import spans as charge

    c = charge.charged(run)
    rec = charge.record(run)
    if c is None:
        return {"spans": None}
    per = lambda us: us / 1e3 / c.units
    host, own = {}, {}
    for s, t in zip(rec.spans, charge.self_ns(rec.spans)):
        host[s.name] = host.get(s.name, 0.0) + per((s.end_ns - s.start_ns) / 1e3)
        own[s.name] = own.get(s.name, 0.0) + per(t / 1e3)
    roots = sum((s.end_ns - s.start_ns) / 1e3 for s in rec.spans if s.parent < 0)
    h2d = min((i for i, n in enumerate(c.names) if n == "h2d"), key=lambda i: c.start_us[i])
    copy = min((s, e) for n, s, e in run.trace_data.events if "HtoD" in n)
    return {
        "units": c.units, "dropped": rec.dropped,
        "wall_ms_per_unit": per(run.trace_data.wall_us),
        "busy_ms_per_unit": per(run.trace_data.busy_us),
        "gap_idle_ms_per_unit": per(c.gap_us),
        "charged_ms_per_unit": per(sum(c.idle_us) + c.outside_us),
        "idle_ms_per_unit": {k: per(v) for k, v in c.by_name_us().items()},
        "host_ms_per_unit": host, "host_self_ms_per_unit": own,
        "host_outside_ms_per_unit": per(run.trace_data.wall_us - roots),
        "first_copy_after_h2d_start_ms": (copy[0] - c.start_us[h2d]) / 1e3,
        "first_copy_ms": (copy[1] - copy[0]) / 1e3,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    import torch
    from perfbench import run as bench_run

    if not torch.cuda.is_available():
        print("span_report: needs a CUDA device", file=sys.stderr)
        return 2
    out, run = bench_run.execute(args.workload, args.seed, args.seconds, True,
                                 torch.device("cuda", 0))
    print(json.dumps(out), flush=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed, **report(run)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
