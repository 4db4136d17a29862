"""A whole run of each cell at a tiny size on the CPU: past the look for a
card, the result line's shape; with the timed path broken underneath,
`correct` comes out false for each fault the cell can have."""

import json

import pytest
import torch

from perfbench import run as bench_run
from perfbench.lib import cells

CELLS = [c["name"] for c in cells.load_benchmark()["workloads"]]
CPU = torch.device("cpu")


def _run(tiny_bench, cell, hook=None, trace=False):
    out, _ = bench_run.execute(cell, 2**31 + 11, 0.5, trace, CPU, hook=hook, bench=tiny_bench)
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(tiny_bench, cell):
    out = _run(tiny_bench, cell)
    assert list(out)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"]: m["unit"] for m in cells.end_to_end(tiny_bench, cell)}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert not bench_run.forbidden_modules()


def test_trace_run_reads_nothing_without_a_device_trace(tiny_bench):
    """On the CPU no device metric is read: a reader that finds nothing
    leaves its metric out, and no number of the CPU stands under a device
    metric's name."""
    out, run = bench_run.execute("train-promise12-b96", 5, 0.2, False, CPU, bench=tiny_bench)
    layers = cells.readers(cells.per_layer(tiny_bench, "train-promise12-b96"))
    run.trace = True
    read = {k: f(run) for k, f in layers.items()}
    assert read["idle_share.train"] is None and read["conv_ms_per_step.train"] is None
    assert read["mfu.train"] is None and read["peak_mem_gib.train"] is None


def _unchanged(step):
    """A step that returns its metrics and leaves the state as it was."""
    def broken(st, unit):
        model = {k: v.clone() for k, v in st.model.state_dict().items()}
        arch = {k: v.detach().clone() for k, v in getattr(st, "arch", {}).items()}
        m = step(st, unit)
        st.model.load_state_dict(model)
        with torch.no_grad():
            for k, v in arch.items():
                st.arch[k].copy_(v)
        return m
    return broken


def _half_batch(step):
    """Half of each batch left out, the mean taken over the rest."""
    return lambda st, unit: step(st, tuple({k: v[:len(v) // 2] for k, v in b.items()}
                                           for b in unit))


def _altered(predict):
    """An answer altered where it is produced: the first slice's mask flipped."""
    def broken(x):
        masks = predict(x)
        masks[0] = 1 - masks[0]
        return masks
    return broken


FAULTS = [(c, f) for c in CELLS if not c.startswith("serve") for f in (_unchanged, _half_batch)]
FAULTS += [(c, _altered) for c in CELLS if c.startswith("serve")]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(tiny_bench, cell, fault):
    out = _run(tiny_bench, cell, hook=fault)
    assert out["correct"] is False, out["compared"]
