"""On the card: each cell's control (the reference in the program's place
in TF32, the precision below the configurations' f32) and its faults fail
the committed limits, while the program passes them, at the cells' own
sizes (a few minutes a cell). Run on a card with

    python -m pytest perfbench/tests/test_perfbench_cuda.py -m cuda -p no:cacheprovider

Skips without a card."""

import pytest
import torch

from perfbench import calibrate
from perfbench import run as bench_run
from perfbench.lib import cells

BENCH = cells.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _fails(numbers, limits):
    """Whether a control's or fault's numbers fail one of the limits
    (calibrate gives a step cell's with the leaf that reads each)."""
    value = lambda x: x["value"] if isinstance(x, dict) else x
    return any(value(numbers[k]) > lim for k, lim in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_the_program_passes(card, cell):
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        out, run = bench_run.execute(cell, seed, 1.0, False, card)
        assert out["correct"] is True, out["compared"]
        limits = run.cfg["limits"][run.traffic["kind"]]
        serve = run.traffic["kind"] == "serve_closed"
        got = (calibrate.serve_controls if serve else calibrate.step_controls)(run, card)
        for name, numbers in got.items():
            assert _fails(numbers, limits), (name, numbers, limits)
