"""The loop `serve_closed`: one client in a closed loop sends one MR volume
at a time to the configuration's served program.

Set-up builds the program's predict (its program file's `build_predict`:
for `senas-fixed-promise12`, the eval-mode network exported, saved under
TMPDIR and loaded into a `Predictor`) and runs every volume size the
traffic sends once. A request is a host numpy volume [n, H, W, C_in],
normalised to zero mean and unit variance, timed from its submission to
its uint8 masks on the host. Every seed sends the same multiset of sizes,
the whole range once a cycle, in its own order. After the window the
program is freed and the plain reference judges a seed-drawn sample of the
served requests, the longest among them (`compare.mask_gap`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench.lib import compare
from perfbench.lib.run import Run
from perfbench.lib.weights import draw_state


def plan(traffic: dict, seed: int) -> List[tuple]:
    """(slices, first slice in the pool) of each request, in order."""
    lo, hi = traffic["slices"]
    rng = np.random.default_rng(seed)
    sizes = np.concatenate([rng.permutation(np.arange(lo, hi + 1))
                            for _ in range(traffic["cycles"])])
    starts = rng.integers(0, traffic["pool_slices"], len(sizes))
    return list(zip(sizes.tolist(), starts.tolist()))


def sample(requests: List[tuple], done: int, k: int, longest: int, seed: int) -> List[int]:
    """k of the `done` served requests drawn from the seed, and the first
    of the longest size among them."""
    rng = np.random.default_rng(seed + 2)
    picked = set(rng.choice(done, size=min(k, done), replace=False).tolist())
    first = next((i for i in range(done) if requests[i % len(requests)][0] == longest), None)
    return sorted(picked | ({first} if first is not None else set()))


def volume(pool: np.ndarray, n: int, start: int) -> np.ndarray:
    v = pool[(start + np.arange(n)) % len(pool)]
    return (v - v.mean()) / v.std()


def drive(run: Run, device, predict_hook: Optional[Callable] = None) -> None:
    """Set-up, window and check of a serve cell, into `run`. `predict_hook`
    wraps the program's predict (the tests plant faults with it)."""
    cfg, traffic = run.cfg, run.traffic
    ref_model = run.ref.build(cfg)
    state0 = draw_state(ref_model, run.seed, device)
    del ref_model
    run.mark("weights")
    predict = run.program.build_predict(cfg, state0, device, run.mark)
    if predict_hook is not None:
        predict = predict_hook(predict)

    hw, c = cfg["image_size"], cfg["in_channels"]
    rng = np.random.default_rng(run.seed)
    pool = rng.standard_normal((traffic["pool_slices"], hw, hw, c), dtype=np.float32)
    requests = plan(traffic, run.seed)
    lo, hi = traffic["slices"]
    run.mark("volumes")
    for n in range(lo, hi + 1):
        predict(volume(pool, n, 0))
    run.mark("warm_up")
    served: Dict[int, np.ndarray] = {}
    flops = cfg["counts"]["flops_per_image"]["forward"]

    def unit(i):
        n, start = requests[i % len(requests)]
        x = volume(pool, n, start)
        t0 = time.perf_counter()
        masks = predict(x)
        latency = time.perf_counter() - t0
        served[i] = masks
        return n, n * flops, latency

    run.window(unit, 0, 0.0, traffic["profiled"] if run.trace else 0, traffic["profile_from"])

    del predict, unit
    run.free_program()
    kept = {i: served[i] for i in sample(requests, len(served), traffic["sample"], hi, run.seed)}
    del served
    model = run.ref.build(cfg, device)
    model.load_state_dict(state0)
    gaps = []
    with torch.no_grad():
        for i, masks in sorted(kept.items()):
            n, start = requests[i % len(requests)]
            x = torch.from_numpy(volume(pool, n, start)).to(device)
            logits = run.ref.forward(model, cfg, None, x, False)[-1]
            gaps.append(compare.mask_gap(logits, torch.from_numpy(masks).to(device)))
    run.reference_done()
    run.compared = {"mask_gap": max(gaps)}
    run.checked = {"state0": state0, "pool": pool, "requests": requests, "kept": kept}
