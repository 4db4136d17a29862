"""The loop `steps`: the configuration's training step back to back, each
fed by its program's batch placer and ended by a synchronise.

Set-up builds one training state from the seed and drives it through its
first `check_steps` steps, through the window's own call and feed, on
batches whose rows all differ; those steps warm every shape. The window
then runs the same state on. After it the program is freed and the plain
reference runs the first steps again from the same weights, tables and
batches (`perfbench.lib.compare`).

What belongs to one configuration (how its program is built, the batches
a step takes, its tables, losses and FLOPs) comes from its program file,
`run.program` (`perfbench/programs/<config>.py`).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from perfbench.lib import compare
from perfbench.lib.batches import batches
from perfbench.lib.run import Run, sync
from perfbench.lib.weights import draw_arch, draw_state
from perfbench.reference import training

CHECK_STEPS = 3


def host_pool(cfg: dict, traffic: dict, seed: int, per_step: int) -> List[tuple]:
    """`traffic["pool"]` units of `per_step` host batches each."""
    rng = np.random.default_rng(seed)
    hw, c = cfg["image_size"], cfg["in_channels"]
    return [tuple(batches(rng, per_step, cfg["batch_size"], hw, c))
            for _ in range(traffic["pool"])]


def drive(run: Run, device, step_hook: Optional[Callable] = None) -> None:
    """Set-up, window and check of a step cell, into `run`. `step_hook`
    wraps the program's step (the tests plant faults with it)."""
    cfg, traffic, program = run.cfg, run.traffic, run.program
    pool = host_pool(cfg, traffic, run.seed, program.BATCHES_PER_STEP)
    run.mark("batches")
    ref_model = run.ref.build(cfg)
    state0 = draw_state(ref_model, run.seed, device)
    del ref_model
    shapes = program.arch_shapes(run.ref, cfg)
    arch0 = draw_arch(shapes, run.seed, device) if shapes else None

    place = program.batch_placer(device)
    run.mark("weights")
    st, step = program.build_step(cfg, state0, arch0, device)
    run.mark("program")
    if step_hook is not None:
        step = step_hook(step)

    def unit(i):
        m = step(st, tuple(place(b) for b in pool[i % len(pool)]))
        sync(device)
        return m

    losses: List[float] = []
    grads = None
    for i in range(CHECK_STEPS):
        losses += program.losses(cfg, unit(i))
        if i == 0:
            grads = program.first_gradients(st, arch0)
    change = program.state_change(st, state0, arch0)
    run.mark("first_steps")

    def timed(i):
        unit(CHECK_STEPS + i)

    run.window(timed, cfg["batch_size"], program.flops_per_step(cfg),
               traffic["profiled"] if run.trace else 0, traffic["profile_from"])

    prog = {"losses": losses, "grads": grads, "change": change}
    del st, step, unit, timed
    run.free_program()
    ref = training.steps(run.ref, cfg, state0, arch0, pool[:CHECK_STEPS], device)
    run.reference_done()
    gaps = compare.training_gaps(prog, ref)
    run.compared = {k: v["value"] for k, v in gaps.items()}
    run.phases["worst_leaves"] = {k: v["leaf"] for k, v in gaps.items() if v["leaf"]}
    run.checked = {"ref": ref, "state0": state0, "arch0": arch0, "units": pool[:CHECK_STEPS],
                   "gaps": gaps}
