"""The program's spans on the card, at the benchmark's sizes
(perfbench/configs): a search step under the benchmark's CUDA-only
profile has the same device events, by name and count, with the spans as
without them; and in a CPU+CUDA profile of two search steps and one of
three served requests, the spans that perfbench/lib/spans.py anchors on the
device clock start within 0.2 ms of the profiler's own record_function
times, and the idle charged to each phase agrees with the idle charged
through the profiler's times within 2 points of the profiled wall time.

The profiler's own times are a reference only where they are causal. Its
device annotation of each `h2d` span (the span's copy, found by the
launch's correlation, not by time) must start after the span starts and
end before it ends (the copy is synchronous, or its last part is staged
when the call returns): each such pair bounds how far the spans may move
against the device's events, and the profiler's own alignment must lie
within those bounds, 0.2 ms allowed. On the card it did not in some
profiles (a synchronous copy ending 5.7 ms after its call returned), so a
test profiles up to three times, holds the anchor to the bounds in every
profile and to the profiler's times in the first whose times are causal.
Each test prints what it measured. Every test here needs an NVIDIA GPU
and skips without one; on the card (this file imports no JAX):

    python -m pytest --noconftest tests/test_torch_spans_cuda.py -m cuda -s
"""

import collections
import gc
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from perfbench.lib import cells
from perfbench.lib import spans as charge
from perfbench.lib.profiling import Profiler
from perfbench.lib.run import sync
from perfbench.lib.weights import draw_arch, draw_state
from senas_torch.utils import spans

pytestmark = pytest.mark.cuda

SEED = 2**31 + 24
# the spans look this up at each call; the tests turn them off by replacing it
PROFILER_ENABLED = torch.autograd._profiler_enabled
NAMES = ("place", "h2d", "search_step", "arch_forward", "arch_backward", "arch_update",
         "weight_forward", "weight_backward", "weight_update", "serve_request", "stage_in",
         "program", "readback")
START_MS = 0.2
SHARE_POINTS = 2.0
SEARCH_PHASES = {"place": ("place",), "forward": ("arch_forward", "weight_forward"),
                 "backward": ("arch_backward", "weight_backward"),
                 "update": ("arch_update", "weight_update"), "step": ("search_step",)}
SERVE_PHASES = {"stage_in": ("stage_in",), "program": ("program",),
                "readback": ("readback",), "request": ("serve_request",)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    yield torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()


def _cell(name):
    bench = cells.load_benchmark()
    cell = cells.find_cell(bench, name)
    cfg = cells.load_config(bench, cell["config"])
    program = cells.load_program(cell["config"])
    program.set_precision(cfg)
    return cfg, cells.load_traffic(cell["traffic"]), program, cells.load_reference(cell["config"])


def _search_unit(dev):
    """unit(i): the search cell's placed batches, its step and the
    synchronise, as the benchmark's loop runs them."""
    cfg, traffic, program, ref = _cell("search-promise12-b32")
    pool = cells.load_loop("steps").host_pool(cfg, traffic, SEED, program.BATCHES_PER_STEP)
    state0 = draw_state(ref.build(cfg), SEED, dev)
    arch0 = draw_arch(program.arch_shapes(ref, cfg), SEED, dev)
    place = program.batch_placer(dev)
    st, step = program.build_step(cfg, state0, arch0, dev)
    del state0

    def unit(i):
        step(st, tuple(place(b) for b in pool[i % len(pool)]))
        sync(dev)
    return unit


def _serve_unit(dev):
    """unit(i): one volume of the serve cell's largest size, made and
    normalised as its loop does, then the request."""
    cfg, traffic, program, ref = _cell("serve-promise12-volume")
    loop = cells.load_loop("serve_closed")
    predict = program.build_predict(cfg, draw_state(ref.build(cfg), SEED, dev), dev)
    hw, c = cfg["image_size"], cfg["in_channels"]
    pool = np.random.default_rng(SEED).standard_normal((traffic["pool_slices"], hw, hw, c),
                                                       dtype=np.float32)
    n = traffic["slices"][1]

    def unit(i):
        predict(loop.volume(pool, n, i))
    return unit


def test_spans_add_no_device_event_to_the_benchmarks_profile(card, monkeypatch):
    """Steps in turns with the recorder off and on. Two steps' counts
    differ by a few events with the recorder off too (the profiler drops
    some), so the counts are held to each other's medians within 0.5%, the
    limit the benchmark's launch counts keep."""
    unit = _search_unit(card)
    for i in range(2):
        unit(i)
    got = {False: [], True: []}
    for i in range(6):
        on = bool(i % 2)
        monkeypatch.setattr(torch.autograd, "_profiler_enabled",
                            PROFILER_ENABLED if on else lambda: False)
        spans.clear()
        prof = Profiler()
        prof.start()
        unit(2 + i)
        prof.stop(1)
        trace = prof.analyse()
        assert len(spans.take().spans) == (13 if on else 0)
        got[on].append(trace)
    counts = {on: [collections.Counter(n for n, _, _ in t.events) for t in got[on]]
              for on in got}
    for on in (False, True):
        for t, c in zip(got[on], counts[on]):
            print(f"spans {'on' if on else 'off'}: {len(t.events)} device events, "
                  f"wall {t.wall_us / 1e3:.3f} ms, busy {t.busy_us / 1e3:.3f} ms; "
                  f"against the first off step: +{dict(c - counts[False][0])} "
                  f"-{dict(counts[False][0] - c)}")
            assert not set(c) & set(NAMES)
    assert set().union(*counts[True]) == set().union(*counts[False])
    n_off = float(np.median([len(t.events) for t in got[False]]))
    n_on = float(np.median([len(t.events) for t in got[True]]))
    assert abs(n_on - n_off) <= 0.005 * n_off, (n_on, n_off)

    # a span's own cost, under the benchmark's profiler and with none
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", PROFILER_ENABLED)
    n = 2000
    prof = Profiler()
    prof.start()
    t0 = time.perf_counter()
    for _ in range(n):
        with spans.span("h2d"):
            pass
    on_us = (time.perf_counter() - t0) / n * 1e6
    prof.stop(1)
    spans.clear()
    t0 = time.perf_counter()
    for _ in range(50 * n):
        with spans.span("h2d"):
            pass
    off_us = (time.perf_counter() - t0) / (50 * n) * 1e6
    step_us = float(np.median([t.wall_us for t in got[False]]))
    print(f"a span: {on_us:.3f} us with the profiler on, {off_us:.4f} us off; 13 a step "
          f"are {100 * 13 * on_us / step_us:.4f}% of a step's {step_us / 1e3:.1f} ms")
    assert 13 * on_us < 1e-3 * step_us


def _kineto(prof):
    """(the device events but the spans' own, the spans' host events, the
    device's annotations of the `h2d` spans), each (name, start us, end us)
    on the profiler's clock, by start."""
    device, host, h2d = [], [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            (h2d if e.name == "h2d" else device if e.name not in NAMES else []).append(item)
        elif e.device_type == DeviceType.CPU and e.name in NAMES:
            host.append(item)
    return tuple(sorted(x, key=lambda x: x[1]) for x in (device, host, h2d))


def _profile_units(unit, first, units, phases, label):
    """One CPU+CUDA profile of `units` units from unit(first); prints and
    returns what it measured."""
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the profiler records the card's first ~10 ms late: let it start
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        for i in range(units):
            unit(first + i)
        wall_us = (time.perf_counter() - t0) * 1e6
    record = spans.take().spans
    device, host, annotations = _kineto(prof)
    assert [n for n, _, _ in host] == [s.name for s in sorted(record, key=lambda s: s.start_ns)]
    order = sorted(range(len(record)), key=lambda i: record[i].start_ns)
    kin = [None] * len(record)
    for i, h in zip(order, host):
        kin[i] = h
    offset = charge.offset_us(record, device)
    starts = [s.start_ns / 1e3 + offset for s in record]
    ends = [s.end_ns / 1e3 + offset for s in record]

    # the causal bounds of a shift of the spans against the device's events,
    # from each h2d span and its copy; a profile may miss its first events,
    # so the spans and copies pair from the last
    host_h2d = sorted((s, e) for n, s, e in host if n == "h2d")
    pairs = list(zip(host_h2d[::-1], [(s, e) for _, s, e in annotations[::-1]]))
    lo = max(c_end - h_end for (_, h_end), (_, c_end) in pairs) / 1e3
    hi = min(c_start - h_start for (h_start, _), (c_start, _) in pairs) / 1e3
    shifts = [(a - k[1]) / 1e3 for a, k in zip(starts, kin)]
    ours = float(np.median(shifts))
    causal = lo - START_MS <= 0.0 <= hi + START_MS
    errors = [abs(x) for x in shifts]
    early = sum(1 for _, s, _ in device if s < min(starts))

    parents = [s.parent for s in record]
    names = [s.name for s in record]
    mine = charge.Charged(names, parents, starts, ends,
                          *charge.charge(starts, ends, parents, device), units)
    k_starts, k_ends = [k[1] for k in kin], [k[2] for k in kin]
    theirs = charge.Charged(names, parents, k_starts, k_ends,
                            *charge.charge(k_starts, k_ends, parents, device), units)
    diffs = {}
    for phase, group in phases.items():
        a, b = mine.idle_under_us(group), theirs.idle_under_us(group)
        diffs[phase] = (a / 1e3 / units, b / 1e3 / units, 100 * abs(a - b) / wall_us)
    diffs["outside"] = (mine.outside_us / 1e3 / units, theirs.outside_us / 1e3 / units,
                        100 * abs(mine.outside_us - theirs.outside_us) / wall_us)
    print(f"{label}: {units} units, wall {wall_us / 1e3 / units:.3f} ms a unit, gap idle "
          f"{mine.gap_us / 1e3 / units:.3f} ms, charged "
          f"{(sum(mine.idle_us) + mine.outside_us) / 1e3 / units:.3f} ms; {len(pairs)} of "
          f"{len(host_h2d)} h2d spans with their copy; causal shifts of the spans "
          f"[{lo:.4f}, {hi:.4f}] ms against the profiler's own alignment (0: "
          f"{'causal' if causal else 'not causal'}), the anchor's {ours:.4f} ms, with "
          f"{early} device events before the first span; start "
          f"error against the profiler's times max {max(errors):.4f} ms, median "
          f"{float(np.median(errors)):.4f} ms")
    for phase, (a, b, d) in diffs.items():
        print(f"  {phase}: idle {a:.3f} ms a unit anchored, {b:.3f} ms by the profiler's "
              f"times, {d:.3f} points of the wall")
    assert abs(sum(mine.idle_us) + mine.outside_us - mine.gap_us) <= 1e-6 * mine.gap_us
    assert lo - START_MS <= ours <= hi + START_MS, (lo, hi, ours)
    return causal, max(errors), max(d for _, _, d in diffs.values())


def _anchor_against_kineto(unit, phases, label, units):
    """The worst start error against the profiler's own times (ms) and the
    worst phase's charge difference (points of the wall) in the first of
    up to three profiles whose own times are causal."""
    for i in range(2):
        unit(i)
    for attempt in range(3):
        causal, err, points = _profile_units(unit, 2 + attempt * units, units, phases,
                                             f"{label}, profile {attempt + 1}")
        if causal:
            return err, points
    pytest.fail("the profiler's own times were not causal in any of three profiles")


def test_anchor_matches_the_profilers_times_in_search_steps(card):
    err, points = _anchor_against_kineto(_search_unit(card), SEARCH_PHASES, "search", 2)
    assert err < START_MS and points < SHARE_POINTS


def test_anchor_matches_the_profilers_times_in_requests(card):
    err, points = _anchor_against_kineto(_serve_unit(card), SERVE_PHASES, "serve", 3)
    assert err < START_MS and points < SHARE_POINTS
