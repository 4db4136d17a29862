"""The benchmark's charge of device idle to the program's host spans
(perfbench/lib/spans.py) on synthetic device events and spans: the offset
from the first `h2d` copy, a gap split across two spans, a gap with no
span open counted "outside", the charges adding up to the gap idle
exactly, a span's self time, the eight metric readers on a search and a
serve run, and None without a trace, without spans, without a recorder
in the program, or with spans that do not number the trace's units
whole."""

import sys
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from perfbench.lib import cells
from perfbench.lib import spans as charge
from perfbench.lib.profiling import Trace
from senas_torch.utils.spans import Record, Span

US = 1000  # ns

# a step: host times in us before the anchor; the copy ends at 12 us on
# the device clock, the h2d span at 3 us on the host's, so the offset is 9
STEP_SPANS = [Span("place", -1, 0, 1 * US, 3 * US), Span("h2d", 0, 0, 1 * US, 3 * US),
              Span("search_step", -1, 0, 5 * US, 40 * US),
              Span("arch_forward", 2, 0, 5 * US, 20 * US),
              Span("arch_backward", 2, 0, 20 * US, 36 * US)]
STEP_EVENTS = [("Memcpy HtoD (Pageable -> Device)", 10.0, 12.0), ("kernel_a", 20.0, 25.0),
               ("kernel_b", 40.0, 45.0), ("kernel_c", 42.0, 44.0), ("kernel_d", 60.0, 61.0)]


def _run(events, record, units=1):
    trace = Trace(list(events), 100.0, units) if events is not None else None
    return SimpleNamespace(trace_data=trace, _program_spans=record)


def test_gaps_are_the_traces_idle_gaps():
    got = charge.gaps(STEP_EVENTS)
    assert got == [(12.0, 20.0), (25.0, 40.0), (45.0, 60.0)]
    trace = Trace(STEP_EVENTS, 100.0, 1)
    assert sum(e - s for s, e in got) == pytest.approx(sum(v for _, v in trace.idle_gaps()) * 1e6)


def test_offset_puts_the_first_copy_at_the_first_h2d_span():
    assert charge.offset_us(STEP_SPANS, STEP_EVENTS) == 9.0
    # a second unit: its h2d span holds its copy at the same offset; the
    # events in any order, and small copies outside the spans
    later = STEP_SPANS + [Span("h2d", -1, 1, 50 * US, 52 * US)]
    events = ([("Memcpy HtoD (Pageable -> Device)", 59.5, 61.0),
               ("Memcpy HtoD (Pageable -> Device)", 30.0, 30.1)] + STEP_EVENTS[::-1])
    assert charge.offset_us(later, events) == 9.0
    # the profiler missed the first copy: the second unit's holds the offset
    assert charge.offset_us(later, events[:2] + STEP_EVENTS[1:]) == 9.0
    assert charge.offset_us(STEP_SPANS[2:], STEP_EVENTS) is None
    assert charge.offset_us(STEP_SPANS, STEP_EVENTS[1:]) is None


def test_offset_prefers_copies_ending_nearest_their_spans_ends():
    # two h2d spans 10 us apart, copies ending 0.5 us inside each, and two
    # small copies 10 us later that an offset of +10.5 would also fit
    spans = [Span("h2d", -1, 0, 0, 2 * US), Span("h2d", -1, 1, 10 * US, 12 * US)]
    events = [("HtoD", 1.0, 1.5), ("HtoD", 11.0, 11.5), ("HtoD", 21.9, 22.0)]
    assert charge.offset_us(spans, events) == -0.5


def test_gaps_split_across_spans_and_outside_add_up_exactly():
    c = charge.charged(_run(STEP_EVENTS, Record(STEP_SPANS, 0)))
    assert c.start_us[:3] == [10.0, 10.0, 14.0] and c.end_us[2] == 49.0
    by = c.by_name_us()
    # gap 12-20: 12-14 outside (place ended at 12), 14-20 arch_forward;
    # gap 25-40: 25-29 arch_forward, 29-40 arch_backward;
    # gap 45-60: 45-49 the step's own, 49-60 outside
    assert by == {"place": 0.0, "h2d": 0.0, "search_step": 4.0, "arch_forward": 10.0,
                  "arch_backward": 11.0, charge.OUTSIDE: 13.0}
    assert c.gap_us == 38.0
    assert sum(c.idle_us) + c.outside_us == c.gap_us
    assert c.idle_under_us(("search_step",)) == 25.0
    assert c.idle_under_us(("arch_forward", "arch_backward")) == 21.0


def test_innermost_span_takes_the_gap():
    # a gap wholly inside a child, and one inside the parent around it
    starts, ends, parents = [0.0, 2.0, 8.0], [10.0, 6.0, 9.0], [-1, 0, 0]
    events = [("k", -5.0, 3.0), ("k", 4.0, 7.0), ("k", 12.0, 13.0)]
    idle, outside, total = charge.charge(starts, ends, parents, events)
    # gap 3-4: the first child; gap 7-12: 7-8 the root, 8-9 the second
    # child, 9-10 the root, 10-12 outside
    assert idle == [2.0, 1.0, 1.0] and outside == 2.0 and total == 6.0


def _search_run():
    spans, t = [], 0
    for u in range(2):
        spans += [Span("place", -1, u, t + 0, t + 4 * US), Span("h2d", len(spans), u, t, t + 4 * US)]
        root = len(spans)
        spans.append(Span("search_step", -1, u, t + 5 * US, t + 65 * US))
        for k, name in enumerate(("arch_forward", "arch_backward", "arch_update",
                                  "weight_forward", "weight_backward", "weight_update")):
            spans.append(Span(name, root, u, t + (5 + 10 * k) * US, t + (15 + 10 * k) * US))
        t += 100 * US
    # the device: the copy 2-4 us of each step (offset 0), then busy but for
    # the first 3 us of each phase; a gap before each copy after the first
    events = []
    for u in range(2):
        base = 100.0 * u
        events.append(("Memcpy HtoD (Pageable -> Device)", base + 2, base + 4))
        for k in range(6):
            events.append(("kernel", base + 8 + 10 * k, base + 15 + 10 * k))
    return _run(events, Record(spans, 0), units=2)


def _serve_run():
    spans, t = [], 0
    for u in range(2):
        root = len(spans)
        spans += [Span("serve_request", -1, u, t + 0, t + 30 * US),
                  Span("stage_in", root, u, t + 0, t + 6 * US),
                  Span("h2d", root + 1, u, t + 4 * US, t + 6 * US),
                  Span("program", root, u, t + 6 * US, t + 20 * US),
                  Span("readback", root, u, t + 20 * US, t + 30 * US)]
        t += 50 * US
    events = []
    for u in range(2):
        base = 50.0 * u
        events += [("Memcpy HtoD (Pageable -> Device)", base + 5, base + 6),
                   ("kernel", base + 8, base + 20), ("kernel", base + 22, base + 25),
                   ("Memcpy DtoH (Device -> Pageable)", base + 25, base + 29)]
    return _run(events, Record(spans, 0), units=2)


READ = {m["name"]: m for m in cells.load_benchmark()["per_layer"]}


def _read(name, run):
    return cells.load_reader(name)(run)


def test_offset_when_the_first_units_copy_is_missing():
    # a shift by one unit would hold the second unit's copy in the first
    # unit's span as well; the first unit's kernels then start before any
    # span, which no launch can do
    run = _search_run()
    events = run.trace_data.events[1:]
    assert charge.offset_us(run._program_spans.spans, events) == 0.0


def test_offset_ignores_a_stray_event_before_the_window():
    # a kernel from before the window, recorded with it: an offset that put
    # no event before the first span would move the spans off their copies
    run = _search_run()
    events = [("kernel", -1500.0, -1499.0)] + run.trace_data.events
    assert charge.offset_us(run._program_spans.spans, events) == 0.0
    assert charge.offset_us(run._program_spans.spans, events[:1] + events[2:]) == 0.0


def test_search_readers():
    run = _search_run()
    # the offset is 0; each phase's first 3 us are idle; before each step's
    # first phase, 1 us outside (place closed, the step not yet open); after
    # the first step's last kernel (65), 65-100 outside and 100-102 in place's
    # h2d, before the second step's copy
    assert _read("place_idle_ms.search", run) == pytest.approx(2.0 / 1e3 / 2)
    for name in ("forward_idle_ms.search", "backward_idle_ms.search", "update_idle_ms.search"):
        assert _read(name, run) == pytest.approx(2 * 2 * 3.0 / 1e3 / 2)
    c = charge.charged(run)
    assert c.by_name_us()[charge.OUTSIDE] == 37.0
    assert sum(c.idle_us) + c.outside_us == c.gap_us == 75.0
    for name in ("place_idle_ms.search", "forward_idle_ms.search",
                 "backward_idle_ms.search", "update_idle_ms.search"):
        assert READ[name]["workloads"] == ["search-promise12-b32"]
        assert READ[name]["source"] == "device_trace"


def test_serve_readers():
    run = _serve_run()
    assert charge.offset_us(run._program_spans.spans, run.trace_data.events) == 0.0
    # a request's gaps: 6-8 program, 20-22 readback; between the requests
    # 29-30 readback, 30-50 outside, 50-54 stage_in and 54-55 its h2d
    assert _read("stage_in_idle_ms.serve", run) == pytest.approx(5.0 / 1e3 / 2)
    assert _read("program_idle_ms.serve", run) == pytest.approx(2 * 2.0 / 1e3 / 2)
    assert _read("readback_idle_ms.serve", run) == pytest.approx((2 * 2.0 + 1.0) / 1e3 / 2)
    assert _read("request_idle_share.serve", run) == pytest.approx(
        100 * (5.0 + 4.0 + 5.0) / 60.0)
    c = charge.charged(run)
    assert c.by_name_us()[charge.OUTSIDE] == 20.0
    assert sum(c.idle_us) + c.outside_us == c.gap_us == 34.0
    for name in NEW[4:]:
        assert READ[name]["workloads"] == ["serve-promise12-volume"]
        assert READ[name]["source"] == "device_trace"


NEW = ("place_idle_ms.search", "forward_idle_ms.search", "backward_idle_ms.search",
       "update_idle_ms.search", "stage_in_idle_ms.serve", "program_idle_ms.serve",
       "readback_idle_ms.serve", "request_idle_share.serve")


@pytest.mark.parametrize("name", NEW)
def test_readers_read_none_without_a_trace_or_spans(name, monkeypatch):
    serve = name.endswith(".serve")
    full = _serve_run() if serve else _search_run()
    assert _read(name, full) is not None
    assert _read(name, _run(None, full._program_spans)) is None
    assert _read(name, _run(full.trace_data.events, None)) is None
    # the other cell's spans: nothing of this metric's to read
    assert _read(name, _search_run() if serve else _serve_run()) is None
    # a program without the recorder (an older checkout) records nothing
    monkeypatch.setitem(sys.modules, "senas_torch.utils.spans", None)
    older = SimpleNamespace(trace_data=full.trace_data)
    assert _read(name, older) is None and older._program_spans is None


def test_record_is_taken_once_a_run():
    from senas_torch.utils import spans as program_spans
    program_spans.clear()
    run = SimpleNamespace(trace_data=Trace(STEP_EVENTS, 100.0, 1))
    with profile(activities=[ProfilerActivity.CPU]):
        with program_spans.span("h2d"):
            pass
        got = charge.record(run)
        with program_spans.span("h2d"):
            pass
    assert [s.name for s in got.spans] == ["h2d"]
    assert charge.record(run) is got
    assert len(program_spans.take().spans) == 1
    # a run without a device trace leaves the record where it is
    with profile(activities=[ProfilerActivity.CPU]):
        with program_spans.span("h2d"):
            pass
    assert charge.record(SimpleNamespace(trace_data=None)) is None
    assert len(program_spans.take().spans) == 1


def test_self_time_is_a_span_less_the_spans_directly_inside_it():
    got = charge.self_ns(STEP_SPANS + [Span("weight_forward", 2, 0, 36 * US, None)])
    # place less its h2d; the step less its two phases (the open one
    # counts nothing); the open span has none
    assert got == [0, 2 * US, (35 - 15 - 16) * US, 15 * US, 16 * US, None]


def _drop_second_step(run):
    rec = run._program_spans
    return Record([s for s in rec.spans if not (s.name == "search_step" and s.unit == 1)],
                  rec.dropped)


# ways a record fails to number the trace's units whole
LOSSES = {
    "dropped past the cap": lambda run: run._program_spans._replace(dropped=1),
    "a unit span lost": _drop_second_step,
    "a unit span left open": lambda run: Record(
        [s._replace(end_ns=None) if s.name == "search_step" and s.unit == 1 else s
         for s in run._program_spans.spans], 0),
    "more units than the trace's": lambda run: Record(
        run._program_spans.spans + [Span("search_step", -1, 2, 300 * US, 310 * US)], 0),
}


@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_spans_not_numbering_the_traces_units_read_none(loss):
    run = _search_run()
    assert charge.whole_units(run._program_spans) == 2
    assert charge.charged(_search_run()) is not None
    broken = _run(run.trace_data.events, LOSSES[loss](run), units=2)
    assert charge.whole_units(broken._program_spans) in (None, 1, 3)
    assert charge.charged(broken) is None
    for name in NEW[:4]:
        assert _read(name, broken) is None
