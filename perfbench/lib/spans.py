"""The program's host spans on the device trace's clock, and the device's
idle time charged to the host phase that caused it.

The port records spans of its phases while a profiler runs
(`senas_torch/utils/spans.py`): in a traced run, those of the profiled
units. `record(run)` takes that record once a run and caches it on the
run; a program that records no spans (a checkout older than the
recorder) gives None, and so does a run without a device trace.

**Anchor.** One offset puts the spans (host `perf_counter_ns`) on the clock
of `run.trace_data` (the profiler's, in us). Each `h2d` span launches one
copy to the device, and the call returns once the copy is done, so the
copy ends just inside its span. Not at its start: a copy from pageable
host memory is staged on the host before the device sees it, so the
device's copy starts up to milliseconds after its span does. The offset
puts the ends of the most copy time inside `h2d` spans, then the fewest
device events before the first span, then the copies' ends nearest their
spans' ends: where the profiler recorded every copy, the window's first
copy, launched in the first `h2d` span (the loops synchronise after every
unit), ends at that span's end. The profiler may miss events at the
window's start, the first copies among them; the later units' copies
then hold the offset. It may also record a stray event from before the
window, which does not move the offset.

**Units.** The record's unit spans (`UNITS`) are numbered 0, 1, ... by
the program. Spans are charged only where they number the trace's
profiled units whole: none dropped past the recorder's cap, none lost or
left open. Otherwise the readers give None.

**Charge.** Each instant of a gap between device events (the gaps
`Trace.idle_gaps` sums) is charged to the innermost span the host was in
at that instant, or to `OUTSIDE` where none was open. The charges add up
to the gap idle.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
from typing import Dict, List, Optional, Sequence, Tuple

OUTSIDE = "outside"
# the spans of one step or one request
UNITS = ("search_step", "train_step", "serve_request")
# the rounding of an offset's sum, far below the trace's resolution
EPS_US = 1e-3


def whole_units(rec) -> Optional[int]:
    """The number of units the record holds whole: its unit spans, all
    closed and numbered 0, 1, ... in order, with nothing dropped; None
    otherwise."""
    units = [s for s in rec.spans if s.name in UNITS]
    if rec.dropped or any(s.end_ns is None for s in units):
        return None
    if [s.unit for s in units] != list(range(len(units))):
        return None
    return len(units)


def self_ns(spans) -> List[Optional[int]]:
    """Each span's self time: its length less the lengths of the spans
    directly inside it (None for one still open)."""
    inner = [0] * len(spans)
    for s in spans:
        if s.parent >= 0 and s.end_ns is not None:
            inner[s.parent] += s.end_ns - s.start_ns
    return [None if s.end_ns is None else s.end_ns - s.start_ns - inner[i]
            for i, s in enumerate(spans)]


def gaps(events: Sequence[Tuple[str, float, float]]) -> List[Tuple[float, float]]:
    """(start, end) of each idle gap between device events (name, start,
    end): the stretches between the union's pieces."""
    spans = sorted((s, e) for _, s, e in events)
    out = []
    end = spans[0][1] if spans else 0.0
    for s, e in spans[1:]:
        if s > end:
            out.append((end, s))
        end = max(end, e)
    return out


def innermost(starts: Sequence[float], ends: Sequence[float],
              depth: Sequence[int]) -> Tuple[List[float], List[int]]:
    """The host's timeline cut where a span opens or closes: (bounds,
    owners), owners[k] the innermost span open on [bounds[k], bounds[k+1])
    (the deepest, then the latest opened), -1 where none is."""
    marks = sorted([(e, 0, i) for i, (s, e) in enumerate(zip(starts, ends)) if e > s]
                   + [(s, 1, i) for i, (s, e) in enumerate(zip(starts, ends)) if e > s])
    bounds: List[float] = []
    owners: List[int] = []
    active = set()
    for t, opens, i in marks:
        (active.add if opens else active.discard)(i)
        owner = max(active, key=lambda j: (depth[j], starts[j], j)) if active else -1
        if bounds and bounds[-1] == t:
            owners[-1] = owner
        else:
            bounds.append(t)
            owners.append(owner)
    return bounds, owners


def charge(starts: Sequence[float], ends: Sequence[float], parents: Sequence[int],
           events: Sequence[Tuple[str, float, float]]) -> Tuple[List[float], float, float]:
    """(idle charged to each span, idle charged to none, the gap idle), for
    spans on the events' clock whose parents precede them."""
    depth: List[int] = []
    for p in parents:
        depth.append(0 if p < 0 else depth[p] + 1)
    bounds, owners = innermost(starts, ends, depth)
    idle = [0.0] * len(starts)
    outside = total = 0.0
    for g0, g1 in gaps(events):
        total += g1 - g0
        k = bisect.bisect_right(bounds, g0) - 1
        t = g0
        while t < g1:
            seg_end = min(bounds[k + 1], g1) if k + 1 < len(bounds) else g1
            owner = owners[k] if k >= 0 else -1
            if owner >= 0:
                idle[owner] += seg_end - t
            else:
                outside += seg_end - t
            t = seg_end
            k += 1
    return idle, outside, total


def offset_us(spans, events: Sequence[Tuple[str, float, float]]) -> Optional[float]:
    """The offset (us) from the host's clock to the trace's. Of the offsets
    that put a host-to-device copy's end at an `h2d` span's end: those
    under which the `h2d` spans hold the ends of the most copy time (each
    the latest copy ending inside it), then those under which the fewest
    device events start before the first span opens (the loops launch
    every event of the window inside their spans: a shift by a whole unit
    holds the same copies, but puts the first unit's events before any
    span), then the one under which those copies end nearest their spans'
    ends. None without an `h2d` span or a copy."""
    h2d = sorted((s.start_ns / 1e3, s.end_ns / 1e3) for s in spans
                 if s.name == "h2d" and s.end_ns is not None)
    copies = sorted((e, e - s) for name, s, e in events if "HtoD" in name)
    ends = [e for e, _ in copies]
    if not h2d or not copies:
        return None
    first_span = min(s.start_ns for s in spans) / 1e3
    event_starts = sorted(s for _, s, _ in events)

    def fit(off):
        held, slack = 0.0, 0.0
        for s, e in h2d:
            k = bisect.bisect_right(ends, e + off + EPS_US) - 1
            if k >= 0 and ends[k] >= s + off:
                held += copies[k][1]
                slack += max(e + off - ends[k], 0.0)
        before = bisect.bisect_left(event_starts, first_span + off - EPS_US)
        return held, -before, -slack

    return max((c - e for _, e in h2d for c in ends), key=fit)


@dataclasses.dataclass
class Charged:
    """The record's spans on the trace's clock (us) and the idle charged
    to each, over `units` profiled units."""

    names: List[str]
    parents: List[int]
    start_us: List[float]
    end_us: List[float]
    idle_us: List[float]
    outside_us: float
    gap_us: float
    units: int

    def inside(self, names: Sequence[str]) -> List[bool]:
        """Whether each span is one of `names` or lies inside one."""
        out: List[bool] = []
        for n, p in zip(self.names, self.parents):
            out.append(n in names or (p >= 0 and out[p]))
        return out

    def idle_under_us(self, names: Sequence[str]) -> float:
        return sum(i for i, yes in zip(self.idle_us, self.inside(names)) if yes)

    def by_name_us(self) -> Dict[str, float]:
        """Idle charged to each span name, and to `OUTSIDE`."""
        out: Dict[str, float] = {}
        for n, i in zip(self.names, self.idle_us):
            out[n] = out.get(n, 0.0) + i
        out[OUTSIDE] = self.outside_us
        return out


_UNSET = object()


def record(run):
    """The program's span record (`senas_torch.utils.spans.take()`), taken
    once a run and kept on it; None where the program has no recorder or
    the run no trace."""
    got = getattr(run, "_program_spans", _UNSET)
    if got is _UNSET:
        got = None
        if run.trace_data is not None:
            try:
                program_spans = importlib.import_module("senas_torch.utils.spans")
            except ImportError:
                program_spans = None
            if program_spans is not None:
                got = program_spans.take()
        run._program_spans = got
    return got


def charged(run) -> Optional[Charged]:
    """The run's spans anchored on its device trace with their idle (kept
    on the run); None without a trace, an anchor, or spans of the trace's
    units whole."""
    got = getattr(run, "_charged_spans", _UNSET)
    if got is _UNSET:
        got = run._charged_spans = _charge_run(run)
    return got


def _charge_run(run) -> Optional[Charged]:
    rec = record(run)
    trace = run.trace_data
    if rec is None or trace is None or whole_units(rec) != trace.units:
        return None
    spans = rec.spans
    offset = offset_us(spans, trace.events)
    if offset is None:
        return None
    starts = [s.start_ns / 1e3 + offset for s in spans]
    ends = [(s.start_ns if s.end_ns is None else s.end_ns) / 1e3 + offset for s in spans]
    parents = [s.parent for s in spans]
    idle, outside, total = charge(starts, ends, parents, trace.events)
    return Charged([s.name for s in spans], parents, starts, ends, idle, outside, total,
                   trace.units)


def idle_ms_per_unit(run, names: Sequence[str]) -> Optional[float]:
    """Device idle under the spans `names` (and the spans inside them), in
    ms a profiled unit; None where no such span was recorded."""
    c = charged(run)
    if c is None or not any(n in names for n in c.names):
        return None
    return c.idle_under_us(names) / 1e3 / c.units


def idle_share_of(run, name: str) -> Optional[float]:
    """% of the host time in the spans `name` in which the device was idle
    (gaps only)."""
    c = charged(run)
    if c is None:
        return None
    host = sum(e - s for n, s, e in zip(c.names, c.start_us, c.end_us) if n == name)
    return 100 * c.idle_under_us((name,)) / host if host > 0 else None
