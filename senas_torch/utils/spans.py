"""Spans of the program's host phases, recorded while a torch.profiler
session runs.

`span(name)` marks a phase of a step or a request: the batch placer's
`place` and its `h2d` copies, a training step's forward, backward and
update, the Predictor's staging, program and readback. While a profiler
is active in the process (`torch.autograd._profiler_enabled()`: the
runners' `StepTimer` trace, or any `torch.profiler.profile`) a span opens
a `torch.profiler.record_function` of its name, so that a CPU trace shows
the phase on the profiler's clock beside its operators and kernels, and
appends (name, parent, unit, start_ns, end_ns) on `time.perf_counter_ns()`
to an in-memory record. With no profiler active it records nothing and
costs the check. A CUDA-only profile records no host events, and the
spans add none to it. On an H100 machine's host a span took 0.7 us with
no profiler and 14.7 us under a CUDA-only one.

Spans open and close on the thread that runs the step or the request.
`parent` is the index in the record of the span that encloses it (-1:
none). A unit is one step or one request: the spans opened with
`unit=True` (`search_step`, `train_step`, `serve_request`). A span's
`unit` is the number of unit spans closed in the record before it opened,
so the placer's spans before a step carry that step's number, and a
reader can tell from the unit spans' numbers how many units the record
holds whole.

`take()` returns the record and clears it; `StepTimer.close()` clears it.
The record holds at most `CAP` spans; past it, spans are counted in
`dropped` and not kept.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple, Optional

import torch

CAP = 10_000
_OFF = contextlib.nullcontext()

_spans: List[list] = []     # [name, parent, unit, start_ns, end_ns] each
_open: List[int] = []       # the open spans' indices in _spans, innermost last; -1: dropped
_dropped = 0
_units = 0


class Span(NamedTuple):
    name: str
    parent: int                 # index of the enclosing span in the record, -1 for none
    unit: int
    start_ns: int
    end_ns: Optional[int]       # None: still open when the record was taken


class Record(NamedTuple):
    spans: List[Span]
    dropped: int


def span(name: str, unit: bool = False):
    """A context manager that records the phase `name` while a profiler
    runs; `unit` marks a step or a request."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, unit)


def take() -> Record:
    """The record so far, which is then cleared."""
    global _spans, _dropped, _units
    out = Record([Span(*s) for s in _spans], _dropped)
    _spans, _dropped, _units = [], 0, 0
    return out


def clear() -> None:
    take()


class _Span:
    __slots__ = ("_name", "_unit", "_fn", "_entry")

    def __init__(self, name: str, unit: bool):
        self._name, self._unit = name, unit

    def __enter__(self):
        global _dropped
        self._fn = torch.profiler.record_function(self._name)
        self._fn.__enter__()
        if len(_spans) >= CAP:
            _dropped += 1
            self._entry = None
            _open.append(-1)
        else:
            parent = _open[-1] if _open else -1
            self._entry = [self._name, parent, _units, time.perf_counter_ns(), None]
            _open.append(len(_spans))
            _spans.append(self._entry)
        return self

    def __exit__(self, *exc):
        global _units
        end = time.perf_counter_ns()
        _open.pop()
        if self._entry is not None:
            self._entry[4] = end
        if self._unit:
            _units += 1
        self._fn.__exit__(*exc)
        return False
