"""The port's span recorder (senas_torch/utils/spans.py) on the CPU: it
records nothing with no profiler active; under a CPU torch.profiler it
keeps nesting, parent indices and unit ids, `take()` clears it and the
cap counts what it drops; StepTimer's Chrome trace shows the
spans as user annotations and its close() clears the record; and a tiny
search step, train step and Predictor request each record their span
tree in the order the program runs it, a data-parallel request copying
each replica's part after the call before it."""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from senas_torch.models import geno_searched
from senas_torch.models.senas_model import SenasModel
from senas_torch.runner.common import make_batch_placer
from senas_torch.search.supernet import SenasSearch, init_arch_params, normalize_arch
from senas_torch.serve import Predictor, export_predict_fn, save_artifact
from senas_torch.train.loss import build_loss
from senas_torch.train.trainer import (FixedTrainState, SearchTrainState, make_search_step,
                                       make_train_step)
from senas_torch.utils import misc, spans
from senas_torch.utils.misc import StepTimer

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
C, D, META, HW, B = 4, 2, 2, 16, 2


@pytest.fixture(autouse=True)
def empty_record():
    spans.clear()
    yield
    spans.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _tree(record):
    """(name, parent's name or None, unit) of each span, in record order."""
    return [(s.name, record.spans[s.parent].name if s.parent >= 0 else None, s.unit)
            for s in record.spans]


def test_nothing_is_recorded_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    with spans.span("search_step", unit=True):
        with spans.span("arch_forward"):
            pass
    assert spans.take() == spans.Record([], 0)
    # the disabled span is one shared object: no allocation a call
    assert spans.span("a") is spans.span("b")


def test_nesting_parents_units_and_take():
    with _profiled():
        for _ in range(2):
            with spans.span("place"):
                with spans.span("h2d"):
                    pass
            with spans.span("step", unit=True):
                with spans.span("forward"):
                    torch.ones(64).sum()
                with spans.span("backward"):
                    pass
    got = spans.take()
    assert got.dropped == 0
    assert [(s.name, s.parent, s.unit) for s in got.spans] == [
        ("place", -1, 0), ("h2d", 0, 0), ("step", -1, 0), ("forward", 2, 0), ("backward", 2, 0),
        ("place", -1, 1), ("h2d", 5, 1), ("step", -1, 1), ("forward", 7, 1), ("backward", 7, 1)]
    for s in got.spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = got.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # take() cleared the record, the unit count with it
    assert spans.take() == spans.Record([], 0)
    with _profiled():
        with spans.span("place"):
            pass
    assert [(s.name, s.parent, s.unit) for s in spans.take().spans] == [("place", -1, 0)]


def test_cap_counts_the_dropped_and_does_not_grow(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    with _profiled():
        for _ in range(3):
            with spans.span("step", unit=True):
                with spans.span("forward"):
                    pass
    got = spans.take()
    # the dropped steps still count as units: the third step's number is 2
    assert [(s.name, s.parent, s.unit) for s in got.spans] == [
        ("step", -1, 0), ("forward", 0, 0), ("step", -1, 1)]
    assert got.dropped == 3
    assert spans.take() == spans.Record([], 0)


def test_misc_reexports_the_recorder():
    assert misc.span is spans.span and misc.take is spans.take


def test_step_timer_trace_shows_the_spans_and_close_clears_them(tmp_path):
    timer = StepTimer(trace_dir=str(tmp_path), trace_start=1, trace_steps=2)
    for _ in range(4):
        with timer:
            with spans.span("train_step", unit=True):
                with spans.span("forward"):
                    torch.ones(8).sum()
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    annotations = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert annotations.count("train_step") == 2 and annotations.count("forward") == 2
    # the window closed at its last step's exit: the record is empty
    assert spans.take() == spans.Record([], 0)
    with _profiled():
        with spans.span("forward"):
            pass
    StepTimer().close()
    assert spans.take() == spans.Record([], 0)


def _host_batch(rng):
    return {"image": rng.standard_normal((B, HW, HW, 1)).astype(np.float32),
            "label": rng.integers(0, 2, (B, HW, HW)).astype(np.int64)}


def test_search_step_records_its_tree():
    gen = torch.Generator().manual_seed(0)
    model = SenasSearch(1, C, 2, D, META, device=CPU, generator=gen)
    arch = init_arch_params(META, D, generator=gen, device=CPU)
    st = SearchTrainState.create(model, arch, {"name": "sgd", "lr": 0.01},
                                 {"name": "adam", "lr": 1e-3})
    step = make_search_step(lambda a: normalize_arch(a, META, "reference"),
                            build_loss("dice_ce"), grad_clip=5.0)
    place = make_batch_placer(CPU)
    rng = np.random.default_rng(0)
    with _profiled():
        for _ in range(2):
            step(st, place(_host_batch(rng)), place(_host_batch(rng)), True)
    got = spans.take()
    one = [("place", None), ("h2d", "place"), ("h2d", "place"),
           ("place", None), ("h2d", "place"), ("h2d", "place"),
           ("search_step", None),
           ("arch_forward", "search_step"), ("arch_backward", "search_step"),
           ("arch_update", "search_step"),
           ("weight_forward", "search_step"), ("weight_backward", "search_step"),
           ("weight_update", "search_step")]
    assert _tree(got) == [n + (u,) for u in (0, 1) for n in one]
    assert got.dropped == 0


def test_train_step_records_its_tree():
    model = SenasModel(2, 1, c=C, depth=D, genotype=geno_searched.senas, device=CPU,
                       generator=torch.Generator().manual_seed(0))
    st = FixedTrainState.create(model, {"name": "sgd", "lr": 0.01})
    step = make_train_step(build_loss("dice_ce"), grad_clip=5.0)
    place = make_batch_placer(CPU)
    with _profiled():
        step(st, place(_host_batch(np.random.default_rng(0))))
    assert _tree(spans.take()) == [
        ("place", None, 0), ("h2d", "place", 0), ("h2d", "place", 0), ("train_step", None, 0),
        ("forward", "train_step", 0), ("backward", "train_step", 0),
        ("update", "train_step", 0)]


def test_predictor_request_records_its_tree(tmp_path):
    model = SenasModel(2, 1, c=C, depth=D, genotype=geno_searched.senas, device=CPU,
                       generator=torch.Generator().manual_seed(0))
    save_artifact(export_predict_fn(model, (HW, HW, 1), "float32"), {}, str(tmp_path))
    pred = Predictor(str(tmp_path), device="cpu")
    x = np.random.default_rng(0).standard_normal((3, HW, HW, 1)).astype(np.float32)
    with _profiled():
        masks = pred.predict_masks(x)
        logits = pred.logits(x)
    np.testing.assert_array_equal(masks, logits.argmax(-1).numpy())
    assert _tree(spans.take()) == [
        ("serve_request", None, 0), ("stage_in", "serve_request", 0), ("h2d", "stage_in", 0),
        ("program", "serve_request", 0), ("readback", "serve_request", 0),
        ("serve_request", None, 1), ("stage_in", "serve_request", 1), ("h2d", "stage_in", 1),
        ("program", "serve_request", 1)]


def test_data_parallel_request_copies_each_part_after_the_call_before_it(tmp_path):
    model = SenasModel(2, 1, c=C, depth=D, genotype=geno_searched.senas, device=CPU,
                       generator=torch.Generator().manual_seed(0))
    save_artifact(export_predict_fn(model, (HW, HW, 1), "float32"), {}, str(tmp_path))
    pred = Predictor(str(tmp_path), data_parallel=True, devices=["cpu", "cpu"])
    calls = []

    def timed(replica):
        def call(x):
            calls.append(time.perf_counter_ns())
            return replica(x)
        return call

    pred._replicas = [timed(r) for r in pred._replicas]
    x = np.random.default_rng(0).standard_normal((3, HW, HW, 1)).astype(np.float32)
    with _profiled():
        masks = pred.predict_masks(x)
    assert masks.shape == (3, HW, HW)
    got = spans.take()
    assert _tree(got) == [
        ("serve_request", None, 0), ("stage_in", "serve_request", 0), ("h2d", "stage_in", 0),
        ("program", "serve_request", 0), ("h2d", "program", 0),
        ("readback", "serve_request", 0)]
    first, second = (s for s in got.spans if s.name == "h2d")
    assert first.end_ns <= calls[0] <= second.start_ns <= second.end_ns <= calls[1]
