"""The port's spans and one-time counters on the CPU: ``utils.observability.
span`` inside ``pipeline/export.py::build_comprehensive_results`` and
``training/stages.py::run_schedule`` under ``torch.profiler`` (names, nesting,
order; none a user annotation, so none reaches a device timeline), nothing
recorded with no profiler open, and ``ops/build.py::ONCE_S`` (each first call
timed apart from the first calls inside it, reset by ``reset_once``).  The
spans of the training kernel's CUDA path and the shared clock with the
device are tested on the card (tests/test_torch_cuda.py)."""

import contextlib
import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pinnfc_tpu_torch.config import StageConfig
from pinnfc_tpu_torch.data.combine import combine_and_normalize
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.models.pinn import init_pinn
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.ops.residuals import all_residuals_kernel
from pinnfc_tpu_torch.pipeline.export import build_comprehensive_results
from pinnfc_tpu_torch.training.stages import run_schedule
from pinnfc_tpu_torch.utils.observability import span
from pinnfc_tpu_torch.utils.threads import one_thread

EXPORT_PHASES = ["pinnfc.export.mc", "pinnfc.export.residuals", "pinnfc.export.to_host",
                 "pinnfc.export.smooth", "pinnfc.export.assemble"]


@pytest.fixture(scope="module")
def small_campaign():
    normal, faults = synthesize_stack_data(n_normal=100, n_fault=10, seed=42)
    return combine_and_normalize(normal, faults, device="cpu")


def _spans(prof):
    """The profiler's ``pinnfc.`` events as (name, start, end, is a user
    annotation), by start."""
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.is_user_annotation())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("pinnfc.")]
    return sorted(evs, key=lambda e: e[1])


def _tiled_in_order(outer, inner):
    """The ``inner`` spans lie inside ``outer``, one after another."""
    assert all(outer[1] <= s and e <= outer[2] for _, s, e, _ in inner)
    assert all(a[2] <= b[1] for a, b in itertools.pairwise(inner))


def _export(campaign):
    params = init_pinn(generator=torch.Generator().manual_seed(0), device="cpu")
    return build_comprehensive_results(params, campaign, mc_seed=5, mc_times=4,
                                       smooth_window=10)[0].array


def test_export_spans_tile_the_export_in_order(small_campaign):
    with one_thread():
        plain = _export(small_campaign)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = _export(small_campaign)
    assert np.array_equal(plain, traced, equal_nan=True)
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["pinnfc.export", *EXPORT_PHASES]
    assert not any(s[3] for s in spans)  # not user annotations
    _tiled_in_order(spans[0], spans[1:])


def test_schedule_spans_one_per_stage_in_order(small_campaign):
    ds = small_campaign
    params = init_pinn(generator=torch.Generator().manual_seed(0), device="cpu")
    schedule = (StageConfig("dnn", 3, lr=0.01), StageConfig("thermal", 2, lr=1.0))
    with one_thread(), profile(activities=[ProfilerActivity.CPU]) as prof:
        run_schedule(params, ds.x_train, ds.y_train, ds.scaler_x, ds.scaler_y,
                     schedule=schedule, seed=3)
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["pinnfc.stage.dnn", "pinnfc.stage.thermal"]
    assert not any(s[3] for s in spans)
    assert spans[0][2] <= spans[1][1]


def test_span_records_nothing_without_a_profiler():
    assert isinstance(span("x"), contextlib.nullcontext)
    with span("entered.before"):  # the profiler opens inside it
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("inside"):
                pass
    assert [s[0] for s in _spans(prof)] == ["pinnfc.inside"]
    assert isinstance(span("after"), contextlib.nullcontext)


class _Clock:
    """A host clock that advances one second a reading."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 1.0
        return self.now


def test_once_times_a_first_call_less_the_first_calls_inside(monkeypatch):
    monkeypatch.setattr(build, "ONCE_S", {})
    monkeypatch.setattr(build, "time", _Clock())
    calls = []

    def inner(v):
        calls.append(v)
        return v

    def outer():
        return build.once("inner", inner, 7) + 1

    assert build.once("outer", outer) == 8
    # outer's readings 1 and 4, inner's 2 and 3: outer 3 s less inner's 1 s
    assert build.ONCE_S == {"inner": 1.0, "outer": 2.0}
    assert build.once("outer", outer) == 8  # no longer timed
    assert build.ONCE_S == {"inner": 1.0, "outer": 2.0} and calls == [7, 7]
    build.reset_once()
    assert build.ONCE_S == {}
    build.once("inner", inner, 1)
    assert list(build.ONCE_S) == ["inner"]


def test_residual_operator_first_dispatch_is_counted_once(monkeypatch, small_campaign):
    monkeypatch.setattr(build, "ONCE_S", {})
    ds = small_campaign
    params = init_pinn(generator=torch.Generator().manual_seed(0), device="cpu")
    u = torch.zeros(ds.x_test.shape[0], 1)
    with one_thread():
        all_residuals_kernel(params, ds.x_test, u, ds.scaler_x, ds.scaler_y)
        first = dict(build.ONCE_S)
        all_residuals_kernel(params, ds.x_test, u, ds.scaler_x, ds.scaler_y)
    assert list(first) == ["dispatch.residuals_op"] and first["dispatch.residuals_op"] >= 0
    assert build.ONCE_S == first
