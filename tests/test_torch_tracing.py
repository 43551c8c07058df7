"""The port's spans and one-time counters on the CPU: ``utils.observability.
span`` inside ``pipeline/export.py::build_comprehensive_results`` and
``training/stages.py::run_schedule`` under ``torch.profiler`` (names, nesting,
order; none a user annotation, so none reaches a device timeline), nothing
recorded with no profiler open, and ``ops/build.py::ONCE_S`` (each first call
timed apart from the first calls inside it, reset by ``reset_once``).  The
spans of the training kernel's CUDA path and the shared clock with the
device are tested on the card (tests/test_torch_cuda.py).

The residual wrapper's two routes: an eager call runs without the registered
operator (so a scoring process never imports ``torch._dynamo``), bitwise the
operator's rows; every kind of trace records the operator once."""

import contextlib
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.profiler import ProfilerActivity, profile

from pinnfc_tpu_torch.config import StageConfig
from pinnfc_tpu_torch.data.combine import combine_and_normalize
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.models.pinn import init_pinn
from pinnfc_tpu_torch.ops import build, residuals
from pinnfc_tpu_torch.ops.residuals import all_residuals_kernel, kernel_scalars, residuals_op
from pinnfc_tpu_torch.pipeline.export import build_comprehensive_results
from pinnfc_tpu_torch.training.stages import run_schedule
from pinnfc_tpu_torch.utils.observability import span
from pinnfc_tpu_torch.utils.threads import one_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _eager_inputs(ds):
    """The campaign's rows, its eval prediction and λ_V at 1.2: rows past the
    limiting current give NaN residuals."""
    params = init_pinn(generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        params["lam_v"][2] = 1.2
        u = params["mlp"](ds.x_test)[0]
    return params, u


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_eager_residuals_skip_the_operator(monkeypatch, small_campaign):
    """An eager CPU call runs ``plain_rows`` without the registered operator:
    nothing enters ``ONCE_S``, and its bundle is ``residuals_op``'s rows
    bitwise, NaNs included."""
    monkeypatch.setattr(build, "ONCE_S", {})
    ds = small_campaign
    params, u = _eager_inputs(ds)
    dispatched = []
    monkeypatch.setattr(residuals, "residuals_op",
                        lambda *a: dispatched.append(a) or residuals_op(*a))
    with one_thread():
        bundle = all_residuals_kernel(params, ds.x_test, u, ds.scaler_x, ds.scaler_y)
        scalars = kernel_scalars(params, ds.scaler_x, ds.scaler_y)
        rows = residuals_op(ds.x_test, u[:, 0],
                            *(scalars[k] for k in build.RESIDUAL_SCALAR_SIZES))
    assert build.ONCE_S == {} and dispatched == []  # no "dispatch.residuals_op"
    assert torch.isnan(rows).any()
    assert torch.equal(_bits(torch.stack([t[:, 0] for t in bundle])), _bits(rows))


def test_eager_scoring_never_imports_dynamo():
    """A fresh interpreter that imports the port, runs the residual wrapper and
    a small CPU export has not loaded ``torch._dynamo``: the registered
    operator's first dispatch would import it."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import pinnfc_tpu_torch\n"
        "from pinnfc_tpu_torch.data.combine import combine_and_normalize\n"
        "from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data\n"
        "from pinnfc_tpu_torch.models.pinn import init_pinn\n"
        "from pinnfc_tpu_torch.ops.residuals import all_residuals_kernel\n"
        "from pinnfc_tpu_torch.pipeline.export import build_comprehensive_results\n"
        "ds = combine_and_normalize(*synthesize_stack_data(n_normal=300, n_fault=20, seed=42),\n"
        "                           device='cpu')\n"
        "params = init_pinn(generator=torch.Generator().manual_seed(0), device='cpu')\n"
        "with torch.no_grad():\n"
        "    u = params['mlp'](ds.x_test)[0]\n"
        "all_residuals_kernel(params, ds.x_test, u, ds.scaler_x, ds.scaler_y)\n"
        "res = build_comprehensive_results(params, ds, mc_seed=5, mc_times=8)[0]\n"
        "dynamo = sorted(m for m in sys.modules if m.startswith('torch._dynamo'))\n"
        "print(res.array.shape[0], dynamo)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows, loaded = proc.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(rows) >= 300 and loaded == "[]"


class _Step(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x, u):
        return self.fn(x, u)


def _targets(gm):
    return [str(n.target) for m in gm.modules() if isinstance(m, torch.fx.GraphModule)
            for n in m.graph.nodes if n.op == "call_function"]


def _made(fn, x, u, **kw):
    gm = make_fx(fn, **kw)(x, u)
    return gm, gm


def _exported(strict):
    def trace(fn, x, u):
        ep = torch.export.export(_Step(fn), (x, u), strict=strict)
        return ep.graph_module, ep.module()
    return trace


def _compiled(fn, x, u):
    graphs = []

    def capture(gm, example_inputs):
        graphs.append(gm)
        return gm.forward

    compiled = torch.compile(fn, backend=capture, fullgraph=True)
    compiled(x, u)
    assert len(graphs) == 1
    return graphs[0], compiled


# each: (fn, x, u) -> (the graph recorded, the traced program)
TRACERS = {
    "make_fx": _made,
    "export": _exported(strict=False),
    "export_strict": _exported(strict=True),
    "compile": _compiled,
    "functionalize": lambda fn, x, u: _made(torch.func.functionalize(fn), x, u),
}


@pytest.mark.parametrize("tracer", list(TRACERS))
def test_traced_residuals_record_the_operator(small_campaign, tracer):
    """Every way of tracing the wrapper (proxy tensors, fake ones in
    non-strict export, functional ones, strict export, torch.compile)
    records the registered operator once, and the traced program gives the
    eager rows bitwise."""
    ds = small_campaign
    params, u = _eager_inputs(ds)

    def fn(x, u):
        return torch.cat(all_residuals_kernel(params, x, u, ds.scaler_x, ds.scaler_y), dim=1)

    with one_thread():
        gm, program = TRACERS[tracer](fn, ds.x_test, u)
        assert _targets(gm).count("pinnfc_torch.residuals.default") == 1
        traced = program(ds.x_test, u)
        eager = fn(ds.x_test, u)
    assert torch.equal(_bits(traced), _bits(eager))


def test_functional_tensors_take_the_operator(monkeypatch, small_campaign):
    """Under ``torch.func.functionalize`` alone (C++ functional wrappers of
    plain tensors, no dispatch mode) the wrapper dispatches the operator."""
    ds = small_campaign
    params, u = _eager_inputs(ds)
    dispatched = []
    monkeypatch.setattr(residuals, "residuals_op",
                        lambda *a: dispatched.append(a) or residuals_op(*a))

    def fn(x, u):
        return torch.cat(all_residuals_kernel(params, x, u, ds.scaler_x, ds.scaler_y), dim=1)

    with one_thread():
        got = torch.func.functionalize(fn)(ds.x_test, u)
        want = fn(ds.x_test, u)
    assert len(dispatched) == 1  # the functional call's, not the eager one's
    assert torch.equal(_bits(got), _bits(want))
