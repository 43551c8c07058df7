"""The λ-stage cell ``paper.train-lambda`` on the CPU: its traffic against the
schedule, the plain λ reference against the port's λ chunks, the operation
count of a λ step, the four readers of the λ loop on events made by hand,
and every reader of the other cells on one stored trace, read as the readers
read it before ``Trace.host_ms_per_span`` took a list of spans and a
divisor."""

import json
import math
import time
import types
from pathlib import Path

import pytest
import torch

from portbench import counts, faults, harness
from portbench.conftest import tiny_cell
from portbench.harness import Trace, Window, metric_reader
from portbench.reference import lambda_stages

BENCH_DIR = Path(__file__).resolve().parent
CELL = "paper.train-lambda"
US = 1_000  # ns
H100 = "NVIDIA H100 80GB HBM3"


def test_workload_is_the_schedules_lambda_stages_cut_by_20():
    from pinnfc_tpu_torch.config import default_schedule

    spec = json.loads((BENCH_DIR / "workloads" / f"{CELL}.json").read_text())
    train = json.loads((BENCH_DIR / "workloads" / "paper.train.json").read_text())
    p = spec["params"]
    assert (spec["config"], spec["traffic"], spec["chips"]) == ("pinn-paper", "train_stages", 1)
    assert (p["n_normal"], p["n_fault"]) == (train["params"]["n_normal"],
                                             train["params"]["n_fault"])
    assert p["check_steps"] == 3 and p["trace_calls"] == 1
    full = [s for s in default_schedule() if s.name != "dnn"]
    assert [s["name"] for s in p["stages"]] == [s.name for s in full]
    for cut, s in zip(p["stages"], full):
        assert cut["n_iter"] == (s.n_iter - 1) // 20 + 1  # the reference's +1 kept
        assert cut["lr_step"] * 20 == s.lr_step
        assert (cut["lr"], cut["lr_gamma"]) == (s.lr, s.lr_gamma)
        assert cut.get("dnn_para", False) == s.dnn_para
    assert sum(s["n_iter"] for s in p["stages"]) == 1_705
    assert set(spec["limits"]) == {"first_loss_gap", "step_loss_gap", "grad_norm_gap",
                                   "change_norm_gap"}


def test_the_cell_has_the_lambda_faults():
    cell = harness.load_cell(CELL)
    assert faults.faults_of(cell) == ("lambda_unchanged", "half_batch", "dropped_term")
    assert faults.faults_of(harness.load_cell("paper.train")) == ("unchanged_state",
                                                                  "half_batch")


def _stage_setup(seed: int):
    run = harness.Run(tiny_cell(CELL), seed, 0.1, torch.device("cpu"), harness.Tracer(False))
    traffic = harness.traffic_module("train_stages")
    return run, traffic, traffic.setup(run)


# the λ's each stage starts from in the test: off the data's optimum (the
# campaign is drawn at the configuration's λ_V), where no gradient's sign is
# left to rounding
OFF = {"lam_v": (1.1, 1.5, 0.95, 1.0), "lam_t": (1.0,) * 5, "lam_h": (1.0,) * 4,
       "lam_o": (1.0,) * 4}


@pytest.mark.parametrize("j", range(5), ids=["lambda_v", "lambda_v-dnn_para", "thermal",
                                              "hydrogen", "oxygen"])
def test_lambda_reference_steps_as_the_ports_chunks(j, monkeypatch):
    """The reference's first steps of each λ stage against the port's
    ``train_lambda_v_chunk``/``train_residual_chunk`` run one step a chunk
    from the same λ's, at the cell's limits: each step's loss, the first
    gradient's norm as ``adam_step`` gets it, and the change after them."""
    from pinnfc_tpu_torch.training import stages

    run, traffic, state = _stage_setup(31_337)
    spec = run.cell.traffic["stages"][j]
    limits, k = run.cell.limits, run.cell.traffic["check_steps"]
    group = lambda_stages.GROUP_OF[spec["name"]]
    start = [v * f for v, f in zip(run.lambdas()[group], OFF[group])]
    grads = []
    real = stages.adam_step
    monkeypatch.setattr(stages, "adam_step",
                        lambda w, g, *a: (grads.append(g.clone()), real(w, g, *a))[1])
    x, y, sx, sy = (state.data[key] for key in ("x", "y", "sx", "sy"))
    lam = torch.tensor(start, dtype=torch.float32)
    opt, losses, lams = None, [], [lam]
    schedule = dict(lr=spec["lr"], lr_step=spec["lr_step"], lr_gamma=spec["lr_gamma"])
    with torch.no_grad():
        u_pred, _ = state.params["mlp"](x)
    for _ in range(k):
        if group == "lam_v":
            lam, opt, loss = stages.train_lambda_v_chunk(lam, opt, x, y, u_pred, sx, sy, 1,
                                                         dnn_para=spec["dnn_para"], **schedule)
        else:
            lam, opt, loss = stages.train_residual_chunk(lam, opt, x, sx, group, 1, **schedule)
        losses.append(float(loss[0]))
        lams.append(lam)
    rows = traffic._lambda_rows(state, run, run.cell.traffic["stages"], j)
    ref = lambda_stages.steps(spec["name"], spec.get("dnn_para", False), start, run.lambdas(),
                              rows, k, spec["lr"], spec["lr_step"], spec["lr_gamma"])
    gaps = [abs(a - b) / b for a, b in zip(losses, ref.losses)]
    assert gaps[0] <= limits["first_loss_gap"]
    assert max(gaps[1:]) <= limits["step_loss_gap"]
    first = lambda_stages.point(spec["name"], spec.get("dnn_para", False), start,
                                run.lambdas(), rows)
    g_gap = abs(float(grads[0].norm()) - float(first.grad.norm())) / first.grad_scale
    assert g_gap <= limits["grad_norm_gap"]
    moved, ref_moved = (lams[k] - lams[0]).double().norm(), (ref.lams[k] - ref.lams[0]).norm()
    assert float(abs(moved - ref_moved) / ref_moved) <= limits["change_norm_gap"]


def test_lambda_step_gradients_scale_bounds_the_gradient():
    run, traffic, state = _stage_setup(4_242)
    rows = traffic._lambda_rows(state, run, run.cell.traffic["stages"], 0)
    for stage, dnn_para in [("lambda_v", False), ("lambda_v", True), ("thermal", False),
                            ("hydrogen", False), ("oxygen", False)]:
        group = lambda_stages.GROUP_OF[stage]
        pt = lambda_stages.point(stage, dnn_para, run.lambdas()[group], run.lambdas(), rows)
        assert math.isfinite(pt.loss) and pt.loss > 0
        assert 0 < float(pt.grad.norm()) <= pt.grad_scale * (1 + 1e-12)


@pytest.mark.parametrize("stage, dnn_para, flops", [
    ("lambda_v", False, 3 * (8 + 42 + 5)), ("lambda_v", True, 3 * (8 + 42 + 6)),
    ("thermal", False, 3 * (8 + 13)), ("hydrogen", False, 3 * (4 + 15)),
    ("oxygen", False, 3 * (4 + 22))])
def test_lambda_flops_per_row_step_is_the_hand_count(stage, dnn_para, flops):
    assert counts.lambda_flops_per_row_step(stage, dnn_para) == flops
    assert counts.lambda_flops_per_row_step(stage, dnn_para) in (165, 168, 63, 57, 78)


def _lambda_trace():
    """A λ_V stage (0-100 us) and a thermal stage (100-200 us), 4 steps in
    all: device operations at 10-20, 30-35, 50-60 (λ_V), 110-130, 150-151
    (thermal) and 205-210 (after them); the window is 0-250 us."""
    device = [("elementwise_kernel", 10 * US, 20 * US), ("Memcpy HtoD", 30 * US, 35 * US),
              ("reduce_kernel", 50 * US, 60 * US), ("elementwise_kernel", 110 * US, 130 * US),
              ("Memset (Device)", 150 * US, 151 * US), ("elementwise_kernel", 205 * US, 210 * US)]
    host = [("pinnfc.stage.lambda_v", 0, 100 * US), ("pinnfc.stage.thermal", 100 * US, 200 * US),
            ("aten::mul", 9 * US, 11 * US), ("portbench.run_schedule", 0, 240 * US)]
    return Trace((0, 250 * US), device, host, [("portbench.run_schedule", 0, 240 * US)])


def _lambda_run_and_cell():
    cuda = types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"),
                                 peaks=lambda: counts.peaks(H100))
    cell = types.SimpleNamespace(
        traffic={"stages": [{"name": "lambda_v", "n_iter": 2, "dnn_para": False},
                            {"name": "thermal", "n_iter": 2}]},
        config={"layers": [8, 256, 256, 256, 1]})
    return cuda, cell


@pytest.mark.parametrize("name, want", [
    ("idle_pct.lambda", 100 * (1 - 51 / 250)),  # busy 10 + 5 + 10 + 20 + 1 + 5 us
    ("lambda_host_us", ((100 - 25) + (100 - 21)) / 4),  # wall less busy over 4 steps
    ("lambda_launches_per_step", 5 / 4),  # the operation at 205 us is in no λ span
    # (2·165 + 348,800 + 2·63) FLOP a row × 10 rows in 250 us against 989.4 TFLOP/s
    ("mfu_pct.lambda", 100 * 349_256 * 10 / 250e-6 / 989.4e12),
])
def test_lambda_readers_on_a_small_trace(name, want):
    run, cell = _lambda_run_and_cell()
    win = Window({}, 1, 0, counts={"lambda_steps": 4, "calls": 1, "rows": 10})
    assert metric_reader(name).read(_lambda_trace(), win, run, cell) == pytest.approx(want)


@pytest.mark.parametrize("name", ["lambda_host_us", "lambda_launches_per_step",
                                  "mfu_pct.lambda"])
def test_lambda_readers_find_nothing_without_lambda_steps_or_spans(name):
    run, cell = _lambda_run_and_cell()
    tr = _lambda_trace()
    none = Window({}, 1, 0, counts={"lambda_steps": 0, "calls": 0, "rows": 10})
    assert metric_reader(name).read(tr, none, run, cell) is None
    win = Window({}, 1, 0, counts={"lambda_steps": 4, "calls": 1, "rows": 10})
    no_card = types.SimpleNamespace(device=types.SimpleNamespace(type="cpu"), peaks=lambda: None)
    bare = Trace(tr.window, [], tr.host, tr.spans)
    if name == "mfu_pct.lambda":
        assert metric_reader(name).read(tr, win, no_card, cell) is None
    else:
        assert metric_reader(name).read(bare, win, run, cell) is None
        no_spans = Trace(tr.window, tr.device, [h for h in tr.host if "stage" not in h[0]],
                         tr.spans)
        assert metric_reader(name).read(no_spans, win, run, cell) is None


STORED = json.loads((BENCH_DIR / "readers_trace.json").read_text())


@pytest.mark.parametrize("name", sorted(STORED["values"]))
def test_existing_readers_read_the_stored_trace_as_before(name):
    tr = Trace(tuple(STORED["window"]), [tuple(d) for d in STORED["device"]],
               [tuple(h) for h in STORED["host"]], [tuple(s) for s in STORED["spans"]])
    win = Window({}, 1, 0, counts=STORED["counts"])
    cuda = types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"))
    assert metric_reader(name).read(tr, win, cuda, None) == STORED["values"][name]


def test_traced_lambda_run_counts_its_steps():
    res = harness.run_cell(CELL, 2**33 + 7, 0.1, True, time.perf_counter(), device="cpu",
                           cell=tiny_cell(CELL))
    assert res["correct"] is True
    # off the card the λ readers read nothing: no device operation in the trace
    assert res["metrics"] == {}
    assert res["attempted"] >= 5 and res["failed"] == 0
