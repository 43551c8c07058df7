"""Each cell end to end on the CPU at a tiny size, through the port's CPU
path: correct against the reference, incorrect for the control (the
reference in the precision below the stated one in the program's place) and
for every fault the cell can have, and the result line's keys."""

import pytest

from portbench import faults
from portbench.conftest import CELLS, run_tiny, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_with_the_contract_keys(name):
    res = run_tiny(name, 2**31 + 12_345)
    assert list(res) == KEYS
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    cell = tiny_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.metrics("end_to_end")}
    for m in cell.metrics("end_to_end"):
        assert res["metrics"][m["name"]]["unit"] == m["unit"]
        assert res["metrics"][m["name"]]["value"] > 0
    assert set(res["checks"]) == set(cell.limits)
    for check in res["checks"].values():
        assert check["value"] <= check["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_has_the_breakdown_and_checks_last(name):
    res = run_tiny(name, 3_000_000_019, trace=True)
    assert list(res) == KEYS[:5] + ["breakdown", "checks"]
    assert res["correct"] is True
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0
    per_layer = {m["name"] for m in tiny_cell(name).metrics("per_layer")}
    assert set(res["metrics"]) <= per_layer
    # off the card no device metric is reported: no reader splits host time
    # from the device's without the card's timeline
    assert res["metrics"] == {}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_judged_incorrect(name):
    res = run_tiny(name, 777_777_777_777, control=True)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("name, fault", [(name, f) for name in CELLS
                                         for f in faults.faults_of(tiny_cell(name))])
def test_planted_fault_is_judged_incorrect(name, fault):
    with faults.FAULTS[fault]():
        res = run_tiny(name, 55_555)
    assert res["correct"] is False


def test_same_seed_same_inputs():
    a = run_tiny("paper.train", 99)
    b = run_tiny("paper.train", 99)
    assert a["checks"] == b["checks"]


def _tiny_run(name: str, seed: int):
    import torch

    from portbench import harness

    cell = tiny_cell(name)
    run = harness.Run(cell, seed, 0.2, torch.device("cpu"), harness.Tracer(False),
                      min_requests=int(cell.traffic.get("min_requests", 1)))
    return run, harness.traffic_module(cell.workload["traffic"])


def test_score_keeps_only_the_requests_it_checks():
    run, traffic = _tiny_run("paper.score", 8_675_309)
    state = traffic.setup(run)
    win = traffic.window(state, run)
    assert win.attempted >= run.min_requests
    assert len(state.picked) == run.cell.traffic["check_requests"]
    assert state.picked <= set(range(run.min_requests))
    assert sorted(i for _, i, _ in state.outputs) == sorted(state.picked)


@pytest.mark.parametrize("name", ["paper.train", "paper.train-lambda"])
def test_train_check_reads_the_window_first_call(name):
    from pinnfc_tpu_torch.training import stages

    names = ("train_dnn", "train_lambda_v_chunk", "train_residual_chunk", "adam_step")
    real = {n: getattr(stages, n) for n in names}
    run, traffic = _tiny_run(name, 8_675_309)
    state = traffic.setup(run)
    assert state.starts == [] and state.losses == [] and state.adam == {}
    traffic.window(state, run)
    # the recorders are gone once the call has ended
    assert all(getattr(stages, n) is real[n] for n in names)
    specs = run.cell.traffic["stages"]
    assert len(state.starts) == len(state.losses) == len(specs)
    assert [len(losses) for losses in state.losses] == [s["n_iter"] for s in specs]
    k = run.cell.traffic["check_steps"]
    lam = [j for j, s in enumerate(specs) if s["name"] != "dnn"]
    assert sorted(state.adam) == lam
    for j in lam:  # the λ's and the gradient of the first k + 1 steps
        assert len(state.adam[j]) == k + 1
        assert state.adam[j][0][0].tolist() == state.starts[j].tolist()
