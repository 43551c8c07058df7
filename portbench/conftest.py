"""Shared helpers of the benchmark's tests: each cell cut to a size the CPU
runs in seconds (flagship widths kept; fewer rows, MC passes, requests and
steps)."""

import pytest

from portbench import harness

CELLS = ("paper.score", "bf16.train", "paper.train", "paper.train-lambda")


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    cell.config = dict(cell.config, mc_times=8)
    p = dict(cell.workload["params"])
    if cell.workload["traffic"] == "score_campaigns":
        p.update(campaigns=2, n_normal=64, n_fault=16, min_requests=3)
    else:
        p.update(n_normal=96, n_fault=4, stages=[dict(s, n_iter=5) for s in p["stages"]])
    cell.workload = dict(cell.workload, params=p)
    return cell


def run_tiny(name: str, seed: int, trace: bool = False, control: bool = False) -> dict:
    import time

    return harness.run_cell(name, seed, 0.2, trace, time.perf_counter(), device="cpu",
                            control=control, cell=tiny_cell(name))


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
