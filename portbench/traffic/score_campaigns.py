"""Traffic kind ``score_campaigns``: one client scoring whole campaigns back to
back (a closed loop) through ``pinnfc_tpu_torch.pipeline.export.
build_comprehensive_results``, the export of ``cli score`` and ``cli train``.

Parameters (the cell's ``params``): ``campaigns`` distinct campaigns made in
set-up from the seed, each ``n_normal`` normal rows and 12 fault segments of
``n_fault`` rows; the window cycles through them, each request with an MC
seed of its own.  MC passes, dropout rate and smoothing window are the
configuration's.  The window makes at least ``min_requests`` requests;
``check_requests`` of them, drawn from the seed before the window opens, are
kept and compared with the reference once it has closed.

End-to-end: ``score_rows_per_s`` (all rows scored over the window's time) and
``score_p95_ms`` (95th percentile of the requests' latencies).  Counts for
the readers: ``rows`` per campaign, ``passes`` per row, ``requests`` traced.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, List, Optional, Set, Tuple

import numpy as np

from portbench.harness import Check, Run, Window
from portbench.reference import campaign as ref_campaign
from portbench.reference.compare import artifact_gaps
from portbench.traffic import _campaign

SPAN = "portbench.score"
# the parts of a request whose precision the configuration states
PARTS = ("mc_base_products", "mc_sample_products", "post_precision")
MAX_REQUESTS = 100_000


@dataclasses.dataclass
class State:
    raw: List[Tuple[Any, Any]]  # (normal, faults) per campaign, as generated
    datasets: list  # the port's datasets, made in set-up
    weights: list
    params: dict
    mc_seeds: List[int]
    picked: Set[int]  # the requests the check compares
    outputs: List[Tuple[int, int, np.ndarray]] = dataclasses.field(default_factory=list)


def _settings(run: Run):
    cfg = run.cell.config
    return int(cfg["mc_times"]), float(cfg["mc_dropout"]), int(cfg["smooth_window"])


def setup(run: Run) -> State:
    from pinnfc_tpu_torch.data.combine import combine_and_normalize

    p = run.cell.traffic
    raw = [_campaign.synthesize_stack_data(int(p["n_normal"]), int(p["n_fault"]), seed=s)
           for s in run.seeds("campaigns", int(p["campaigns"]))]
    datasets = [combine_and_normalize(normal, faults, device=run.device) for normal, faults in raw]
    weights = run.make_weights()
    among = min(run.min_requests, MAX_REQUESTS)
    pick = np.random.default_rng(run.seeds("check", 1)[0]).choice(
        among, size=min(int(p["check_requests"]), among), replace=False)
    state = State(raw, datasets, weights, run.port_params(weights),
                  run.seeds("mc", MAX_REQUESTS + 1), {int(v) for v in pick})
    _score(state, run, 0, MAX_REQUESTS)  # warm-up: the same shapes as every request
    return state


def _score(state: State, run: Run, c: int, seed_index: int) -> Optional[np.ndarray]:
    """One request: campaign ``c`` scored with MC seed ``mc_seeds[seed_index]``;
    the artifact as the host holds it.  With ``run.control`` the reference in
    the precision below the stated one answers in the program's place the
    requests the check compares (about 7 s a campaign), and no other (None)."""
    mc_times, dropout, window = _settings(run)
    seed = state.mc_seeds[seed_index]
    if run.control:
        if seed_index not in state.picked:
            return None
        return ref_campaign.artifact(state.weights, run.lambdas(), *state.raw[c], seed, mc_times,
                                     dropout, window, run.device,
                                     {k: run.control_rounding(k) for k in PARTS})
    from pinnfc_tpu_torch.pipeline import export

    results, _ = export.build_comprehensive_results(
        state.params, state.datasets[c], seed, mc_times=mc_times, dropout=dropout,
        smooth_window=window)
    return results.array


def window(state: State, run: Run) -> Window:
    mc_times = _settings(run)[0]
    n_campaigns = len(state.raw)
    rows = int(state.datasets[0].x_test.shape[0])
    lat: List[float] = []
    failed = 0
    run.tracer.open()
    t_start = time.perf_counter()
    t_end = t_start
    i = 0
    while (t_end - t_start < run.seconds or i < run.min_requests) and i < MAX_REQUESTS:
        c = i % n_campaigns
        t0 = time.perf_counter()
        with run.tracer.span(SPAN):
            out = _score(state, run, c, i)
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        failed += int(out is not None and not np.all(np.isfinite(out)))
        if i in state.picked:
            state.outputs.append((c, i, out))
        i += 1
    traced = i if run.tracer.active else 0
    run.tracer.close()
    metrics = {"score_rows_per_s": rows * i / (t_end - t_start),
               "score_p95_ms": 1e3 * float(np.percentile(lat, 95))}
    return Window(metrics, attempted=i, failed=failed,
                  counts={"rows": rows, "passes": mc_times, "requests": traced})


def check(state: State, run: Run) -> List[Check]:
    """The artifacts of the picked requests against the reference's; each
    group's widest gap."""
    mc_times, dropout, window = _settings(run)
    state.datasets = state.params = None  # the program's state, freed before the reference
    # a picked request the window never made is never compared: not correct
    worst = {name: 0.0 if len(state.outputs) == len(state.picked) else math.inf
             for name in run.cell.limits}
    rnd = {k: run.reference_rounding(k) for k in PARTS}
    for c, seed_index, out in state.outputs:
        ref = ref_campaign.artifact(state.weights, run.lambdas(), *state.raw[c],
                                    state.mc_seeds[seed_index], mc_times, dropout, window,
                                    run.device, rnd)
        for name, gap in artifact_gaps(out, ref).items():
            worst[name] = max(worst[name], gap)
    return [Check(name, worst[name], float(limit)) for name, limit in run.cell.limits.items()]
