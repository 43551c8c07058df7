"""Traffic kind ``train_stages``: a training job that runs a list of schedule
stages through ``pinnfc_tpu_torch.training.stages.run_schedule``, the path of
``cli train``, again and again on one campaign's normal rows.

Parameters (the cell's ``params``): ``n_normal`` training rows (the normal
rows of a campaign made from the seed, ``n_fault`` rows per fault segment
made beside them and not used), ``stages`` (name, n_iter, lr, lr_step,
lr_gamma and, for ``lambda_v``, dnn_para, as ``config.StageConfig`` takes
them; the check follows DNN stages), ``check_steps`` and ``trace_calls``.
The precision is the configuration's ``port_precision``.

Set-up warms the window's call up on params of its own, each stage cut to
two steps, and hands the window params holding the weights made from the
seed.  Each call of the window starts from the weights the last one left,
with a seed of its own.  The first call is the one the check compares: a
recorder stands in for the DNN stage that ``run_schedule`` looks up at call
time, keeps the weights each stage starts from and passes every argument
through; the call's log keeps every step's loss.

End-to-end: ``train_steps_per_s`` (steps completed over the seconds they
took, counted in whole calls).  With ``--trace 1`` the profiler covers the
first ``trace_calls`` calls.  Counts for the readers: ``rows``, ``steps`` and
``stages`` of the traced calls.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench.harness import Check, Run, Window
from portbench.reference import campaign as ref_campaign
from portbench.reference import masks, mlp
from portbench.traffic import _campaign

SPAN = "portbench.run_schedule"
MAX_CALLS = 10_000


@dataclasses.dataclass
class State:
    normal: Any
    data: Dict[str, Any]  # the port's x_train, y_train and scalers
    weights: list  # the weights made from the seed, which the first call starts from
    params: dict
    seeds: List[int]  # each call's seed
    losses: List[np.ndarray] = dataclasses.field(default_factory=list)  # per stage of call 0
    starts: List[list] = dataclasses.field(default_factory=list)  # per stage of call 0


def _stages(specs: List[Dict[str, Any]]):
    from pinnfc_tpu_torch.config import StageConfig

    return tuple(StageConfig(**s) for s in specs)


def setup(run: Run) -> State:
    from pinnfc_tpu_torch.data.combine import combine_and_normalize

    p = run.cell.traffic
    normal, _ = _campaign.synthesize_stack_data(int(p["n_normal"]), int(p["n_fault"]),
                                                seed=run.seeds("campaigns", 1)[0])
    ds = combine_and_normalize(normal, [], device=run.device)
    data = {"x": ds.x_train, "y": ds.y_train, "sx": ds.scaler_x, "sy": ds.scaler_y}
    weights = run.make_weights()
    # warm-up: the window's own call, each stage cut to two steps, on params of its own
    short = [dict(s, n_iter=2) for s in p["stages"]]
    _run_schedule(run.port_params(weights), data, run, short, run.seeds("warm-up", 1)[0])
    return State(normal, data, weights, run.port_params(weights), run.seeds("stages", MAX_CALLS))


def _run_schedule(params, data, run: Run, specs, seed: int):
    from pinnfc_tpu_torch.training.stages import run_schedule

    return run_schedule(params, data["x"], data["y"], data["sx"], data["sy"],
                        schedule=_stages(specs), seed=seed,
                        precision=run.cell.config["port_precision"])


@contextlib.contextmanager
def _recording(starts: list):
    """A recorder in place of the DNN stage that ``run_schedule`` looks up at
    call time: it keeps a copy of the weights each stage starts from, (W, b)
    per layer, and passes every argument through."""
    from pinnfc_tpu_torch.training import stages

    real = stages.train_dnn

    def stage(mlp, *args, **kw):
        starts.append([(lin.weight.detach().clone(), lin.bias.detach().clone())
                       for lin in mlp.linears()])
        return real(mlp, *args, **kw)

    stages.train_dnn = stage
    try:
        yield
    finally:
        stages.train_dnn = real


def window(state: State, run: Run) -> Window:
    p = run.cell.traffic
    specs = p["stages"]
    per_call = sum(int(s["n_iter"]) for s in specs)
    trace_calls = int(p.get("trace_calls", MAX_CALLS))
    calls = failed = traced = 0
    run.tracer.open()
    t_start = time.perf_counter()
    t_end = t_start
    while (t_end - t_start < run.seconds or calls < run.min_requests) and calls < MAX_CALLS:
        if calls == trace_calls:
            traced = calls if run.tracer.active else 0
            run.tracer.close()
        record = _recording(state.starts) if calls == 0 else contextlib.nullcontext()
        with run.tracer.span(SPAN), record:
            state.params, log = _run_schedule(state.params, state.data, run, specs,
                                              state.seeds[calls])
        t_end = time.perf_counter()
        if calls == 0:
            state.losses = [np.asarray(losses) for _, losses in log.stages]
        failed += sum(int(not np.all(np.isfinite(losses))) for _, losses in log.stages)
        calls += 1
    if run.tracer.active:
        traced = calls
    run.tracer.close()
    steps = per_call * calls
    return Window({"train_steps_per_s": steps / (t_end - t_start)},
                  attempted=calls * len(specs), failed=failed,
                  counts={"rows": int(state.data["x"].shape[0]), "steps": per_call * traced,
                          "stages": len(specs) * traced})


def _reference_rows(state: State, run: Run):
    """The training rows as the reference works them out from the raw ones."""
    x, y = np.asarray(state.normal[0]), np.asarray(state.normal[1]).reshape(-1, 1)
    sx, sy = ref_campaign.fit_minmax(x), ref_campaign.fit_minmax(y)
    return (torch.as_tensor(ref_campaign.scaled(x, sx), device=run.device),
            torch.as_tensor(ref_campaign.scaled(y, sy), device=run.device))


def _gap(prog: float, ref: float, scale: float) -> float:
    """|prog − ref| over the mean |row term| of the reference's loss; inf
    where either is not finite."""
    gap = abs(float(prog) - ref) / scale
    return gap if math.isfinite(gap) else math.inf


def check(state: State, run: Run) -> List[Check]:
    """The window's first call against the reference, stage by stage, each
    stage from the weights it started from (the seed's for the first, the
    weights the stage before returned for the others) with its own dropout
    seed, each loss's gap over the mean |row term| of the reference's:

    - ``first_loss_gap``: the loss of each stage's step 0 (the forward);
    - ``step_loss_gap``: the losses of steps 1 to ``check_steps`` − 1 (the
      backward and Adam, their state carried inside one launch).

    With ``run.control`` the reference in the precision below the stated one
    runs each stage's first steps in the program's place, from the same
    weights."""
    p = run.cell.traffic
    specs, k = p["stages"], int(p["check_steps"])
    state.params = None  # the program's state, freed before the reference
    if len(state.starts) != len(specs) or len(state.losses) != len(specs):
        return [Check(name, math.inf, float(limit)) for name, limit in run.cell.limits.items()]
    x, y = _reference_rows(state, run)
    dropout = run.cell.config["train_dropout"]
    gaps = {"first_loss_gap": 0.0, "step_loss_gap": 0.0}
    starts = [state.weights] + state.starts[1:]
    for j, (spec, start, prog) in enumerate(zip(specs, starts, state.losses)):
        if spec["name"] != "dnn":
            raise ValueError("the check follows DNN stages only")
        seed = masks.stage_seed(state.seeds[0], j)
        schedule = (spec["lr"], spec["lr_step"], spec["lr_gamma"], dropout)
        ref, scale = mlp.train_steps(start, x, y, seed, k, *schedule,
                                     run.reference_rounding("train_products"))
        if run.control:
            prog = mlp.train_steps(start, x, y, seed, k, *schedule,
                                   run.control_rounding("train_products"))[0]
        step = [_gap(a, b, s) for a, b, s in zip(prog[:k], ref, scale)]
        gaps["first_loss_gap"] = max(gaps["first_loss_gap"], step[0])
        gaps["step_loss_gap"] = max([gaps["step_loss_gap"], *step[1:]])
    return [Check(name, gaps[name], float(limit)) for name, limit in run.cell.limits.items()]
