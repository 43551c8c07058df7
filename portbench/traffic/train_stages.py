"""Traffic kind ``train_stages``: a training job that runs a list of schedule
stages through ``pinnfc_tpu_torch.training.stages.run_schedule``, the path of
``cli train``, again and again on one campaign's normal rows.

Parameters (the cell's ``params``): ``n_normal`` training rows (the normal
rows of a campaign made from the seed, ``n_fault`` rows per fault segment
made beside them and not used), ``stages`` (name, n_iter, lr, lr_step,
lr_gamma and, for ``lambda_v``, dnn_para, as ``config.StageConfig`` takes
them; DNN stages and λ stages), ``check_steps`` and ``trace_calls``.  The
precision is the configuration's ``port_precision``.

Set-up warms the window's call up on params of its own, each stage cut to
two steps, and hands the window params holding the weights made from the
seed and the configuration's λ's.  Each call of the window starts from the
params the last one left, with a seed of its own.  The first call is the one
the check compares: recorders stand in for the stages that ``run_schedule``
looks up at call time (``train_dnn``, ``train_lambda_v_chunk``,
``train_residual_chunk``) and for the λ stages' ``adam_step``; they keep what
each stage starts from and the λ's and gradients of its first steps, and pass
every argument through; the call's log keeps every step's loss.

End-to-end: ``train_steps_per_s`` and ``lambda_steps_per_s`` (DNN steps and
λ steps completed over the seconds they took, counted in whole calls).  With
``--trace 1`` the profiler covers the first ``trace_calls`` calls.  Counts
for the readers, of the traced calls: ``rows``, ``calls``, ``stages``,
``steps`` (DNN) and ``lambda_steps``.
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
from portbench.reference import lambda_stages, masks, mlp
from portbench.reference.rounding import round_bf16
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
    starts: list = dataclasses.field(default_factory=list)  # per stage of call 0
    # per λ stage of call 0, by stage index: (λ, gradient) of its first adam_step calls
    adam: Dict[int, list] = dataclasses.field(default_factory=dict)


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


def _lambda_stage(name: str) -> bool:
    return name in lambda_stages.GROUP_OF


@contextlib.contextmanager
def _recording(state: State, k: int):
    """Recorders in place of the stages that ``run_schedule`` looks up at call
    time: each keeps a copy of what its stage starts from (the weights, (W, b)
    per layer, or the λ vector) in ``state.starts``; in a λ stage the one in
    place of ``adam_step`` keeps the λ's and the gradient that its first
    ``k`` + 1 calls get in ``state.adam``.  Every argument passes through."""
    from pinnfc_tpu_torch.training import stages

    names = ("train_dnn", "train_lambda_v_chunk", "train_residual_chunk", "adam_step")
    real = {n: getattr(stages, n) for n in names}

    def dnn(mlp, *args, **kw):
        state.starts.append([(lin.weight.detach().clone(), lin.bias.detach().clone())
                             for lin in mlp.linears()])
        return real["train_dnn"](mlp, *args, **kw)

    def lam_stage(name):
        def stage(lam, *args, **kw):
            state.adam[len(state.starts)] = []
            state.starts.append(lam.detach().clone())
            return real[name](lam, *args, **kw)
        return stage

    def adam(w, g, *args, **kw):
        kept = state.adam.get(len(state.starts) - 1)
        if kept is not None and len(kept) <= k:
            kept.append((w.detach().clone(), g.detach().clone()))
        return real["adam_step"](w, g, *args, **kw)

    stand_ins = {"train_dnn": dnn, "train_lambda_v_chunk": lam_stage("train_lambda_v_chunk"),
                 "train_residual_chunk": lam_stage("train_residual_chunk"), "adam_step": adam}
    for n in names:
        setattr(stages, n, stand_ins[n])
    try:
        yield
    finally:
        for n in names:
            setattr(stages, n, real[n])


def window(state: State, run: Run) -> Window:
    p = run.cell.traffic
    specs = p["stages"]
    dnn_steps = sum(int(s["n_iter"]) for s in specs if s["name"] == "dnn")
    lam_steps = sum(int(s["n_iter"]) for s in specs if _lambda_stage(s["name"]))
    trace_calls = int(p.get("trace_calls", MAX_CALLS))
    calls = failed = traced = 0
    run.tracer.open()
    t_start = time.perf_counter()
    t_end = t_start
    while (t_end - t_start < run.seconds or calls < run.min_requests) and calls < MAX_CALLS:
        if calls == trace_calls:
            traced = calls if run.tracer.active else 0
            run.tracer.close()
        record = (_recording(state, int(p["check_steps"])) if calls == 0
                  else contextlib.nullcontext())
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
    seconds = t_end - t_start
    return Window({"train_steps_per_s": dnn_steps * calls / seconds,
                   "lambda_steps_per_s": lam_steps * calls / seconds},
                  attempted=calls * len(specs), failed=failed,
                  counts={"rows": int(state.data["x"].shape[0]), "calls": traced,
                          "stages": len(specs) * traced, "steps": dnn_steps * traced,
                          "lambda_steps": lam_steps * traced})


def _reference_rows(state: State, run: Run):
    """The training rows as the reference works them out from the raw ones."""
    x, y = np.asarray(state.normal[0]), np.asarray(state.normal[1]).reshape(-1, 1)
    sx, sy = ref_campaign.fit_minmax(x), ref_campaign.fit_minmax(y)
    return (torch.as_tensor(ref_campaign.scaled(x, sx), device=run.device),
            torch.as_tensor(ref_campaign.scaled(y, sy), device=run.device))


def _gap(prog: float, ref: float, scale: float) -> float:
    """|prog − ref| over ``scale``, the mean |row term| of the reference's
    loss; inf where either is not finite."""
    if scale == 0:
        return 0.0 if float(prog) == ref else math.inf
    gap = abs(float(prog) - ref) / scale
    return gap if math.isfinite(gap) else math.inf


def _norm_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """|‖prog‖ − ‖ref‖| over ‖ref‖; inf where either is not finite."""
    a = float(torch.linalg.vector_norm(prog.double()))
    b = float(torch.linalg.vector_norm(ref.double()))
    return _gap(a, b, b)


def _lambda_rows(state: State, run: Run, specs, j: int) -> lambda_stages.Rows:
    """What stage ``j``'s loss reads, as the reference works it out: the
    training rows and the eval pass of the weights the call started from."""
    if any(s["name"] == "dnn" for s in specs[:j]):
        raise ValueError("the check follows a λ stage only before any DNN stage of the call")
    x = np.asarray(state.normal[0])
    y = np.asarray(state.normal[1]).reshape(-1, 1)
    sx, sy = ref_campaign.fit_minmax(x), ref_campaign.fit_minmax(y)
    xs = ref_campaign.scaled(x, sx)
    mlp.strict_float32()
    u = mlp.eval_forward(state.weights, torch.as_tensor(xs, device=run.device))[0]
    return lambda_stages.rows(xs, ref_campaign.scaled(y, sy)[:, 0], sx, sy, u)


def _lambda_gaps(state: State, run: Run, specs, j: int, k: int, rows) -> Dict[str, Any]:
    """Stage ``j``'s numbers: the program's first ``k`` steps (or, with
    ``run.control``, the reference's in bf16 in its place) judged step by step
    by the reference.  Step 0 starts from the configuration's λ's for a
    group's first stage of the call and from the program's for a later one;
    step t from the λ's the program's step t − 1 left.  At each the reference
    works out the loss and the gradient, and from the program's gradients the
    Adam steps and clamps they make."""
    spec = specs[j]
    group = lambda_stages.GROUP_OF[spec["name"]]
    init = run.lambdas()
    first = all(lambda_stages.GROUP_OF.get(s["name"]) != group for s in specs[:j])
    start = init[group] if first else state.starts[j].double().cpu().tolist()
    dnn_para = bool(spec.get("dnn_para", False))
    schedule = (spec["lr"], spec["lr_step"], spec["lr_gamma"])
    if run.control:
        prog = lambda_stages.steps(spec["name"], dnn_para, start, init, rows, k, *schedule,
                                   rnd=round_bf16)
    else:
        kept = state.adam.get(j, [])
        if len(kept) <= k:
            return {"losses": [math.inf] * k, "grad": math.inf, "change": math.inf}
        prog = lambda_stages.Steps(list(state.losses[j][:k]), [g for _, g in kept[:k]],
                                   [w for w, _ in kept])
    losses, grads = [], []
    for t in range(k):
        at = start if t == 0 else prog.lams[t].double().cpu().tolist()
        ref = lambda_stages.point(spec["name"], dnn_para, at, init, rows)
        losses.append(_gap(prog.losses[t], ref.loss, ref.loss))
        norm = float(torch.linalg.vector_norm(prog.grads[t].double()))
        grads.append(_gap(norm, float(torch.linalg.vector_norm(ref.grad)), ref.grad_scale))
    origin = torch.as_tensor(np.asarray(start, np.float64), device=rows.real.device)
    moved = lambda_stages.adam_steps(spec["name"], start, prog.grads[:k], *schedule) - origin
    return {"losses": losses, "grad": max(grads),
            "change": _norm_gap(prog.lams[k] - prog.lams[0], moved)}


def check(state: State, run: Run) -> List[Check]:
    """The window's first call against the reference, stage by stage.

    A DNN stage runs from the weights it started from (the seed's for the
    first, the weights the stage before returned for the others) with its own
    dropout seed; each loss's gap is over the mean |row term| of the
    reference's.  A λ stage runs from the λ's it started from (the
    configuration's for a group's first stage, the ones the stage before
    returned for a later one) on the eval pass of the seed's weights; each
    loss's gap is over the reference's loss (its rows' terms are squares).

    - ``first_loss_gap``: the loss of each stage's step 0 (the forward);
    - ``step_loss_gap``: the losses of steps 1 to ``check_steps`` − 1 (the
      backward and Adam);
    - ``grad_norm_gap`` (λ stages): |‖g‖ − ‖g_ref‖| / ‖g_ref‖ of the first
      gradient as ``adam_step`` gets it;
    - ``change_norm_gap`` (λ stages): the same of the λ's change over the
      first ``check_steps`` steps, as the next ``adam_step`` gets them.

    Each is the largest over the stages.  With ``run.control`` the reference
    in the precision below the stated one runs each stage's first steps in
    the program's place, from the same start: the DNN stages' products in
    the configuration's control precision, the λ stages' inputs in bf16 (the
    precision below float32 for what is not a product)."""
    p = run.cell.traffic
    specs, k = p["stages"], int(p["check_steps"])
    state.params = None  # the program's state, freed before the reference
    if len(state.starts) != len(specs) or len(state.losses) != len(specs):
        return [Check(name, math.inf, float(limit)) for name, limit in run.cell.limits.items()]
    x = y = rows = None
    dropout = run.cell.config["train_dropout"]
    gaps = dict.fromkeys(("first_loss_gap", "step_loss_gap", "grad_norm_gap",
                          "change_norm_gap"), 0.0)
    for j, spec in enumerate(specs):
        if _lambda_stage(spec["name"]):
            if rows is None:
                rows = _lambda_rows(state, run, specs, j)
            lam = _lambda_gaps(state, run, specs, j, k, rows)
            step = lam["losses"]
            gaps["grad_norm_gap"] = max(gaps["grad_norm_gap"], lam["grad"])
            gaps["change_norm_gap"] = max(gaps["change_norm_gap"], lam["change"])
        else:
            if x is None:
                x, y = _reference_rows(state, run)
            first = all(s["name"] != "dnn" for s in specs[:j])
            start = state.weights if first else state.starts[j]
            seed = masks.stage_seed(state.seeds[0], j)
            schedule = (spec["lr"], spec["lr_step"], spec["lr_gamma"], dropout)
            ref, scale = mlp.train_steps(start, x, y, seed, k, *schedule,
                                         run.reference_rounding("train_products"))
            prog = state.losses[j]
            if run.control:
                prog = mlp.train_steps(start, x, y, seed, k, *schedule,
                                       run.control_rounding("train_products"))[0]
            step = [_gap(a, b, s) for a, b, s in zip(prog[:k], ref, scale)]
        gaps["first_loss_gap"] = max(gaps["first_loss_gap"], step[0])
        gaps["step_loss_gap"] = max([gaps["step_loss_gap"], *step[1:]])
    return [Check(name, gaps[name], float(limit)) for name, limit in run.cell.limits.items()]
