"""Self-contained model artifacts with ``torch.export`` (counterpart of
``pinnfc_tpu/serving/exported.py``, which writes StableHLO with
``jax.export``).

An artifact is a serialized ``ExportedProgram``: the traced function with
the weights and both MinMax scalers baked in, and a symbolic batch
dimension, so one file serves every block size:

* the eval-mode scorer — raw sensor rows ``(B, 8)`` → physical-unit voltage
  prediction ``(B,)`` and aleatoric log-variance ``(B,)``
  (:func:`export_scorer`); it holds aten operators only, so
  ``torch.export.load`` runs it with torch alone;
* the streaming monitor's block step with its carried state
  (:func:`export_monitor_step`), or the same step over a whole fleet of
  streams (:func:`export_monitor_fleet_step`).  Both trace
  ``OnlineMonitor._device_step``, the function the eager monitor runs, and
  call the residual kernel through the registered operator
  ``pinnfc_torch::residuals`` (``ops/residuals.py``): loading one needs this
  package importable, which registers the operator, and on the card each
  call launches ``csrc/residuals.cu`` once.

Artifacts are traced on the CPU and moved at load time
(``torch.export.passes.move_to_device_pass``), so a machine without a card
exports for one; the targets are ``cpu`` and ``cuda``, and an artifact
loads only onto the device types it was exported for (``platforms``, kept
in the artifact).  The recurrences' doubling scans run the rounds of blocks
up to ``BLOCK_MAX`` rows (``ops/recurrences.py``): the traced program does
not depend on the block size, and a longer block is served in pieces.

The adaptive conformal level α_t stays on the host, after the step's read,
as in ``OnlineMonitor``: its step size γ and target α* are serve-time values
(the ``cli export-model`` sidecar records them), and the artifact's
``aci_alpha``/``aci_anomaly`` outputs are None.
"""

from __future__ import annotations

import io
import json
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from pinnfc_tpu_torch.config import RiskConfig
from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.serving.monitor import (
    DEFAULT_GLITCH_ALARM_N, STEP_OUT_FIELDS, MonitorState, OnlineMonitor, _split_columns)

# the devices an artifact can be moved to at load time
PLATFORMS = ("cpu", "cuda")
# the longest block one call of a monitor-step artifact takes: the 256-row
# blocks that phase 18 of chip_smoke.py serves and times, four times the
# 64-row default ``--block`` of ``cli monitor``; each scan runs
# ⌈log2 BLOCK_MAX⌉ = 8 rounds per call, whatever the block
BLOCK_MAX = 256
# the record inside every artifact (a torch.export extra file): its
# platforms and, for a monitor step, its layout
META_FILE = "pinnfc_artifact.json"
STEP_KIND = "pinnfc_torch_monitor_step"


def check_platforms(platforms: Sequence[str]) -> Tuple[str, ...]:
    """``platforms`` as a tuple, or ``ValueError`` naming the targets the port
    has."""
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if not platforms or bad:
        raise ValueError(f"unknown export platform(s) {bad or list(platforms)}: a torch.export "
                         f"artifact targets {', '.join(PLATFORMS)}")
    return platforms


class _Scorer(torch.nn.Module):
    """raw (B, F) → (v_pred (B,), log_var (B,)): the scaler, the eval forward,
    the inverse scaler."""

    def __init__(self, mlp, scaler_x: AffineScaler, scaler_y: AffineScaler):
        super().__init__()
        self.mlp = mlp
        for name, t in (("sx_scale", scaler_x.scale), ("sx_min", scaler_x.min),
                        ("sy_scale", scaler_y.scale), ("sy_min", scaler_y.min)):
            self.register_buffer(name, t.detach().clone())

    def forward(self, x_raw):
        pred_norm, log_var = self.mlp(x_raw * self.sx_scale + self.sx_min)
        v = (pred_norm - self.sy_min) / self.sy_scale
        return v[:, 0], log_var[:, 0]


def build_scorer_fn(params, scaler_x: AffineScaler, scaler_y: AffineScaler) -> torch.nn.Module:
    """The deterministic scorer, raw ``(B, 8)`` sensors → physical-unit
    ``(v_pred (B,), log_var (B,))``: the eval-mode forward (01:1403-1411)
    between the MinMax normalize/denormalize round trip (01:271-274,
    01:2163), in float32 on the device of ``params``."""
    mlp = params["mlp"] if isinstance(params, dict) and "mlp" in params else params
    return _Scorer(mlp, scaler_x, scaler_y).eval()


def _serialize(ep, meta: dict) -> bytes:
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={META_FILE: json.dumps(meta)})
    return buf.getvalue()


def _read(blob: bytes):
    """Deserialize an artifact → (ExportedProgram, its record)."""
    extra = {META_FILE: ""}
    ep = torch.export.load(io.BytesIO(blob), extra_files=extra)
    return ep, json.loads(extra[META_FILE] or "{}")


def _place(ep, meta: dict, device):
    """The program of ``ep`` on ``device``; ``ValueError`` for a device type
    the artifact was not exported for."""
    kind = torch.device(device).type
    if "platforms" in meta and kind not in meta["platforms"]:
        raise ValueError(f"the artifact was exported for {', '.join(meta['platforms'])}, "
                         f"not {kind} (export-model --platforms)")
    dev = resolve_device(device)
    if dev.type != "cpu":
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, str(dev))
    return ep.module()


def export_scorer(params, scaler_x: AffineScaler, scaler_y: AffineScaler,
                  platforms: Sequence[str] = PLATFORMS) -> bytes:
    """Serialize the scorer (traced on the CPU) to an artifact (bytes) whose
    batch dimension is symbolic: it accepts any ``(B, 8)`` float32 batch, on
    the device types in ``platforms``."""
    platforms = check_platforms(platforms)
    scorer = build_scorer_fn(_to_cpu(params), scaler_x.to("cpu"), scaler_y.to("cpu"))
    b = torch.export.Dim("b", min=1)
    ep = torch.export.export(scorer, (torch.zeros(64, 8),), dynamic_shapes=({0: b},))
    return _serialize(ep, {"platforms": list(platforms)})


def load_scorer(blob: bytes, device="cuda"):
    """Deserialize an :func:`export_scorer` artifact onto ``device`` into a
    callable ``x_raw (B, 8) → (v_pred, log_var)``: torch alone, no checkpoint
    and no model code."""
    program = _place(*_read(blob), device)

    def scorer(x_raw):
        with torch.no_grad():
            return program(x_raw)

    return scorer


def _to_cpu(params):
    if isinstance(params, dict):
        return {k: (v.to("cpu") if isinstance(v, (torch.Tensor, torch.nn.Module)) else v)
                for k, v in params.items()}
    return params.to("cpu")


class _MonitorStep(torch.nn.Module):
    """The monitor's block step as a traced function: ``(state tuple in
    MonitorState._fields order, x_raw, v_meas, mu, sigma) → (state tuple,
    outputs in STEP_OUT_FIELDS order)``; with ``fleet`` every input and
    output has a leading stream axis."""

    def __init__(self, monitor, fleet: bool):
        super().__init__()
        self.mlp = monitor.params["mlp"]  # its weights become the program's
        self.monitor = monitor
        self.fleet = fleet

    def forward(self, state, x_raw, v_meas, mu, sigma):
        mon = self.monitor
        c, rf_smooth, v_first, n_seen, v_first_set, glitch_run, layer_c, oob_count, aci = state
        if not self.fleet:  # one stream: the fleet program at s = 1
            c, rf_smooth, v_first, n_seen, v_first_set, glitch_run, layer_c, oob_count = (
                t[None] for t in (c, rf_smooth, v_first, n_seen, v_first_set, glitch_run,
                                  layer_c, oob_count))
            x_raw, v_meas = x_raw[None], v_meas[None]
        s_n, b_n, f_n = x_raw.shape
        # one stream count and one block size across the inputs (the tracer
        # gives each input's axes their own symbols until told so)
        for t in (c, rf_smooth, v_first, n_seen, v_first_set, glitch_run, layer_c, oob_count,
                  v_meas):
            torch._check(t.shape[0] == s_n)
        torch._check(v_meas.shape[1] == b_n)
        f32 = torch.float32
        carry = torch.cat([torch.stack([c, rf_smooth, v_first, v_first_set.to(f32),
                                        (n_seen == 0).to(f32), glitch_run], dim=-1),
                           layer_c], dim=-1)
        per_sample, per_stream = mon._device_step(x_raw, v_meas.T, carry, mu, sigma, BLOCK_MAX)
        k = 0 if mon.diagnosis is None else len(mon.diagnosis.class_names)
        f = _split_columns(per_sample.transpose(0, 1), per_stream, len(mon.layer_names), k,
                           mon._conformal)  # (S, B, ...) and (S, ...)
        fault = (None, None) if not k else (f["fault_probs"], f["fault_pred"].to(torch.int32))
        new_state = (f["c"], f["rf_smooth"][:, -1], f["v_first"], n_seen + b_n,
                     f["v_first_set"], f["glitch_run"], f["layer_c"][:, -1],
                     oob_count + f["oob_count"].to(torch.int32))
        out = (f["rf_inst"], f["rf_smooth"], f["residuals"], f["v_pred"], f["v_alarm"],
               f["glitch"], f["sensor_alarm"], fault, f["layer_scores"], f["layer_c"], f["oob"],
               f["conformal_p"])
        if not self.fleet:
            new_state, out = _index(new_state, 0), _index(out, 0)
        # the ACI level runs on the host after the read (OnlineMonitor._unpack)
        return (*new_state, aci), (*out, None, None)


def _export_step(monitor, fleet: bool, platforms) -> bytes:
    platforms = check_platforms(platforms)
    if monitor.device.type != "cpu":
        raise ValueError("export a monitor built with device='cpu' (the artifact is traced on "
                         "the CPU and moved to its device at load time)")
    s_ex, b_ex = 2, min(64, BLOCK_MAX)  # example sizes of the trace, not 0 or 1
    lead = (s_ex,) if fleet else ()
    fresh = [torch.as_tensor(np.asarray(a)) for a in monitor._fresh_state()]
    state = tuple(t.expand(lead + tuple(t.shape)).clone() for t in fresh)
    n_res = int(monitor.mu.shape[0])
    x = torch.zeros(lead + (b_ex, monitor._n_features))
    v = torch.zeros(lead + (b_ex,))
    b = torch.export.Dim("b", min=1, max=BLOCK_MAX)
    if fleet:
        s = torch.export.Dim("s", min=1)
        dyn = (tuple({0: s} for _ in state), {0: s, 1: b}, {0: s, 1: b}, None, None)
    else:
        dyn = ((None,) * len(state), {0: b}, {0: b}, None, None)
    ep = torch.export.export(_MonitorStep(monitor, fleet),
                             (state, x, v, torch.zeros(n_res), torch.ones(n_res)),
                             dynamic_shapes=dyn)
    return _serialize(ep, {
        "platforms": list(platforms), "kind": STEP_KIND, "fleet": fleet, "block_max": BLOCK_MAX,
        "state_fields": list(MonitorState._fields), "out_fields": list(STEP_OUT_FIELDS),
        "n_features": monitor._n_features, "n_res": n_res,
        "n_layers": len(monitor.layer_names),
        "n_classes": (None if monitor.diagnosis is None
                      else len(monitor.diagnosis.class_names)),
        "conformal": monitor._conformal,
    })


def export_monitor_step(monitor, platforms: Sequence[str] = PLATFORMS) -> bytes:
    """Serialize an ``OnlineMonitor``'s block step (params, scalers, risk
    config, glitch threshold, the optional diagnosis head and conformal
    calibration vector baked in; the monitor on the CPU) to an artifact.

    Signature (symbolic block size ``b`` ≤ ``BLOCK_MAX``)::

        (state, x_raw f32[b,8], v_meas f32[b], mu f32[5], sigma f32[5])
          -> (state, (rf_inst, rf_smooth, residuals f32[b,5], v_pred, v_alarm,
                      glitch, sensor_alarm, (fault_probs, fault_pred),
                      layer_scores f32[b,L], layer_c f32[b,L], oob bool[b],
                      conformal_p f32[b] | None, None, None))

    ``state`` is a plain tuple in ``MonitorState._fields`` order; feed each
    returned state into the next call.  ``aci_alpha`` passes through
    unchanged (the level runs on the host).  ``mu``/``sigma`` stay runtime
    inputs: the per-operating-condition normal statistics (04:179-199)."""
    return _export_step(monitor, False, platforms)


def export_monitor_fleet_step(monitor, platforms: Sequence[str] = PLATFORMS) -> bytes:
    """Serialize the monitor's fleet step, ``observe_many``'s device program,
    with the stream axis ``s`` and the block size ``b`` symbolic: every state
    field and every per-sample output gains a leading ``s`` axis, and
    ``x_raw`` is f32[s,b,8], ``v_meas`` f32[s,b].  The port's device step is
    batched over streams already, so this is the same traced function;
    ``monitor_from_artifact`` advances a whole fleet in one call."""
    return _export_step(monitor, True, platforms)


class _ArtifactDiagnosis(NamedTuple):
    """The one attribute the serving layer reads off a DiagnosisHead when
    fault outputs are present (server.py payload naming)."""

    class_names: Tuple[str, ...]


def _index(tree, i):
    """Stream ``i`` of step outputs with a leading stream axis (None stays
    None, tuples field by field)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(_index(t, i) for t in tree)
    return tree[i]


def _cat_outs(parts):
    """Concatenate per-piece step outputs along the block axis (None stays
    None, tuples field by field)."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return tuple(_cat_outs([p[i] for p in parts]) for i in range(len(first)))
    return np.concatenate(parts)


def _stack_outs(parts):
    """Stack per-stream program outputs on a new leading stream axis (None
    stays None, tuples field by field)."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return tuple(_stack_outs([p[i] for p in parts]) for i in range(len(first)))
    return torch.stack(parts)


class ArtifactMonitor(OnlineMonitor):
    """An ``OnlineMonitor`` whose device step is a deserialized monitor-step
    artifact.  The step around it is the parent's (one packed host→device
    copy, one read, the ACI level on the host); ``_device_step`` turns the
    packed carry into the artifact's state tuple and its outputs back into
    the packed columns, and ``_step`` serves a block longer than the
    artifact's ``block_max`` in pieces."""

    def __init__(self, program, layout: dict, mu, sigma, config, glitch_alarm_n,
                 class_names, conformal_alpha: float, conformal_gamma: float, device):
        k = layout["n_classes"]
        diagnosis = None
        if k is not None:
            names = tuple(class_names) if class_names else tuple(f"class_{i}" for i in range(k))
            if len(names) != k:
                raise ValueError(f"artifact bakes a {k}-class head but {len(names)} class "
                                 "names were given")
            diagnosis = _ArtifactDiagnosis(names)
        self._init_options(mu, sigma, config, diagnosis, glitch_alarm_n,
                           bool(layout["conformal"]), conformal_alpha, conformal_gamma,
                           int(layout["n_features"]), device)
        if len(self.layer_names) != layout["n_layers"]:
            raise ValueError(f"artifact carries {layout['n_layers']} risk layers but the given "
                             f"config defines {len(self.layer_names)} — pass the risk config "
                             "recorded in the artifact's sidecar")
        # the parent's attribute surface without its params/scalers: the
        # artifact baked those in
        self.params = self.scaler_x = self.scaler_y = self.conformal_calib = None
        self.conformal_baked = self._conformal
        self.fleet_baked = bool(layout["fleet"])
        self.block_max = int(layout["block_max"])
        self._program = program

    def _device_step(self, x_raw, v_meas, carry, mu, sigma, max_len=None):
        s_n = x_raw.shape[0]
        first = carry[:, 4] > 0
        # in MonitorState order; n_seen: the program reads only whether it is
        # 0 (the host keeps the count), and oob counts from 0 come back as
        # the block's
        state = (carry[:, 0], carry[:, 1], carry[:, 2], (~first).to(torch.int32),
                 carry[:, 3] > 0, carry[:, 5], carry[:, self._CARRY:],
                 torch.zeros_like(x_raw[:, 0], dtype=torch.int32), torch.zeros_like(carry[:, 0]))
        with torch.no_grad():
            if self.fleet_baked:
                new, out = self._program(state, x_raw, v_meas.T, mu, sigma)
            else:  # one call per stream
                new, out = _stack_outs([
                    self._program(_index(state, i), x_raw[i], v_meas[:, i], mu, sigma)
                    for i in range(s_n)])
        f32 = torch.float32
        rf_inst, rf_smooth, res, v_pred, v_alarm, glitch, sensor_alarm, fault = out[:8]
        layer_scores, layer_c, oob, conformal_p = out[8:12]
        cols = [rf_inst, rf_smooth, *res.unbind(-1), v_pred, v_alarm, glitch, sensor_alarm,
                *layer_scores.unbind(-1), *layer_c.unbind(-1), oob]
        cols += [] if conformal_p is None else [conformal_p]
        cols += [] if fault[0] is None else [*fault[0].unbind(-1), fault[1]]
        per_sample = torch.stack([c.to(f32) for c in cols], dim=-1).transpose(0, 1)
        c, _, v_first, _, v_first_set, glitch_run, _, oob_count, _ = new
        per_stream = torch.cat([torch.stack([c, glitch_run, v_first, v_first_set.to(f32)], -1),
                                oob_count.to(f32)], dim=-1)
        return per_sample, per_stream

    def _step(self, x_bank, v_bank, states) -> list:
        pieces = []
        for lo in range(0, x_bank.shape[1], self.block_max):
            done = super()._step(x_bank[:, lo:lo + self.block_max],
                                 v_bank[:, lo:lo + self.block_max], states)
            states = [st for st, _ in done]
            pieces.append([out for _, out in done])
        return [(st, _cat_outs([p[i] for p in pieces])) for i, st in enumerate(states)]


def monitor_from_artifact(blob: bytes, mu, sigma, config=None, glitch_alarm_n=None,
                          class_names: Sequence[str] | None = None,
                          conformal_alpha: float = 0.1, conformal_gamma: float = 0.0,
                          device="cuda") -> ArtifactMonitor:
    """A serving-ready ``OnlineMonitor`` whose device step is a
    :func:`export_monitor_step` or :func:`export_monitor_fleet_step`
    artifact moved to ``device``: no checkpoint and no model code, the
    program is the model.  The state bank, the HTTP server, snapshots and the
    Prometheus surface are the inherited ones.  A fleet artifact advances
    ``observe_many`` in one call (and ``observe`` at s = 1); a plain one runs
    the streams one call each.

    ``config``/``glitch_alarm_n`` are display-layer values (the artifact's
    baked ones govern the device math): pass the sidecar's recorded
    ``risk_config``/``glitch_alarm_n``, as ``cli serve --artifact`` does.
    ``class_names`` labels a baked head's classes (``class_0..K-1`` by
    default).  ``conformal_alpha``/``conformal_gamma`` are α* and γ of the
    host-side adaptive level: the sidecar's recorded values."""
    try:
        ep, layout = _read(blob)
    except Exception as e:  # noqa: BLE001 — an unreadable blob of any kind
        raise ValueError(f"not an `export-model --monitor-step` artifact: "
                         f"{type(e).__name__}: {e}") from None
    if layout.get("kind") != STEP_KIND or layout.get("state_fields") != list(
            MonitorState._fields):
        raise ValueError("not an `export-model --monitor-step` artifact: it carries no "
                         "monitor-step layout (a plain scorer artifact loads with "
                         "load_scorer instead)")
    # importing serving.monitor registered the residual operator the program calls
    return ArtifactMonitor(
        _place(ep, layout, device), layout, mu, sigma, RiskConfig() if config is None else config,
        DEFAULT_GLITCH_ALARM_N if glitch_alarm_n is None else int(glitch_alarm_n),
        class_names, conformal_alpha, conformal_gamma, device)
