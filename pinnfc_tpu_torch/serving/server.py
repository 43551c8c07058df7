"""Minimal HTTP scoring endpoint around ``OnlineMonitor``, stdlib only
(counterpart of ``pinnfc_tpu/serving/server.py``: the same paths, JSON
payloads and Prometheus names).

One JSON endpoint on ``http.server`` whose handler funnels every request
through the monitor's step: on the card one host→device copy, one
residual-kernel launch and one read per ``/observe`` or ``/observe_many``.
The monitor carries the O(1) RF(t) state, so request granularity does not
change the series.

    POST /observe   {"x": [[... 8 raw channels ...], ...], "v": [...],
                     "stream": "stack-07"}          (stream optional)
        → {"rf_smooth": [...], "rf_inst": [...], "v_pred": [...],
           "warn": [...], "danger": [...], "v_alarm": [...],
           "glitch": [...], "sensor_alarm": [...],
           "fault_probs": [[...]], "fault_pred": [...],     (with a head)
           "fault_names": [...], "n_seen": int,
           "stream": "...", "stream_n_seen": int,
           "layer_names": [...], "layer_scores": [[...]], "layer_c": [[...]],
           "oob": [...],
           "conformal_p": [...], "conformal_alpha": a, "stream_low_p": n,
           "aci_alpha": [...], "aci_anomaly": [...]}   (with a calibration)
    POST /observe_many  {"streams": [...], "x": (S,B,8), "v": (S,B)}
        → {"results": {stream: <observe payload>}, "n_seen": int}
        (a whole fleet advances in one step)
    POST /reset     {"stream": "stack-07"}          (optional; else all)
        → {"ok": true}
    GET  /health    → {"ok": true, "n_seen": int, "streams": [...],
                       "provenance": {...}}  (provenance only when the
                       serving checkpoint carried a .meta.json sidecar)
    GET  /metrics   → Prometheus text exposition: request/latency/sample
        counters plus per-stream gauges read from the monitor's host state
        bank (a scrape touches no device).

Requests are handled one at a time (``observe`` is order-dependent); SIGTERM
drains gracefully (see ``serve``).  Start from the command line:
``python -m pinnfc_tpu_torch.cli serve --ckpt ck --mat F01_output.mat``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional

import numpy as np

from pinnfc_tpu_torch.serving.monitor import OnlineMonitor

# bound request memory: 32 MiB of JSON ≈ 10^5+ samples per block, far above
# any sane streaming block size
MAX_REQUEST_BYTES = 32 * 1024 * 1024


def _finite_or_null(arr) -> list:
    """JSON-safe float list: non-finite values (the glitched samples'
    v_pred/rf outputs) become null — ``json.dumps`` would otherwise emit
    the non-RFC-8259 token ``NaN`` that strict clients refuse to parse."""
    a = np.asarray(arr, np.float64)
    return [float(v) if np.isfinite(v) else None for v in a.ravel()]


MAX_STREAM_KEY_LEN = 128
# untrusted-boundary cap: every NOVEL stream key allocates a state-bank
# entry that lives until reset — without a cap a client looping unique
# keys grows the bank (and /health's streams list) without bound
MAX_STREAMS = 1024

# the routes this server actually serves; anything else is folded into one
# "<other>" label in /metrics so a client probing random URLs cannot grow
# the request-counter dict (and the scrape output) without bound
KNOWN_PATHS = frozenset(
    {"/observe", "/observe_many", "/reset", "/health", "/metrics"}
)


def _stream_key(req: dict, monitor: OnlineMonitor) -> str:
    stream = req.get("stream", "default")
    if not isinstance(stream, str) or not stream:
        raise ValueError("stream must be a non-empty string")
    if len(stream) > MAX_STREAM_KEY_LEN:
        raise ValueError(f"stream key longer than {MAX_STREAM_KEY_LEN} chars")
    if stream not in monitor.streams and len(monitor.streams) >= MAX_STREAMS:
        raise ValueError(
            f"stream bank full ({MAX_STREAMS} streams); POST /reset with no "
            "stream key clears the bank"
        )
    return stream


def _json_payload(out, monitor: OnlineMonitor, stream: str = "default") -> dict:
    payload = {
        "rf_smooth": _finite_or_null(out.rf_smooth),
        "rf_inst": _finite_or_null(out.rf_inst),
        "v_pred": _finite_or_null(out.v_pred),
        "warn": out.warn.tolist(),
        "danger": out.danger.tolist(),
        "v_alarm": out.v_alarm.tolist(),
        "glitch": out.glitch.tolist(),
        "sensor_alarm": out.sensor_alarm.tolist(),
        # host-side counters (the state bank is host numpy)
        "n_seen": monitor.n_seen,
        "stream": stream,
        "stream_n_seen": monitor.stream_n_seen(stream),
        # per-layer risk attribution (04:244-259): which physics layer —
        # voltage / gas / temp — is driving each sample's S_tot, and the
        # carried per-layer risk integral C_l (row sums ≡ the unclipped C,
        # so row/rowsum is the exact live attribution of the risk level)
        "layer_names": list(monitor.layer_names),
        "layer_scores": [
            _finite_or_null(row)
            for row in np.round(np.asarray(out.layer_scores, np.float64), 6)
        ],
        "layer_c": [
            _finite_or_null(row)
            for row in np.round(np.asarray(out.layer_c, np.float64), 6)
        ],
    }
    if out.oob is not None:
        # input-range drift flags (absent when serving a pre-drift exported
        # artifact); cumulative per-channel counts are on /metrics
        payload["oob"] = out.oob.tolist()
    if out.conformal_p is not None:
        # calibrated per-sample anomaly p-values (uq/conformal semantics:
        # ≈uniform on normal-like data, → 1/(n+1) under shift; NaN → null
        # on glitches); present when the monitor carries a calibration
        # vector.  The α used by the cumulative low-p counter on /metrics
        # rides along so clients can apply the same threshold.
        payload["conformal_p"] = _finite_or_null(out.conformal_p)
        payload["conformal_alpha"] = monitor.conformal_alpha
        payload["stream_low_p"] = monitor.stream_low_p(stream)
    if out.aci_anomaly is not None:
        # adaptive conformal: the drift-tracked level each sample was
        # tested at and the budgeted alarm flag (long-run rate ≈ α* even
        # under drift when γ>0; constant α* when γ=0)
        payload["aci_alpha"] = _finite_or_null(out.aci_alpha)
        payload["aci_anomaly"] = out.aci_anomaly.tolist()
    if out.fault_probs is not None:
        probs = np.round(np.asarray(out.fault_probs, np.float64), 6)
        payload["fault_probs"] = [
            _finite_or_null(row) for row in probs
        ]
        payload["fault_pred"] = out.fault_pred.tolist()
        # glitched samples carry fault_pred = -1 (no valid posterior)
        payload["fault_names"] = [
            monitor.diagnosis.class_names[int(i)] if int(i) >= 0 else None
            for i in out.fault_pred
        ]
    return payload


def _prom_escape(value: str) -> str:
    """Escape a Prometheus label value (spec: backslash, quote, newline)."""
    return (
        value.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _render_metrics(
    monitor: OnlineMonitor, stats: dict, provenance: Optional[dict] = None
) -> str:
    """Prometheus text exposition (v0.0.4) for the serving surface.

    Request/latency counters come from the handler's ``stats`` dict; the
    per-stream gauges read the monitor's host-resident state bank directly,
    so a scrape never touches the device."""
    lines = []
    if provenance:
        # the standard "info metric" pattern: constant 1 with the model's
        # identity as labels, joinable onto every other series
        labels = ",".join(
            f'{k}="{_prom_escape(str(v))}"' for k, v in sorted(
                provenance.items()
            )
        )
        lines += [
            "# HELP pinnfc_model_info The serving checkpoint's provenance "
            "(.meta.json summary).",
            "# TYPE pinnfc_model_info gauge",
            f"pinnfc_model_info{{{labels}}} 1",
        ]
    lines += [
        "# HELP pinnfc_requests_total Requests served, by path and status code.",
        "# TYPE pinnfc_requests_total counter",
    ]
    for (path, code), n in sorted(stats["requests"].items()):
        lines.append(
            f'pinnfc_requests_total{{path="{_prom_escape(path)}",'
            f'code="{code}"}} {n}'
        )
    lines += [
        "# HELP pinnfc_observe_seconds Time spent in successful observe/"
        "observe_many calls (request-handler view, includes the device "
        "round trip).",
        "# TYPE pinnfc_observe_seconds summary",
        f"pinnfc_observe_seconds_sum {stats['observe_seconds']:.6f}",
        f"pinnfc_observe_seconds_count {stats['observe_calls']}",
        "# HELP pinnfc_samples_streamed_total Samples scored across all "
        "streams since start.",
        "# TYPE pinnfc_samples_streamed_total counter",
        f"pinnfc_samples_streamed_total {monitor.n_seen}",
        "# HELP pinnfc_streams Active streams in the state bank.",
        "# TYPE pinnfc_streams gauge",
        f"pinnfc_streams {len(monitor.streams)}",
        "# HELP pinnfc_stream_rf_smooth Latest smoothed risk-function value "
        "per stream (0 = healthy, 1 = maximal risk).",
        "# TYPE pinnfc_stream_rf_smooth gauge",
    ]
    if stats.get("snapshot_failures", 0) or stats.get("snapshot_path"):
        lines += [
            "# HELP pinnfc_snapshot_failures_total State-bank snapshot "
            "writes that failed (the in-memory state kept advancing; the "
            "on-disk snapshot is STALE until a write succeeds).",
            "# TYPE pinnfc_snapshot_failures_total counter",
            f"pinnfc_snapshot_failures_total {stats.get('snapshot_failures', 0)}",
        ]
    # the state bank is host numpy: a scrape touches no device (the series
    # in sorted stream order, as the JAX server's pytree read gives them)
    states = {s: monitor._streams[s] for s in sorted(monitor.streams)}
    per_stream = []
    for s, state in states.items():
        label = f'stream="{_prom_escape(s)}"'
        per_stream.append(
            (label, float(state.rf_smooth), float(state.glitch_run),
             monitor.stream_n_seen(s), np.asarray(state.layer_c, float),
             np.asarray(state.oob_count, np.int64))
        )
    for label, rf, _, _, _, _ in per_stream:
        lines.append(f"pinnfc_stream_rf_smooth{{{label}}} {rf:.6g}")
    lines += [
        "# HELP pinnfc_stream_glitch_run Consecutive non-finite samples "
        "ending the stream (sensor-outage indicator).",
        "# TYPE pinnfc_stream_glitch_run gauge",
    ]
    for label, _, run, _, _, _ in per_stream:
        lines.append(f"pinnfc_stream_glitch_run{{{label}}} {run:.6g}")
    lines += [
        "# HELP pinnfc_stream_n_seen Samples scored per stream.",
        "# TYPE pinnfc_stream_n_seen counter",
    ]
    for label, _, _, n, _, _ in per_stream:
        lines.append(f"pinnfc_stream_n_seen{{{label}}} {n}")
    lines += [
        "# HELP pinnfc_stream_layer_c Per-layer risk-integral composition "
        "(sums to the unclipped C): which physics layer is driving the "
        "stream's risk right now.",
        "# TYPE pinnfc_stream_layer_c gauge",
    ]
    for label, _, _, _, lc, _ in per_stream:
        for name, v in zip(monitor.layer_names, lc):
            lines.append(
                f'pinnfc_stream_layer_c{{{label},'
                f'layer="{_prom_escape(name)}"}} {v:.6g}'
            )
    lines += [
        "# HELP pinnfc_stream_oob_count Samples outside the training range "
        "per input channel (data drift: the model extrapolates on these).",
        "# TYPE pinnfc_stream_oob_count counter",
    ]
    for label, _, _, _, _, oob in per_stream:
        for name, v in zip(_channel_names(len(oob)), oob):
            lines.append(
                f'pinnfc_stream_oob_count{{{label},'
                f'channel="{_prom_escape(name)}"}} {int(v)}'
            )
    if getattr(monitor, "conformal_calib", None) is not None or getattr(
        monitor, "conformal_baked", False
    ):
        lines += [
            "# HELP pinnfc_stream_conformal_low_p Samples with conformal "
            "anomaly p-value at or below alpha (calibrated anomaly rate: "
            "divide by pinnfc_stream_n_seen; ~alpha when healthy).",
            "# TYPE pinnfc_stream_conformal_low_p counter",
        ]
        for s in monitor.streams:
            lines.append(
                f'pinnfc_stream_conformal_low_p{{stream='
                f'"{_prom_escape(s)}"}} {monitor.stream_low_p(s)}'
            )
        lines += [
            "# HELP pinnfc_stream_aci_alpha Adaptive conformal level "
            "alpha_t (drift gauge: ~alpha* while the stream matches the "
            "calibration campaign, falling under shift; constant at "
            "alpha* when gamma=0).",
            "# TYPE pinnfc_stream_aci_alpha gauge",
        ]
        for s, state in states.items():
            lines.append(
                f'pinnfc_stream_aci_alpha{{stream="{_prom_escape(s)}"}} '
                f"{float(state.aci_alpha):.6g}"
            )
    return "\n".join(lines) + "\n"


def _channel_names(n: int) -> tuple:
    """Drift-metric channel labels — the contract's single width-match rule."""
    from pinnfc_tpu_torch.data.contract import channel_names

    return channel_names(n)


def make_server(
    monitor: OnlineMonitor,
    host: str = "127.0.0.1",
    port: int = 8787,
    state_path: Optional[str] = None,
    provenance: Optional[dict] = None,
) -> HTTPServer:
    """Build (but do not start) the HTTP server; call ``serve_forever()``
    or drive it with ``handle_request()`` in tests.

    ``state_path`` enables preemption-safe serving: the monitor's stream
    bank is snapshotted (atomic npz) after every state-mutating request,
    and a restarted server pointed at the same path resumes every stream's
    RF(t) recurrence bit-exactly.  The bank is six host scalars per
    stream, so the per-request snapshot cost is microseconds."""
    # serving stats for GET /metrics (the server is serial by design, so
    # plain dict/int mutation is race-free)
    stats = {
        "requests": {},  # (path, code) -> count
        "observe_seconds": 0.0,
        "observe_calls": 0,
        "snapshot_failures": 0,
        "snapshot_path": state_path,
    }

    def _snapshot() -> None:
        """Persist the stream bank after a state-mutating request.

        A failed write must NOT turn the already-applied observation into
        a 500: the RF(t) recurrence is order-dependent, so a client that
        retries on 500 would feed the same samples twice and permanently
        corrupt the series.  Failures are counted (``/metrics`` exposes
        ``pinnfc_snapshot_failures_total``) and logged to stderr; ``serve``
        probes writability at startup so a misconfigured path fails fast."""
        if state_path is None:
            return
        try:
            monitor.save_state_bank(state_path)
        except Exception as e:  # noqa: BLE001 — degraded-persistence mode
            stats["snapshot_failures"] += 1
            print(
                f"WARNING: state-bank snapshot to {state_path!r} failed "
                f"({type(e).__name__}: {e}); serving continues with the "
                "on-disk snapshot STALE",
                file=sys.stderr,
            )

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _reply_raw(
            self, code: int, body: bytes, content_type: str, count: bool = True
        ) -> None:
            if count:
                path = self.path if self.path in KNOWN_PATHS else "<other>"
                key = (path, code)
                stats["requests"][key] = stats["requests"].get(key, 0) + 1
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, code: int, obj: dict) -> None:
            self._reply_raw(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/health":
                out = {
                    "ok": True, "n_seen": monitor.n_seen,
                    "streams": list(monitor.streams),
                }
                if provenance is not None:
                    # which model is serving (checkpoint .meta.json summary)
                    out["provenance"] = provenance
                self._reply(200, out)
            elif self.path == "/metrics":
                # render first, count after: a scrape reports the state as of
                # its arrival, not itself (promhttp convention)
                body = _render_metrics(monitor, stats, provenance).encode()
                key = (self.path, 200)
                stats["requests"][key] = stats["requests"].get(key, 0) + 1
                self._reply_raw(
                    200, body, "text/plain; version=0.0.4; charset=utf-8",
                    count=False,
                )
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", "0"))
            if n < 0 or n > MAX_REQUEST_BYTES:
                # a negative length would make rfile.read block to EOF,
                # hanging the deliberately serial server
                raise ValueError(
                    f"request body length {n} outside [0, {MAX_REQUEST_BYTES}] B"
                )
            req = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(req, dict):
                # a top-level list/string/number would AttributeError on
                # req.get(...) in every route — reject at the boundary
                raise ValueError("request body must be a JSON object")
            return req

        def do_POST(self):
            if self.path == "/reset":
                try:
                    req = self._read_body()
                    stream = req.get("stream")
                    if stream is not None:
                        stream = _stream_key(req, monitor)
                except (ValueError, TypeError) as e:
                    self._reply(400, {"error": str(e)})
                    return
                try:
                    monitor.reset(stream)
                    _snapshot()
                    self._reply(200, {"ok": True})
                except Exception as e:  # noqa: BLE001 — serving boundary
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if self.path == "/observe_many":
                self._observe_many()
                return
            if self.path != "/observe":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                req = self._read_body()
                stream = _stream_key(req, monitor)
                x = np.asarray(req["x"], np.float32)
                v = np.asarray(req["v"], np.float32)
                if x.ndim != 2 or x.shape[1] != 8:
                    raise ValueError(f"x must be (B, 8), got {x.shape}")
                if v.shape != (x.shape[0],):
                    raise ValueError(
                        f"v must be ({x.shape[0]},), got {v.shape}"
                    )
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": str(e)})
                return
            # runtime failures (device errors, a head whose feature count
            # mismatches the checkpoint, ...) must come back as a 500, not a
            # dropped connection — note the monitor's recurrence state may
            # already have advanced when observe fails mid-call
            try:
                t0 = time.perf_counter()
                out = monitor.observe(x, v, stream=stream)
                stats["observe_seconds"] += time.perf_counter() - t0
                stats["observe_calls"] += 1
                _snapshot()
                self._reply(200, _json_payload(out, monitor, stream))
            except Exception as e:  # noqa: BLE001 — serving boundary
                # the recurrence state may already have advanced — keep the
                # snapshot current (never raises, see _snapshot)
                _snapshot()
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _observe_many(self):
            """POST /observe_many — a co-located fleet polling at one
            cadence: S streams advance in ONE device step
            (``OnlineMonitor.observe_many``) instead of S round trips.

                {"streams": ["stack-1", ...],          (S unique keys)
                 "x": [[[...8 channels...], ...], ...],  (S, B, 8)
                 "v": [[...], ...]}                      (S, B)
                → {"results": {stream: <observe payload>, ...},
                   "n_seen": int}
            """
            try:
                req = self._read_body()
                streams = req.get("streams")
                if (not isinstance(streams, list) or not streams
                        or not all(isinstance(s, str) for s in streams)):
                    raise ValueError("streams must be a non-empty list of strings")
                if len(set(streams)) != len(streams):
                    raise ValueError("stream keys must be unique")
                novel = 0
                for s in streams:
                    _stream_key({"stream": s}, monitor)
                    novel += s not in monitor.streams
                # _stream_key counts only already-created streams; the batch
                # itself may create several at once
                if len(monitor.streams) + novel > MAX_STREAMS:
                    raise ValueError(
                        f"stream bank full ({MAX_STREAMS} streams); POST "
                        "/reset with no stream key clears the bank"
                    )
                x = np.asarray(req["x"], np.float32)
                v = np.asarray(req["v"], np.float32)
                if x.ndim != 3 or x.shape[0] != len(streams) or x.shape[2] != 8:
                    raise ValueError(
                        f"x must be ({len(streams)}, B, 8), got {x.shape}"
                    )
                if v.shape != x.shape[:2]:
                    raise ValueError(f"v must be {x.shape[:2]}, got {v.shape}")
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": str(e)})
                return
            try:
                t0 = time.perf_counter()
                outs = monitor.observe_many(x, v, streams)
                stats["observe_seconds"] += time.perf_counter() - t0
                stats["observe_calls"] += 1
                _snapshot()
                self._reply(200, {
                    "results": {
                        s: _json_payload(out, monitor, s)
                        for s, out in outs.items()
                    },
                    "n_seen": monitor.n_seen,
                })
            except Exception as e:  # noqa: BLE001 — serving boundary
                _snapshot()
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return HTTPServer((host, port), Handler)


def serve(
    monitor: OnlineMonitor,
    host: str = "127.0.0.1",
    port: int = 8787,
    max_requests: Optional[int] = None,
    state_path: Optional[str] = None,
    provenance: Optional[dict] = None,
) -> None:
    """Run the endpoint. ``max_requests`` bounds the loop (tests/demos).

    With ``state_path``, an existing snapshot is restored before serving
    and the bank is re-snapshotted after every state-mutating request —
    restarting the process resumes every stream bit-exactly.

    SIGTERM (the orchestrator's stop signal) drains gracefully: the
    in-flight request finishes (its snapshot included), the listener
    closes, and the process exits 0 — the default signal action would
    kill mid-request without running the ``finally`` cleanup."""
    import signal
    import threading

    if state_path is not None:
        if os.path.exists(
            state_path if state_path.endswith(".npz") else state_path + ".npz"
        ):
            monitor.load_state_bank(state_path)
            print(
                f"restored {len(monitor.streams)} stream(s) from {state_path}"
            )
        # probe writability NOW: a misconfigured path (read-only dir, typo)
        # must fail at startup, not degrade persistence silently per-request
        monitor.save_state_bank(state_path)
    server = make_server(monitor, host, port, state_path=state_path,
                         provenance=provenance)

    def _graceful(signum, frame):
        print("received SIGTERM — draining and shutting down", flush=True)
        # shutdown() must come from another thread: it blocks until the
        # serve_forever loop (this thread, mid-signal) acknowledges
        threading.Thread(target=server.shutdown, daemon=True).start()

    # install BEFORE announcing readiness — an orchestrator may stop the
    # pod the moment the readiness line appears
    old_handler = None
    in_main = threading.current_thread() is threading.main_thread()
    if max_requests is None and in_main:
        old_handler = signal.signal(signal.SIGTERM, _graceful)
    print(f"serving OnlineMonitor on http://{host}:{port} "
          f"(POST /observe, /observe_many, /reset, GET /health, /metrics)",
          flush=True)
    try:
        if max_requests is None:
            server.serve_forever()
        else:
            for _ in range(max_requests):
                server.handle_request()
    finally:
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
        server.server_close()
        print("server closed", flush=True)
