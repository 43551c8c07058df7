"""The benchmark of ``pinnfc_tpu_torch`` on the card: one cell, one run.

A cell (``workloads/<cell>.json``) names a configuration (``configs/<config>.json``),
a traffic kind (``traffic/<kind>.py``) with its parameters, and its limits.
The harness finds every piece by its name: the traffic module by the cell's
``traffic``, each per-layer metric's reader in ``metrics/<metric>.py``, and the
metrics a cell reports in ``BENCHMARK.json``.  A traffic module has three
functions:

- ``setup(run)``: make the inputs and weights from the seed, warm up every
  shape the window uses; returns its state;
- ``window(state, run)``: drive the port for ``run.seconds`` (or at least
  ``run.min_requests`` requests), timing by the host clock around calls that
  end in host reads, and opening ``run.tracer`` around the traced part;
  returns a ``Window``;
- ``check(state, run)``: once the window has closed, compare what the timed
  path produced with the plain reference (``reference/``); returns the
  ``Check``s, each number beside its limit.

``run.control`` puts the reference, in the precision below the one the
configuration states, in the program's place (the control of ``correct``).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import importlib.util
import json
import math
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names the run may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "pinnfc_tpu")
SPAN_PREFIX = "portbench."
WINDOW_SPAN = "portbench.window"


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def forbidden_modules(names: Sequence[str]) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``pinnfc_tpu_torch`` is not ``pinnfc_tpu``."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def derived_seeds(seed: int, stream: str, n: int) -> List[int]:
    """``n`` seeds in [0, 2**31) of the named stream, from the run's seed (any
    whole number)."""
    tag = int.from_bytes(stream.encode(), "little")
    words = np.random.SeedSequence([int(seed) & (2**64 - 1), int(seed) >> 64, tag]
                                   ).generate_state(n, np.uint32)
    return [int(w) & 0x7FFFFFFF for w in words]


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    benchmark: Dict[str, Any]

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.workload["params"]

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]

    def metrics(self, kind: str) -> List[Dict[str, Any]]:
        """The cell's end-to-end metrics (``kind`` "end_to_end") or per-layer
        metrics ("per_layer"), as ``BENCHMARK.json`` assigns them."""
        e2e = [m for m in self.benchmark["end_to_end"]
               if "workloads" not in m or self.name in m["workloads"]]
        if kind == "end_to_end":
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.benchmark["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def load_cell(name: str) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    workload = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    config = load_json(BENCH_DIR / "configs" / f"{workload['config']}.json")
    return Cell(name, workload, config, bench)


# --- tracing -------------------------------------------------------------


@dataclasses.dataclass
class Trace:
    """What the profiler saw in the traced window, in ns of its clock:
    device operations (name, start, end), host events (name, start, end),
    and the benchmark's own spans (name, start, end)."""

    window: Tuple[int, int]
    device: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int]]
    spans: List[Tuple[str, int, int]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @functools.cached_property
    def _busy(self) -> Tuple[List[int], List[int]]:
        """(starts, ends) of the union of the device operations' intervals."""
        starts: List[int] = []
        ends: List[int] = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if ends and s <= ends[-1]:
                ends[-1] = max(ends[-1], e)
            else:
                starts.append(s)
                ends.append(e)
        return starts, ends

    def busy_intervals(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, clipped to [lo, hi]."""
        starts, ends = self._busy
        out = []
        i = bisect.bisect_right(ends, lo)
        while i < len(starts) and starts[i] < hi:
            out.append((max(starts[i], lo), min(ends[i], hi)))
            i += 1
        return out

    def busy_s(self, lo: Optional[int] = None, hi: Optional[int] = None) -> float:
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return sum(e - s for s, e in self.busy_intervals(lo, hi)) * 1e-9

    def host_ms_per_span(self, names: Sequence[str], per: Optional[float] = None
                         ) -> Optional[float]:
        """The wall time of the host events named ``names`` (the benchmark's
        spans ``portbench.*`` or the program's ``pinnfc.*``) less the device's
        busy time inside them, summed, in ms, over ``per`` (a count of
        requests, stages or steps; by default the number of those events).
        None where there is no such event or nothing to divide by, or where
        the trace holds no device operation: without the card's timeline
        there is no host part to split."""
        found = [h for n in names for h in sorted((h for h in self.host if h[0] == n),
                                                   key=lambda h: h[1])]
        count = len(found) if per is None else per
        if not found or not count or not self.device:
            return None
        return 1e3 * sum((e - s) * 1e-9 - self.busy_s(s, e) for _, s, e in found) / count

    def device_s(self, names: Sequence[str]) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name contains one
        of ``names`` (kernels' names as the profiler shows them)."""
        hits = [(s, e) for n, s, e in self.device if any(k in n for k in names)]
        return sum(e - s for s, e in hits) * 1e-9, len(hits)

    def idle_pct(self) -> Optional[float]:
        """The share of the window in which no operation ran on the device, in
        % (None where the trace holds no device operation: no card)."""
        if not self.device or self.window[1] <= self.window[0]:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def breakdown(self, top: int = 10) -> Dict[str, List[List[Any]]]:
        """The device operations that took most time, and the device's idle
        time by what the host was doing (the innermost host event over the
        middle of each gap), each with at most ``top`` entries."""
        ops: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            ops[short_name(n)] += (e - s) * 1e-9
        busy = self.busy_intervals(*self.window)
        edges = [self.window[0]] + [t for iv in busy for t in iv] + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host, key=lambda h: h[1])
        idle: Dict[str, float] = defaultdict(float)
        open_: List[Tuple[str, int, int]] = []
        j = 0
        for s, e in gaps:
            mid = (s + e) // 2
            while j < len(host) and host[j][1] <= mid:
                open_.append(host[j])
                j += 1
            open_ = [h for h in open_ if h[2] >= mid]
            name = max(open_, key=lambda h: h[1])[0] if open_ else "(no host event)"
            idle[short_name(name)] += (e - s) * 1e-9
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def short_name(name: str) -> str:
    """A kernel's or host event's name without its return type, anonymous
    namespace and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    head = name.split("(", 1)[0].strip()
    return (head or name)[:120]


class Tracer:
    """``torch.profiler`` (CPU and CUDA activities) over the traced part of the
    window, opened and closed by the traffic module; spans are
    ``record_function`` ranges that exist only while it is open.  The events
    are read in memory when it closes; no trace file is written."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.trace: Optional[Trace] = None
        self._prof = None
        self._window = None

    def open(self) -> None:
        if not self.enabled or self.active or self.trace is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW_SPAN)
        self._window.__enter__()
        self.active = True

    def close(self) -> None:
        if not self.active:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        self.trace = read_events(self._prof.profiler.kineto_results.events())
        self._prof = None

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)


def read_events(events) -> Trace:
    device, host, spans = [], [], []
    window = None
    for ev in events:
        name = ev.name()
        start = int(ev.start_ns())
        end = start + int(ev.duration_ns())
        if str(ev.device_type()).endswith("CUDA"):
            # a record_function range shows on the device too: not an operation
            if not name.startswith(SPAN_PREFIX):
                device.append((name, start, end))
        elif name == WINDOW_SPAN:
            window = (start, end)
        elif name.startswith(SPAN_PREFIX):
            spans.append((name, start, end))
            host.append((name, start, end))
        else:
            host.append((name, start, end))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return Trace(window, device, host, spans)


# --- a run -----------------------------------------------------------------


@dataclasses.dataclass
class Window:
    """What a traffic module's window reports: the end-to-end metrics it
    measured, requests attempted and failed, and the counts the per-layer
    readers use (rows, passes, steps, ... of the traced part)."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """One run of one cell: its parameters and the helpers a traffic module uses."""

    cell: Cell
    seed: int
    seconds: float
    device: Any  # torch.device
    tracer: Tracer
    control: bool = False
    min_requests: int = 1

    def seeds(self, stream: str, n: int) -> List[int]:
        return derived_seeds(self.seed, stream, n)

    def stated(self, key: str) -> str:
        """The precision the configuration states under ``key``, as the port
        computes it on this device: on the CPU every product of the port is
        float32."""
        return self.cell.config[key] if self.device.type == "cuda" else "float32"

    def reference_rounding(self, key: str):
        """The reference's rounding of the products under ``key``: the
        stated precision, as the port computes it on this device."""
        from portbench.reference.rounding import rounding

        return rounding(self.stated(key))

    def control_rounding(self, key: str):
        """The control's rounding: the precision below the one the
        configuration states under ``key``."""
        from portbench.reference.rounding import CONTROL_OF, rounding

        return rounding(CONTROL_OF[self.cell.config[key]])

    def make_weights(self):
        """The MLP's weights and biases, (W (out, in), b) per layer in the order
        hidden trunk, mean head, variance head, drawn on the device from the
        seed in one call: U(±1/√fan_in), as ``torch.nn.Linear`` draws them."""
        import torch

        from portbench.counts import linears

        shapes = linears(self.cell.config["layers"])
        total = sum(i * o + o for i, o in shapes)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seeds("weights", 1)[0])
        flat = torch.empty(total, dtype=torch.float32, device=self.device)
        flat.uniform_(-1.0, 1.0, generator=gen)
        out, off = [], 0
        for i, o in shapes:
            bound = 1.0 / math.sqrt(i)
            w = flat[off:off + i * o].view(o, i) * bound
            b = flat[off + i * o:off + i * o + o] * bound
            out.append((w, b))
            off += i * o + o
        return out

    def peaks(self) -> Optional[Dict[str, float]]:
        """The card's peaks (``counts/peaks.json``); None off the card or for a
        card the table lacks."""
        if self.device.type != "cuda":
            return None
        import torch

        from portbench import counts

        try:
            return counts.peaks(torch.cuda.get_device_name(self.device))
        except KeyError:
            return None

    def lambdas(self) -> Dict[str, List[float]]:
        """The physics λ's of the configuration, as float32 values."""
        return {k: [float(np.float32(v)) for v in vals]
                for k, vals in self.cell.config["lambda_init"].items()}

    def port_params(self, weights):
        """The port's params set holding ``weights`` and the λ's."""
        import torch

        from pinnfc_tpu_torch.models.pinn import init_pinn

        params = init_pinn(tuple(self.cell.config["layers"]), device=self.device)
        with torch.no_grad():
            for lin, (w, b) in zip(params["mlp"].linears(), weights):
                lin.weight.copy_(w)
                lin.bias.copy_(b)
        for k, vals in self.lambdas().items():
            params[k] = torch.tensor(vals, dtype=torch.float32, device=self.device)
        return params


def _module_name(prefix: str, name: str) -> str:
    return prefix + name.replace(".", "_").replace("-", "_")


def traffic_module(kind: str):
    return load_module(BENCH_DIR / "traffic" / f"{kind}.py", _module_name("portbench_traffic_", kind))


def metric_reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", _module_name("portbench_metric_", name))


def device_info(device, chips: int) -> Dict[str, Any]:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", control: bool = False,
             cell: Optional[Cell] = None) -> Dict[str, Any]:
    """Run one cell once and return the result line's object (``checks``
    last).  ``t_start``: the host clock when the process started."""
    import torch

    cell = cell or load_cell(name)
    dev = torch.device(device)
    tracer = Tracer(trace)
    run = Run(cell, seed, seconds, dev, tracer, control,
              int(cell.traffic.get("min_requests", 1)))
    traffic = traffic_module(cell.workload["traffic"])
    state = traffic.setup(run)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    win = traffic.window(state, run)
    tracer.close()
    info = device_info(dev, int(cell.workload["chips"]))
    metrics: Dict[str, Dict[str, Any]] = {}
    breakdown = None
    if trace:
        tr = tracer.trace
        if tr is not None:
            info["busy_s"] = tr.busy_s()
            info["window_s"] = tr.window_s
            breakdown = tr.breakdown()
        for m in cell.metrics("per_layer"):
            value = (metric_reader(m["name"]).read(tr, win, run, cell)
                     if tr is not None else None)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        measured = dict(win.metrics, setup_s=setup_s)
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": float(measured[m["name"]]), "unit": m["unit"]}
    checks = traffic.check(state, run)
    correct = all(c.ok for c in checks) and win.attempted > 0
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": int(win.attempted),
                           "failed": int(win.failed), "metrics": metrics, "device": info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out


def check_lines(result: Dict[str, Any]) -> List[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in result["checks"].items()]


def main(argv: Sequence[str], t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell of pinnfc_tpu_torch once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    chips = int(cell.workload["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start,
                      cell=cell)
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"portbench: the run loaded forbidden modules: {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

