"""Metrics logging, step timing and profiling (counterpart of
``pinnfc_tpu/utils/observability.py``): structured metric rows written as
JSONL, a wall-clock step meter, and a ``torch.profiler`` trace in place of the
JAX package's ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import shutil
import socket
import time
from typing import Dict, List, Optional


class MetricsLogger:
    """Append-only structured metrics (list of dict rows), JSONL-dumpable."""

    def __init__(self):
        self.rows: List[Dict] = []

    def log(self, step: int, **metrics) -> None:
        self.rows.append({"step": step, "time": time.time(), **metrics})

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for row in self.rows:
                # numpy scalars are not JSON-serializable: coerce them
                f.write(json.dumps(row, default=float) + "\n")

    def latest(self) -> Optional[Dict]:
        return self.rows[-1] if self.rows else None


class StepTimer:
    """Wall-clock meter: mean steps per second over recorded windows."""

    def __init__(self):
        self.durations: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.durations.append(time.perf_counter() - self._t0)
        self._t0 = None

    def steps_per_sec(self, steps_per_window: int = 1) -> float:
        if not self.durations:
            return 0.0
        return steps_per_window * len(self.durations) / sum(self.durations)


def trace_profiler():
    """A ``torch.profiler.profile`` over host activity, plus the card's kernels
    when CUDA is available; enter it around the work to trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def write_chrome_trace(prof, log_dir: str) -> str:
    """Write a finished profiler's events as a gzipped Chrome trace
    ``<host>.<pid>.<time>.pt.trace.json.gz`` into ``log_dir``, which
    TensorBoard's profiler plugin and Perfetto read; returns its path.  Every
    op of every λ step is an event, hundreds per step, hence the compression."""
    os.makedirs(log_dir, exist_ok=True)
    name = f"{socket.gethostname() or 'host'}.{os.getpid()}.{int(time.time())}.pt.trace.json"
    path = os.path.join(log_dir, name)
    prof.export_chrome_trace(path)
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb", compresslevel=1) as dst:
        shutil.copyfileobj(src, dst, 1 << 20)
    os.remove(path)
    return path + ".gz"


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Trace the enclosed work (``trace_profiler``) and write it into
    ``log_dir`` on exit (``write_chrome_trace``).  Yields the profiler."""
    if not enabled:
        yield None
        return
    with trace_profiler() as prof:
        yield prof
    write_chrome_trace(prof, log_dir)
