"""Metrics logging, spans and profiling (counterpart of
``pinnfc_tpu/utils/observability.py``): structured metric rows written as
JSONL, the program's named spans, and a ``torch.profiler`` trace in place of
the JAX package's ``jax.profiler`` one.
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

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

SPAN_PREFIX = "pinnfc."
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the host event ``pinnfc.<name>`` while a
    ``torch.profiler`` is open (the benchmark's ``--trace 1``, ``cli train
    --profile-dir``), on the profiler's clock, which the device events share.
    The event is a plain record-function range, not a user annotation
    (``record_function``): it puts nothing on the device timeline, where a
    user annotation would show as busy time.  With no profiler open it costs
    one C call and records nothing.  Under ``torch.autograd.profiler.
    emit_nvtx()`` the range becomes an NVTX range."""
    if not _profiler_enabled():
        return _NO_SPAN
    return _RecordFunctionFast(SPAN_PREFIX + name)


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
