"""What the per-layer readers take from the program's own spans and counters.

The port records its spans as host events named ``pinnfc.<name>``
(``pinnfc_tpu_torch/utils/observability.py::span``): they land in
``Trace.host``, not in ``Trace.spans``, which holds the benchmark's own.  The
port's one-time costs are ``pinnfc_tpu_torch/ops/build.py::ONCE_S``.  A
program without them (an older commit) gives the readers nothing: every
helper returns None there, and raises nothing.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.harness import metric_reader

PREFIX = "pinnfc."
# the spans of run_schedule's λ stages, one a stage
LAMBDA_STAGES = tuple(f"{PREFIX}stage.{n}" for n in ("lambda_v", "thermal", "hydrogen", "oxygen"))
# the step's kernels of csrc/train_dnn.cu in both forms, as the training
# rooflines list them
TRAIN_KERNELS = tuple(dict.fromkeys(metric_reader("train_roofline_pct.bf16").KERNELS
                                    + metric_reader("train_roofline_pct.tf32x3").KERNELS))


def spans(trace, name: str) -> List[Tuple[str, int, int]]:
    """The program's spans ``pinnfc.<name>``, by start."""
    return sorted((h for h in trace.host if h[0] == PREFIX + name), key=lambda h: h[1])


def kernel_extents(trace, name: str,
                   kernels: Sequence[str] = TRAIN_KERNELS) -> List[Tuple[int, int, int, int]]:
    """For each span ``name`` that holds a device operation of ``kernels``
    (a name containing one of them) starting inside it: (span start, span end,
    first such operation's start, last one's end)."""
    ops = sorted((s, e) for n, s, e in trace.device if any(k in n for k in kernels))
    out = []
    for _, lo, hi in spans(trace, name):
        inside = [(s, e) for s, e in ops if lo <= s <= hi]
        if inside:
            out.append((lo, hi, inside[0][0], max(e for _, e in inside)))
    return out


def once_s() -> Optional[Dict[str, float]]:
    """A copy of the port's ``ONCE_S`` as this process left it; None where the
    port has no such counter or it is empty."""
    build = sys.modules.get("pinnfc_tpu_torch.ops.build")
    counters = getattr(build, "ONCE_S", None)
    return dict(counters) if counters else None
