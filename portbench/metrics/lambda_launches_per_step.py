"""``lambda_launches_per_step``: the device operations (kernels, copies,
fills) that start inside the program's λ-stage spans
(``pinnfc.stage.{lambda_v,thermal,hydrogen,oxygen}``), over the traced λ
steps.  A CUDA graph or a fused step shows here first."""

import bisect

from portbench.program_spans import LAMBDA_STAGES


def read(trace, window, run, cell):
    steps = window.counts.get("lambda_steps", 0)
    stages = [h for h in trace.host if h[0] in LAMBDA_STAGES]
    if not steps or not stages or not trace.device:
        return None
    starts = sorted(s for _, s, _ in trace.device)
    ops = sum(bisect.bisect_right(starts, hi) - bisect.bisect_left(starts, lo)
              for _, lo, hi in stages)
    return ops / steps
