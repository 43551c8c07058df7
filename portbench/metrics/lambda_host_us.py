"""``lambda_host_us``: host work per λ step, in us: the wall time of the
program's λ-stage spans (``pinnfc.stage.{lambda_v,thermal,hydrogen,oxygen}``,
``training/stages.py::run_schedule``) less the device's busy time inside
them, over the traced λ steps.  It holds each step's autograd, Adam and
clamp dispatch, and a stage's edges (the λ_V stages' eval forward, the
losses' readback)."""

from portbench.program_spans import LAMBDA_STAGES


def read(trace, window, run, cell):
    ms = trace.host_ms_per_span(LAMBDA_STAGES, window.counts.get("lambda_steps"))
    return None if ms is None else 1e3 * ms
