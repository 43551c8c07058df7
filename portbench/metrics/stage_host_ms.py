"""``stage_host_ms``: host work per training stage, in ms: the wall time of
each traced ``training/stages.py::run_schedule`` call (the benchmark's span
around it) less the time the device was busy inside it, over the stages of
the traced calls."""


def read(trace, window, run, cell):
    return trace.host_ms_per_span(["portbench.run_schedule"], window.counts.get("stages"))
