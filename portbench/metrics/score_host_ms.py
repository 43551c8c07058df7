"""``score_host_ms``: host work per scored campaign, in ms: the wall time of
each traced request (the benchmark's span around ``pipeline/export.py::
build_comprehensive_results``) less the time the device was busy inside it,
averaged over the traced requests."""


def read(trace, window, run, cell):
    return trace.host_ms_per_span(["portbench.score"])
