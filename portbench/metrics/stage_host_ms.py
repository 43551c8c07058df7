"""``stage_host_ms``: host work per training stage, in ms: the wall time of
each traced ``training/stages.py::run_schedule`` call (the benchmark's span
around it) less the time the device was busy inside it, over the stages of
the call."""


def read(trace, window, run, cell):
    spans = trace.spans_named("portbench.run_schedule")
    per_call = trace.host_ms_per_span("portbench.run_schedule")
    if not spans or not window.counts.get("stages"):
        return None
    return per_call * len(spans) / window.counts["stages"]
