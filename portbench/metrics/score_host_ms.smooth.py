"""``score_host_ms.smooth``: host work per scored campaign in the export's
segment smoothing (``ops/smoothing.py``, float64 numpy, twice), in ms: the
wall time of the program's span ``pinnfc.export.smooth`` less the device's
busy time inside it, averaged over the traced requests (``pinnfc.export``)."""

from portbench.program_spans import spans


def read(trace, window, run, cell):
    return trace.host_ms_per_span(["pinnfc.export.smooth"], len(spans(trace, "export")))
