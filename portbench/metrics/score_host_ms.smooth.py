"""``score_host_ms.smooth``: host work per scored campaign in the export's
segment smoothing (``ops/smoothing.py``, float64 numpy, twice), in ms: the
wall time of the program's span ``pinnfc.export.smooth`` less the device's
busy time inside it, averaged over the traced requests (``pinnfc.export``)."""

from portbench.program_spans import host_ms_per


def read(trace, window, run, cell):
    return host_ms_per(trace, ["export.smooth"], "export")
