"""``score_host_ms.assemble``: host work per scored campaign in the export's
copies to the host and its 22-column assembly (``pipeline/export.py``), in
ms: the wall time of the program's spans ``pinnfc.export.to_host`` and
``pinnfc.export.assemble`` less the device's busy time inside them (the
first copy waits for the MC kernel: that wait is busy time), averaged over
the traced requests (``pinnfc.export``)."""

from portbench.program_spans import spans


def read(trace, window, run, cell):
    return trace.host_ms_per_span(["pinnfc.export.to_host", "pinnfc.export.assemble"],
                                  len(spans(trace, "export")))
