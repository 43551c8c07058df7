"""``score_host_ms.mc``: host work per scored campaign in the MC phase of the
export, in ms: the wall time of the program's span ``pinnfc.export.mc``
(``pipeline/export.py``: the MC wrapper's weight copies and the kernel's
launch, ``ops/mc_dropout.py``, up to its return) less the device's busy
time inside it, averaged over the traced requests (``pinnfc.export``)."""

from portbench.program_spans import spans


def read(trace, window, run, cell):
    return trace.host_ms_per_span(["pinnfc.export.mc"], len(spans(trace, "export")))
