"""``train_gap_us``: the device's idle time between the training kernel's
launches, per step, in us: in each of the program's spans ``pinnfc.stage.dnn``
(``training/stages.py::run_schedule``), the time between the first and the
last operation of a kernel of ``csrc/train_dnn.cu`` (``TRAIN_KERNELS``) in
which no operation ran on the device, summed over the traced stages, over
the traced steps."""

from portbench.program_spans import kernel_extents


def read(trace, window, run, cell):
    stages = kernel_extents(trace, "stage.dnn")
    steps = window.counts.get("steps", 0)
    if not stages or not steps:
        return None
    idle = sum((last - first) * 1e-9 - trace.busy_s(first, last)
               for _, _, first, last in stages)
    return 1e6 * idle / steps
