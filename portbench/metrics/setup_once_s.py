"""``setup_once_s``: what the port pays once per process, in s: the sum of
``pinnfc_tpu_torch/ops/build.py::ONCE_S`` after the run (the kernel
library's build where it was missing, its load, each C entry's first launch,
the residual operator's first dispatch), host clock.  Where the residual
operator runs, its first dispatch through ``torch.library`` (the import of
``torch._dynamo``) is almost all of it.  None off the card, where no kernel
is built, loaded or launched."""

from portbench.program_spans import once_s


def read(trace, window, run, cell):
    counters = once_s()
    if run.device.type != "cuda" or counters is None:
        return None
    return sum(counters.values())
