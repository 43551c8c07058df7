"""``stage_edge_ms``: the host edges of a DNN stage, in ms: in each of the
program's spans ``pinnfc.stage.dnn`` (``training/stages.py::run_schedule``),
the time from the start of its ``pinnfc.train_dnn.prep`` (weights into the
kernel layout, allocations) to the first training kernel's start (the launch's
enqueue before it), plus the time from the last training kernel's end to the
span's end (``_stage_out``'s copies, the losses' readback), averaged over the
traced stages.  What runs in the span before ``train_dnn`` starts is left out:
there the benchmark's recorder clones the weights of the call it checks."""

from portbench.program_spans import kernel_extents, spans


def read(trace, window, run, cell):
    preps = [s for _, s, _ in spans(trace, "train_dnn.prep")]
    edges = []
    for lo, hi, first, last in kernel_extents(trace, "stage.dnn"):
        prep = next((s for s in preps if lo <= s <= hi), None)
        if prep is not None:
            edges.append((first - prep) + (hi - last))
    if not edges:
        return None
    return 1e-6 * sum(edges) / len(edges)
