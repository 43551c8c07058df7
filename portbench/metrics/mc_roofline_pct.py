"""``mc_roofline_pct``: the MC-dropout kernel (``ops/mc_dropout.py`` →
``csrc/mc_dropout.cu``: ``mc_base_kernel`` and ``mc_sample_kernel``) against
its roofline, in %: the least time the card could take for one request's MC
work (``counts.mc_call``: every row's sample passes at the bf16 peak, its
eval pass at TF32's, against the bytes at HBM bandwidth; compute-bound at
these shapes) over the two kernels' device time per traced request, however
many launches a request takes."""

from portbench import counts

KERNELS = ("mc_base_kernel", "mc_sample_kernel")


def read(trace, window, run, cell):
    peak = run.peaks()
    seconds, launches = trace.device_s(KERNELS)
    requests = window.counts.get("requests", 0)
    if peak is None or launches == 0 or not requests:
        return None
    work = counts.mc_call(cell.config["layers"], window.counts["rows"], window.counts["passes"])
    bound, _ = counts.roofline(work, peak)
    return 100.0 * bound / (seconds / requests)
