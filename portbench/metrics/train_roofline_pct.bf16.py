"""``train_roofline_pct.bf16``: the training kernel's bf16 form
(``csrc/train_dnn.cu``: ``bf16_weights_kernel``, ``fwd_bwd_bf16_kernel``,
``wgrad_bf16_kernel``, ``finalize_kernel``, ``adam_kernel``) against its
roofline, in %: the least time the card could take for a step
(``counts.train_stage`` at the bf16 peak, against the bytes at HBM bandwidth;
compute-bound) over the form's device time per step.  Silent without
``fwd_bwd_bf16_kernel`` on the path."""

from portbench import counts

KERNELS = ("bf16_weights_kernel", "fwd_bwd_bf16_kernel", "wgrad_bf16_kernel",
           "finalize_kernel", "adam_kernel")


def read(trace, window, run, cell):
    peak = run.peaks()
    steps = window.counts.get("steps", 0)
    _, main = trace.device_s(("fwd_bwd_bf16_kernel",))
    if peak is None or not steps or main == 0:
        return None
    seconds, _ = trace.device_s(KERNELS)
    work = counts.train_stage(cell.config["layers"], window.counts["rows"], steps, "bf16")
    bound, _ = counts.roofline(work, peak)
    return 100.0 * bound / seconds
