"""``train_roofline_pct.tf32x3``: the training kernel's float32-accurate form
(``csrc/train_dnn.cu``: ``fwd_bwd_kernel``, ``wgrad_kernel``,
``finalize_kernel``, ``adam_kernel``) against its roofline, in %: the least
time the card could take for a step (``counts.train_stage`` at the TF32 peak,
the lowest precision a float32-accurate step allows, against the bytes at HBM
bandwidth; compute-bound) over the form's device time per step.  Silent
without ``fwd_bwd_kernel`` on the path."""

from portbench import counts

KERNELS = ("fwd_bwd_kernel", "wgrad_kernel", "finalize_kernel", "adam_kernel")


def read(trace, window, run, cell):
    peak = run.peaks()
    steps = window.counts.get("steps", 0)
    _, main = trace.device_s(("fwd_bwd_kernel",))
    if peak is None or not steps or main == 0:
        return None
    seconds, _ = trace.device_s(KERNELS)
    work = counts.train_stage(cell.config["layers"], window.counts["rows"], steps, "tf32")
    bound, _ = counts.roofline(work, peak)
    return 100.0 * bound / seconds
