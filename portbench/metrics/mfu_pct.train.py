"""``mfu_pct.train``: the whole training step's share of the card's dense
bf16 peak, in %, in either form: the step's operations
(``counts.train_flops_per_row_step``, 1,042,304 a row-step, × rows × traced
steps) over the traced window's wall time."""

from portbench import counts


def read(trace, window, run, cell):
    peak = run.peaks()
    steps = window.counts.get("steps", 0)
    if peak is None or not steps or trace.window_s <= 0:
        return None
    flops = counts.train_flops_per_row_step(cell.config["layers"]) * window.counts["rows"] * steps
    return 100.0 * flops / trace.window_s / (peak["bf16_tflops"] * 1e12)
