"""``mfu_pct.score``: the whole scoring request's share of the card's dense
bf16 peak, in %: the model's operations (``counts.forward_flops_per_row``,
348,800 a row-pass, × rows × (MC passes + the eval pass) × traced requests)
over the traced window's wall time."""

from portbench import counts


def read(trace, window, run, cell):
    peak = run.peaks()
    requests = window.counts.get("requests", 0)
    if peak is None or not requests or trace.window_s <= 0:
        return None
    flops = (counts.forward_flops_per_row(cell.config["layers"]) * window.counts["rows"]
             * (window.counts["passes"] + 1) * requests)
    return 100.0 * flops / trace.window_s / (peak["bf16_tflops"] * 1e12)
