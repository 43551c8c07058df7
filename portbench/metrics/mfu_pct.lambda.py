"""``mfu_pct.lambda``: the whole λ step's share of the card's dense bf16
peak, in %: the λ stages' operations over the traced window's wall time.
The operations of a traced call: each λ stage's steps × rows ×
``counts.lambda_flops_per_row_step`` (its loss forward from the residual
equations and the gradient at twice that), and each λ_V stage's eval pass
of the network (``counts.forward_flops_per_row`` × rows)."""

from portbench import counts


def read(trace, window, run, cell):
    peak = run.peaks()
    calls, rows = window.counts.get("calls", 0), window.counts.get("rows", 0)
    if peak is None or not calls or not window.counts.get("lambda_steps") or trace.window_s <= 0:
        return None
    per_row = 0
    for s in cell.traffic["stages"]:
        if s["name"] == "dnn":
            continue
        per_row += int(s["n_iter"]) * counts.lambda_flops_per_row_step(
            s["name"], s.get("dnn_para", False))
        if s["name"] == "lambda_v":
            per_row += counts.forward_flops_per_row(cell.config["layers"])
    return 100.0 * per_row * rows * calls / trace.window_s / (peak["bf16_tflops"] * 1e12)
