"""The benchmark's own arithmetic of the work a call needs: operations and
bytes of the PINN's MLP, the card's peaks, and the roofline bound of a call.

Counted from the model's shapes alone, whatever kernel implements the call,
so that a later change to the program cannot move the yardstick.  A product
of a (rows, in) activation with an (in, out) weight is 2·rows·in·out
operations; tanh, dropout, the loss and Adam are not counted.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def linears(layers: Sequence[int]) -> List[Tuple[int, int]]:
    """(in, out) of every product of the PINN's MLP: the hidden trunk, the
    mean head, then the variance head h → h/2 → h/4 → out."""
    layers = [int(n) for n in layers]
    h, out = layers[-2], layers[-1]
    trunk = list(zip(layers[:-2], layers[1:-1]))
    return [*trunk, (h, out), (h, h // 2), (h // 2, h // 4), (h // 4, out)]


def param_count(layers: Sequence[int]) -> int:
    """Weights and biases of the MLP."""
    return sum(i * o + o for i, o in linears(layers))


def forward_flops_per_row(layers: Sequence[int]) -> int:
    """One forward pass of one row: 2·Σ in·out (348,800 for the paper's MLP)."""
    return 2 * sum(i * o for i, o in linears(layers))


def train_flops_per_row_step(layers: Sequence[int]) -> int:
    """One training step of one row: the forward, the data gradient and the
    weight gradient of every product, 6·Σ in·out, less layer 0's data
    gradient (2·in·out of the first product), which no step needs:
    1,042,304 for the paper's MLP."""
    i0, o0 = linears(layers)[0]
    return 6 * sum(i * o for i, o in linears(layers)) - 2 * i0 * o0


def mc_call(layers: Sequence[int], rows: int, passes: int) -> Dict[str, float]:
    """Work of one MC-dropout call over ``rows`` rows: one float32 eval pass
    and ``passes`` dropout passes.  Operations by the precision each part may
    run in (the sample passes in bf16; the eval pass float32-accurate, which
    needs at least one TF32 pass), and the bytes of the inputs read once (x,
    the float32 weights) and of the output written once (four float32 sums a
    row)."""
    f = forward_flops_per_row(layers)
    return {"flops_bf16": float(f) * rows * passes, "flops_tf32": float(f) * rows,
            "bytes": 4.0 * (rows * layers[0] + param_count(layers) + 4 * rows)}


def train_stage(layers: Sequence[int], rows: int, steps: int, form: str) -> Dict[str, float]:
    """Work of one DNN stage of ``steps`` full-batch steps over ``rows`` rows:
    the operations in the form's precision (``"bf16"`` or ``"tf32"``, the
    lowest precision the form's contract allows), and the bytes of x, y, the
    weights and both Adam moments read once, and of the weights, the moments
    and one loss per step written once."""
    p = param_count(layers)
    flops = float(train_flops_per_row_step(layers)) * rows * steps
    return {f"flops_{form}": flops,
            "bytes": 4.0 * (rows * (layers[0] + 1) + 6 * p + steps)}


def peaks(device_name: str) -> Dict[str, float]:
    """The card's dense peaks by ``torch.cuda.get_device_name()``: TFLOP/s per
    precision and HBM TB/s.  Raises ``KeyError`` for a card not in the table."""
    table = json.loads(PEAKS_FILE.read_text())["devices"]
    return table[device_name]


def roofline(work: Dict[str, float], peak: Dict[str, float]) -> Tuple[float, str]:
    """(least seconds the card could take, "compute" or "memory"): the
    operations of each precision over that precision's peak, summed, against
    the bytes over the memory bandwidth, whichever is larger."""
    compute = sum(v / (peak[f"{k[len('flops_'):]}_tflops"] * 1e12)
                  for k, v in work.items() if k.startswith("flops_"))
    memory = work.get("bytes", 0.0) / (peak["hbm_tb_s"] * 1e12)
    return (compute, "compute") if compute >= memory else (memory, "memory")
