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


# per row, the operations of each λ stage's loss forward (see
# ``lambda_flops_per_row_step``), by stage and, for ``lambda_v``, dnn_para
LAMBDA_FORWARD = {("lambda_v", False): 55, ("lambda_v", True): 56, ("thermal", False): 21,
                  ("hydrogen", False): 19, ("oxygen", False): 26}


def lambda_flops_per_row_step(stage: str, dnn_para: bool = False) -> int:
    """One step of a λ stage for one row: its loss forward from the residual
    equations (reference 01:535-914; ``reference/campaign.py::residuals``), and
    its gradient counted as twice the forward, so three times the forward.
    Each +, −, ×, ÷, exp, log, pow, sqrt, comparison, select and one-sided
    clamp counts one operation (a two-sided clamp two); a product of
    constants is folded and counts nothing; what is the same for every row
    (the λ's alone) counts nothing.  The forward, per row, each total with
    its features:

    - the features an equation reads, de-normalised, (x − min) / scale: 2
      each (voltage: I, p_H2, p_air, T_out, 8; thermal: I, ṁ, T_in, T_out, 8;
      hydrogen: I, Q_H2, 4; oxygen: I, Q_air, 4);
    - voltage (net_f_V, 01:724-765), 50 = 8 + 42: i = I/A + 1e-5 (2); T_K = T_out +
      273.15 (1); T_K^1.334 (1); pp_H2 = 0.5·((p_H2/101 + 1)/exp(1.653·i/T_K^1.334)
      − p_H2O) (8); pp_O2 = (p_air/101 + 1)/exp(4.192·i/T_K^1.334) − p_H2O (7);
      b = R·T_K/(2αF) (1); V_act = −b·log(i/λ1) (4); V_ohm = −i·λ0 (2);
      V_conc = α·b·log(1 − i/λ2) (5); E = c − R·T_K·log(p_H2O/(pp_H2·√pp_O2))/(2F)
      (8); V_est = E + V_act + V_ohm + V_conc (3);
      with dnn_para false, 55 (+ 5): (y − (V_est·5·scale_y + min_y))² (4) and its
      sum into the mean (1); with dnn_para true, 56 (+ 6): the network's
      voltage (u − min)/scale/5 (3), f = V_est − V (1), f² (1), the sum (1);
    - thermal (net_f_T_simple, 01:869-914), 21 = 8 + 13: I/A + 1e-6 (2), ·A (1), ·λ0
      (1), ṁ + 1e-6 (1), ·λ2 (1), 0.5·T_in (1), three sums with λ4 (3),
      f = T_out − T_pred (1), f² (1), the sum (1);
    - hydrogen (net_f_H, 01:621-722), 19 = 4 + 15: I_tot = (I/A + 1e-5)·A (3), Q_th =
      max(I_tot·c, 1e-8) (2), the target where(I_tot ≤ λ2, λ0 + λ1·I_tot/100, ·)
      (5), ratio (Q_H2 + 1e-6)/Q_th (2), f (1), f² (1), the sum (1);
    - oxygen (net_f_O, 01:535-619), 26 = 4 + 22: I_tot (3), Q_th (2), the target (5)
      clamped to [1.05, 15] (2), ratio (Q_air + 1e-6)·0.21/Q_th (3),
      f = ratio − target + max(1 − ratio, 0)·10 (5), f² (1), the sum (1).

    Per row-step: 165 (lambda_v), 168 (lambda_v, dnn_para), 63 (thermal),
    57 (hydrogen), 78 (oxygen)."""
    return 3 * LAMBDA_FORWARD[(stage, bool(dnn_para) if stage == "lambda_v" else False)]


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
