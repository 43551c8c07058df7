"""Synthetic 5-cell PEM stack campaigns: the benchmark's own frozen copy of
the port's generator (``pinnfc_tpu_torch/data/synthetic.py``), so that a
later change to the program cannot change the traffic.

The reference's measurement data lives on Zenodo (DOI 10.5281/zenodo.17905711)
and is NOT in the repo (``.MISSING_LARGE_BLOBS``), so the framework ships a
physically-grounded generator shaped like ``README_DATA.docx`` describes:
a 270 cm² active-area, 5-cell stack sampled at 1 Hz, with normal operation
(polarization sweeps + dynamic load) and 4 single faults × 3 current levels
(0.4 / 1.0 / 1.5 A/cm² → 108 / 270 / 405 A).

Voltage is generated from the same electrochemical polarization model the
PINN identifies (reference net_f_V, 01:724-765) evaluated at the reference's
initial parameter values (01:453-456), plus measurement noise — so staged
training has a recoverable ground truth.  Fault segments ramp a severity
factor 0 → 1 over the segment with characteristic channel signatures:

- 水淹 (flooding):          mass-transport loss ↑ (effective i_l ↓), V ↓
- 氧饥饿 (O₂ starvation):   air flow ↓ → O₂ excess ratio ↓, V ↓
- 膜干 (membrane drying):   ohmic resistance ↑ → V ↓ ∝ i, T_out ↑
- 氢饥饿 (H₂ starvation):   H₂ flow ↓ → H₂ excess ratio ↓, V ↓
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# Physical constants of the stack (reference 01:729-750).
A_CELL = 270.0  # cm²
N_CELLS = 5.0
F_CONST = 96485.0
R_GAS = 8.314
GF_LIQ = -220170.0
ALPHA = 0.5
TC_REF = 55.0

# Reference initial physics parameters (01:453-456).
R_OHMIC = 0.167897923477715
I0_EXCHANGE = 2.36682075851268e-06
I_LIMIT = 2.43414469188443

FAULT_TYPES = ("水淹", "氧饥饿", "膜干", "氢饥饿")
FAULT_CURRENTS = (108.0, 270.0, 405.0)


def _saturation_pressure() -> float:
    x = -2.1794 + 0.02953 * TC_REF - 9.1837e-5 * TC_REF**2 + 1.4454e-7 * TC_REF**3
    return 10.0**x


def stack_voltage(
    current: np.ndarray,
    t_out: np.ndarray,
    p_h2_kpa: np.ndarray,
    p_air_kpa: np.ndarray,
    r_extra: np.ndarray | float = 0.0,
    il_scale: np.ndarray | float = 1.0,
) -> np.ndarray:
    """Polarization model (same form as reference net_f_V, 01:743-762)."""
    i = current / A_CELL + 1e-5
    tk = t_out + 273.15
    p_h2 = p_h2_kpa / 101.0 + 1.0
    p_air = p_air_kpa / 101.0 + 1.0
    p_h2o = _saturation_pressure()
    pp_h2 = 0.5 * (p_h2 / np.exp(1.653 * i / tk**1.334) - p_h2o)
    pp_o2 = p_air / np.exp(4.192 * i / tk**1.334) - p_h2o
    b = R_GAS * tk / (2.0 * ALPHA * F_CONST)
    il = I_LIMIT * il_scale
    v_act = -b * np.log(i / I0_EXCHANGE)
    v_ohm = -i * (R_OHMIC + r_extra)
    v_conc = ALPHA * b * np.log(np.clip(1.0 - i / il, 1e-6, None))
    e_nernst = -GF_LIQ / (2 * F_CONST) - (R_GAS * tk) * np.log(
        p_h2o / (pp_h2 * pp_o2**0.5)
    ) / (2 * F_CONST)
    return N_CELLS * (e_nernst + v_act + v_ohm + v_conc)


def _channels_for_current(current: np.ndarray, rng: np.random.RandomState):
    """Nominal balance-of-plant channels given stack current [A]."""
    n = len(current)
    # Faraday-law flows with nominal excess ratios (slpm).
    q_h2_theory = current * N_CELLS / (2 * F_CONST) * 22.4 * 60.0
    q_o2_theory = current * N_CELLS / (4 * F_CONST) * 22.4 * 60.0
    h2_ratio = np.clip(1.6 - 0.1 * current / 100.0, 1.2, None)
    o2_ratio = np.clip(2.3 - 0.2 * current / 100.0, 1.6, None)
    h2_flow = q_h2_theory * h2_ratio * (1 + 0.01 * rng.randn(n))
    air_flow = q_o2_theory * o2_ratio / 0.21 * (1 + 0.01 * rng.randn(n))

    coolant_flow = 0.15 + 6e-4 * current + 0.002 * rng.randn(n)
    t_in = 62.0 + 0.15 * rng.randn(n)
    t_out = t_in + 2.0 + 0.012 * current + 0.15 * rng.randn(n)
    p_h2 = 55.0 + 0.05 * current + 0.5 * rng.randn(n)
    p_air = 45.0 + 0.04 * current + 0.5 * rng.randn(n)
    return coolant_flow, t_in, p_h2, p_air, t_out, h2_flow, air_flow


def _assemble(current, rng, fault: str | None = None, severity=None):
    """Build (X (N,8), Y (N,1)) with optional fault signature."""
    n = len(current)
    coolant_flow, t_in, p_h2, p_air, t_out, h2_flow, air_flow = _channels_for_current(
        current, rng
    )
    r_extra = np.zeros(n)
    il_scale = np.ones(n)
    v_offset = np.zeros(n)
    if fault is not None:
        s = severity
        if fault == "水淹":  # flooding: mass-transport limit collapses
            il_scale = 1.0 - 0.45 * s
            v_offset = -s * (0.06 + 0.08 * current / A_CELL)
            t_out = t_out + 0.8 * s
        elif fault == "氧饥饿":  # oxygen starvation: air flow starves
            air_flow = air_flow * (1.0 - 0.45 * s)
            v_offset = -0.35 * s * (current / A_CELL)
        elif fault == "膜干":  # membrane drying: ohmic resistance rises
            r_extra = 0.22 * s
            t_out = t_out + 1.5 * s
        elif fault == "氢饥饿":  # hydrogen starvation: H2 flow starves
            h2_flow = h2_flow * (1.0 - 0.40 * s)
            v_offset = -0.30 * s * (current / A_CELL)
        else:
            raise ValueError(f"unknown fault type {fault}")

    x = np.column_stack(
        [current, coolant_flow, t_in, p_h2, p_air, t_out, h2_flow, air_flow]
    )
    y = stack_voltage(current, t_out, p_h2, p_air, r_extra, il_scale)
    y = y + N_CELLS * v_offset + 0.004 * rng.randn(n)
    return x, y.reshape(-1, 1)


def synthesize_stack_data(
    n_normal: int = 6000,
    n_fault: int = 800,
    seed: int = 0,
) -> Tuple[Tuple[np.ndarray, np.ndarray], List[Tuple[np.ndarray, np.ndarray, str]]]:
    """Generate (normal_data, fault_data_list) shaped like the reference
    loader output (01:2091-2126): 1 normal set + 12 fault segments in the
    load order 水淹/氧饥饿/膜干/氢饥饿 × 108/270/405 A (01:2097-2110)."""
    rng = np.random.RandomState(seed)

    # Normal operation: polarization staircase sweeps + dwell segments,
    # clipped inside the loader's 50 < I < 800 filter window (01:143).
    # Sweep up to ~0.5 A/cm² below the limiting current density i_l·A ≈ 657 A
    # so healthy polarization stays off the concentration-loss cliff.
    steps = np.linspace(60.0, 500.0, 16)
    profile = []
    per = max(n_normal // (2 * len(steps)), 4)
    for s in steps:
        profile.append(np.full(per, s))
    for s in steps[::-1]:
        profile.append(np.full(per, s))
    current = np.concatenate(profile)[:n_normal]
    if len(current) < n_normal:
        current = np.pad(current, (0, n_normal - len(current)), mode="edge")
    current = current + 2.0 * rng.randn(n_normal)
    current = np.clip(current, 55.0, 795.0)
    normal = _assemble(current, rng)

    fault_list = []
    for fault in FAULT_TYPES:
        for amps in FAULT_CURRENTS:
            i_seg = amps + 0.15 * rng.randn(n_fault)  # within ±0.5 A tol (04:133)
            # severity: healthy dwell, then smooth ramp to full fault
            t = np.linspace(0.0, 1.0, n_fault)
            sev = np.clip((t - 0.2) / 0.6, 0.0, 1.0) ** 1.5
            x, y = _assemble(i_seg, rng, fault=fault, severity=sev)
            fault_list.append((x, y, f"{fault}故障({int(amps)}A)"))
    return normal, fault_list
