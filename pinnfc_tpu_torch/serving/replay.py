"""Streaming fleet replay of the reference's 12 risk-evaluation conditions
(counterpart of ``pinnfc_tpu/serving/replay.py``).

Script 04 evaluates 12 (current, fault) conditions offline, one at a time
(04:145-161, pipeline 04:479-528).  A deployed scorer faces them live and
concurrently: this module replays every condition as an independent stream of
one ``OnlineMonitor``, advancing the fleet in lockstep blocks through
``observe_many`` (one step, one residual-kernel launch on the card, per poll;
one per shard on a sharded monitor).

Each stream starts at its condition's first row, so the dynamic voltage
baseline V(0) − voltage_drop and the C[0] = 0 gating match the offline
table's semantics (04:262, 04:389); the rows are those of
``risk.condition_row_indices``.  The monitor recomputes the residuals from the
raw measurements through the model, where the offline table reads the
artifact's exported columns.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from pinnfc_tpu_torch.config import DEFAULT_RF_CONDITIONS
from pinnfc_tpu_torch.data.contract import INDEX, ComprehensiveResults
from pinnfc_tpu_torch.risk.rf import condition_row_indices


class FleetConditionResult(NamedTuple):
    """Per-condition outcome of a streaming fleet replay."""

    stream: str
    fault_name: str
    current_target: float
    n_samples: int
    first_warn: Optional[int]  # sample index within the stream
    first_danger: Optional[int]
    first_v_alarm: Optional[int]
    advance: Optional[int]  # v_alarm − warn (positive: RF warned earlier)
    layer_shares: Dict[str, float]  # C_l composition at first warn (or end)


def _record_block(out, pos: int, first: dict, shares_holder: list) -> None:
    """Fold one observed block into a stream's first-alarm bookkeeping."""
    for name, flags in (("warn", out.warn), ("danger", out.danger), ("v_alarm", out.v_alarm)):
        if first[name] is None and flags.any():
            first[name] = pos + int(np.argmax(flags))
    # the λ-decay attribution read off the carried per-layer integral: at the
    # first warn when one fires, else the latest composition
    anchor = (int(np.argmax(out.warn)) if (shares_holder[0] is None and out.warn.any())
              else len(out.warn) - 1)
    row = np.asarray(out.layer_c)[anchor]
    if shares_holder[0] is None and out.warn.any():
        if np.isfinite(row).all() and row.sum() > 0:
            shares_holder[0] = row / row.sum()
    elif shares_holder[0] is None:
        shares_holder[1] = row  # running fallback (never warned)


def fleet_replay(
    monitor,
    results,
    conditions=DEFAULT_RF_CONDITIONS,
    block: int = 256,
) -> List[FleetConditionResult]:
    """Replay every (current, fault) condition as a concurrent stream.

    Each lockstep round advances the still-active streams: all streams with a
    full ``block`` remaining go through one ``observe_many`` call; a stream's
    final partial block (and a lone full-block stream) goes through
    ``observe`` — at most one partial call per stream over the replay.
    Stream keys are ``"<fault>@<current>A"`` and land in the monitor's state
    bank like any other stream.  A monitor built with a mesh
    (``OnlineMonitor(mesh=)``) splits each ``observe_many`` round's streams
    over the mesh's data axis; the table is the unsharded one's up to float32
    rounding of the forward."""
    arr = results.array if isinstance(results, ComprehensiveResults) else np.asarray(results)
    cfg = monitor.config

    rows: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    meta: Dict[str, Tuple[str, float]] = {}
    for current_target, fault_name, index_range in conditions:
        idx = condition_row_indices(arr, fault_name, current_target, cfg, index_range)
        if idx is None:
            continue
        key = f"{fault_name}@{current_target:g}A"
        rows[key] = (arr[idx, 0:8].astype(np.float32),
                     arr[idx, INDEX["y_true"]].astype(np.float32))
        meta[key] = (fault_name, current_target)

    streams = list(rows)
    pos = {s: 0 for s in streams}
    first = {s: {"warn": None, "danger": None, "v_alarm": None} for s in streams}
    # [warn-anchored shares or None, latest composition row] per stream
    shares = {s: [None, None] for s in streams}

    while True:
        active = [s for s in streams if pos[s] < len(rows[s][0])]
        if not active:
            break
        full = [s for s in active if len(rows[s][0]) - pos[s] >= block]
        outs = {}
        if len(full) >= 2:
            outs.update(monitor.observe_many(
                np.stack([rows[s][0][pos[s]: pos[s] + block] for s in full]),
                np.stack([rows[s][1][pos[s]: pos[s] + block] for s in full]),
                full,
            ))
        elif full:
            s = full[0]
            outs[s] = monitor.observe(rows[s][0][pos[s]: pos[s] + block],
                                      rows[s][1][pos[s]: pos[s] + block], stream=s)
        for s in active:
            if s in full:
                continue  # partial final block: finish the stream now
            outs[s] = monitor.observe(rows[s][0][pos[s]:], rows[s][1][pos[s]:], stream=s)
        for s, out in outs.items():
            _record_block(out, pos[s], first[s], shares[s])
            pos[s] += len(out.rf_smooth)

    out: List[FleetConditionResult] = []
    for s in streams:
        fault_name, current_target = meta[s]
        f = first[s]
        adv = (f["v_alarm"] - f["warn"]
               if f["v_alarm"] is not None and f["warn"] is not None else None)
        comp = shares[s][0]
        if comp is None:
            row = shares[s][1]
            comp = (row / row.sum()
                    if row is not None and np.isfinite(row).all() and row.sum() > 0 else None)
        layer_shares = (dict(zip(monitor.layer_names, (float(v) for v in comp)))
                        if comp is not None else {})
        out.append(FleetConditionResult(
            stream=s, fault_name=fault_name, current_target=current_target, n_samples=pos[s],
            first_warn=f["warn"], first_danger=f["danger"], first_v_alarm=f["v_alarm"],
            advance=adv, layer_shares=layer_shares))
    return out
