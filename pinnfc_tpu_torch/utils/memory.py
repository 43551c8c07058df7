"""Device memory of the production steps (counterpart of
``pinnfc_tpu/utils/memory.py``).

The JAX package reads XLA's buffer statistics of each compiled production
program against one TPU's memory.  The port reads what the caching allocator
saw: each step runs once on the card between
``torch.cuda.reset_peak_memory_stats`` and ``torch.cuda.max_memory_allocated``,
and its peak is held against ``torch.cuda.get_device_properties``'s
``total_memory``.  The step set is ``utils/warmup.py::production_lowerings``'s
(the MC step with all of its passes) plus the fleet step, so the footprint
report and the warmer cannot drift apart.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch


def memory_report(run: Callable[[], object], device="cuda") -> Optional[Dict]:
    """Run ``run()`` once on a CUDA ``device`` and return its memory record:
    ``peak_bytes`` (the peak of allocated bytes above what was allocated
    before the step), ``resident_bytes`` (allocated before the step plus that
    peak: what must fit on the card at once) and ``total_bytes`` (the card's
    memory).  None on the CPU, which keeps no allocator statistics (as the JAX
    function returns None where the backend gives no analysis); ``run`` is
    then not called."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    run()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - before
    return {"peak_bytes": int(peak), "resident_bytes": int(before + peak),
            "total_bytes": int(torch.cuda.get_device_properties(dev).total_memory)}


def fleet_step(params, scaler_x, scaler_y, n_streams: int = 64, block: int = 64,
               device="cuda") -> Callable[[], object]:
    """One ``OnlineMonitor.observe_many`` step of ``n_streams`` fresh streams
    of ``block`` rows each, as a callable (the counterpart of
    ``fleet_step_lowering``: the serving-capacity step whose footprint bounds
    how many streams one card carries)."""
    import numpy as np

    from pinnfc_tpu_torch.config import RiskConfig
    from pinnfc_tpu_torch.serving.monitor import OnlineMonitor

    monitor = OnlineMonitor(params, scaler_x, scaler_y, mu=np.zeros(5, np.float32),
                            sigma=np.ones(5, np.float32), config=RiskConfig(), device=device)
    rows = np.random.RandomState(0).uniform(0, 1, (n_streams, block, 8)).astype(np.float32)
    x_bank = scaler_x.inverse(torch.as_tensor(rows, device=device)).cpu().numpy()
    v_bank = np.full((n_streams, block), 60.0, np.float32)
    streams = [f"s{i}" for i in range(n_streams)]
    return lambda: monitor.observe_many(x_bank, v_bank, streams)


def production_memory_report(config, n_normal: int = 6000, n_fault: int = 800, campaign=None,
                             fleet_streams: Optional[int] = 64, block: int = 64,
                             ckpt_path: Optional[str] = None, device="cuda") -> List[Dict]:
    """One memory record per production step at the given campaign scale,
    each with its ``program`` name: the steps of ``production_lowerings`` (a
    step of each stage, whose peak is the stage's; the MC export with all
    ``config.mc_times`` passes; with ``ckpt_path`` the monitor step too) and
    ``monitor_fleet[S<fleet_streams>,b<block>]``.  On the CPU every record is
    ``{"unavailable": True, "program": name}`` and no step runs."""
    from pinnfc_tpu_torch.device import resolve_device
    from pinnfc_tpu_torch.models.pinn import init_pinn
    from pinnfc_tpu_torch.utils.warmup import _dataset_for, production_lowerings

    dev = resolve_device(device)
    dataset = _dataset_for(config, n_normal, n_fault, campaign=campaign, device=dev)
    progs = production_lowerings(config, dataset, ckpt_path=ckpt_path, block=block,
                                 mc_passes=config.mc_times)
    if fleet_streams:
        params = init_pinn(config.model.layers,
                           generator=torch.Generator().manual_seed(config.seed), device=dev)
        progs.append((f"monitor_fleet[S{fleet_streams},b{block}]", fleet_step(
            params, dataset.scaler_x, dataset.scaler_y, fleet_streams, block, dev)))
    out: List[Dict] = []
    for name, run in progs:
        rep = memory_report(run, dev) or {"unavailable": True}
        rep["program"] = name
        out.append(rep)
    return out
