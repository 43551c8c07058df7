"""Build the 22-column ``comprehensive_results`` matrix
(counterpart of ``pinnfc_tpu/pipeline/export.py``; reference
``create_comprehensive_results_array_v2``, 01:1877-2010).

MC-dropout statistics (the kernel ``ops/mc_dropout.py`` for the flagship,
the chunked ``torch.Generator`` sampler ``uq/mc_dropout.py`` for any other
topology), de-normalization through the scaler affine constants with the
reference's ``+1e-12`` guards (01:1924-1932), the four physics residuals
(kernel ``ops/residuals.py``) evaluated on the eval-mode prediction,
segment-aware smoothing of the uncertainty channels, and fault labels —
assembled into one (N, 22) float64 array.  On CUDA the kernels run; on CPU
tensors their plain versions.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pinnfc_tpu_torch.data.combine import FuelCellDataset
from pinnfc_tpu_torch.data.contract import ComprehensiveResults
from pinnfc_tpu_torch.models.pinn import PinnParams
from pinnfc_tpu_torch.ops.mc_dropout import mc_dropout
from pinnfc_tpu_torch.ops.residuals import all_residuals_kernel
from pinnfc_tpu_torch.ops.smoothing import smooth_by_segments
from pinnfc_tpu_torch.parallel.mesh import Mesh, data_size
from pinnfc_tpu_torch.uq.mc_dropout import mc_dropout_samples
from pinnfc_tpu_torch.utils.observability import span


def default_mc_seed(seed: int) -> int:
    """The port's MC seed for a training seed: ``RandomState(seed + 1)``'s
    first ``randint(0, 2**31 - 1)``.  (The JAX exporter draws its integer
    from a ``jax.random`` key, which torch cannot reproduce; passing that
    integer as ``mc_seed`` reproduces a flagship JAX export with
    ``sampler='pallas'``.)"""
    return int(np.random.RandomState(seed + 1).randint(0, 2**31 - 1))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@torch.no_grad()
def build_comprehensive_results(
    params: PinnParams,
    dataset: FuelCellDataset,
    mc_seed: int,
    mc_times: int = 2000,
    dropout: float = 0.4,
    smooth_window: int = 200,
    mesh: Optional[Mesh] = None,
) -> Tuple[ComprehensiveResults, Dict[str, object]]:
    """Full exporter (reference 01:1877-2010 + main call 01:2156-2158):
    (artifact, {"sampler", "mc_passes"}).

    The MC sampler is chosen by topology alone, on every device, as the JAX
    exporter's ``sampler='auto'`` takes its Pallas kernel for the flagship
    alone: the flagship runs the MC kernel ('kernel'), whose counter-based
    masks take ``mc_seed`` as their integer seed; any other topology runs
    ``mc_dropout_samples`` ('vmap') with
    ``torch.Generator(device).manual_seed(mc_seed)``, which rounds
    ``mc_times`` up to whole chunks.  ``run_scoring_pipeline`` passes
    ``default_mc_seed(config.seed)``.  The residuals are evaluated on the MC
    base prediction, which is the eval-mode DNN output the reference uses
    (01:1947).

    With ``mesh``, the MC phase (the exporter's dominant cost) runs with the
    rows split over the mesh's ``"data"`` axis (``parallel/ensemble.py::
    mc_dropout_sharded``): for the flagship one MC-kernel launch per row
    shard, whose statistics are the unsharded kernel's bit for bit; the
    residual kernel then runs once on the gathered rows.  The JAX exporter
    refuses its Pallas kernel with a mesh and samples with ``vmap``; the
    port's kernel has no such limit and keeps running.  A data axis of size 1
    takes the unsharded path.
    """
    sx, sy = dataset.scaler_x, dataset.scaler_y
    x_test, mlp = dataset.x_test, params["mlp"]
    n = int(x_test.shape[0])
    with span("export"):  # its phases tile it, in order
        with span("export.mc"):
            if data_size(mesh) > 1:
                from pinnfc_tpu_torch.parallel.ensemble import mc_dropout_sharded

                mc, passes = mc_dropout_sharded(mlp, x_test, int(mc_seed), mesh,
                                                mc_times=mc_times, dropout=dropout)
                export = {"sampler": "kernel" if mlp.is_flagship() else "vmap",
                          "mc_passes": passes}
            elif mlp.is_flagship():
                mc = mc_dropout(mlp, x_test, int(mc_seed), mc_times=mc_times, dropout=dropout)
                export = {"sampler": "kernel", "mc_passes": int(mc_times)}
            else:
                gen = torch.Generator(x_test.device).manual_seed(int(mc_seed))
                mc, passes = mc_dropout_samples(mlp, x_test, gen, mc_times=mc_times,
                                                dropout=dropout)
                export = {"sampler": "vmap", "mc_passes": passes}

        with span("export.residuals"):
            x_real = sx.inverse(x_test)
            y_real = sy.inverse(dataset.y_test)[:, 0]
            # de-normalization through re-derived affine constants with +1e-12
            # guards (01:1920-1932) rather than scaler.inverse
            scale_y, min_y = sy.loss_affine()
            pred_real = (mc.pred_mean - min_y) / (scale_y + 1e-12)
            ale_real = mc.aleatoric_std / (scale_y + 1e-12)
            epi_real = mc.epistemic_std / (scale_y + 1e-12)
            bundle = all_residuals_kernel(params, x_test, mc.pred_mean[:, None], sx, sy)

        with span("export.to_host"):  # the first copy waits for the device
            x_np, y_np, pred_np, ale_np, epi_np = (
                _np(t) for t in (x_real, y_real, pred_real, ale_real, epi_real))
            residuals_np = [_np(t[:, 0]) for t in bundle]

        with span("export.smooth"):
            boundaries = list(dataset.info.boundary_lines)
            if boundaries and boundaries[-1] != n:
                boundaries = boundaries + [n]
            ale_smooth = smooth_by_segments(ale_np, boundaries, smooth_window)
            epi_smooth = smooth_by_segments(epi_np, boundaries, smooth_window)

        with span("export.assemble"):
            out = np.zeros((n, 22), dtype=np.float64)
            out[:, 0:8] = x_np
            out[:, 8] = y_np
            out[:, 9] = pred_np
            out[:, 10] = ale_smooth
            out[:, 11] = epi_smooth
            out[:, 12] = out[:, 8] - out[:, 9]
            # the bundle's fields in order: f_v, f_t, f_h, f_o, v_phys_stack,
            # t_phys, ratio_h, ratio_o
            for col, values in zip((13, 14, 15, 16, 18, 19, 20, 21), residuals_np):
                out[:, col] = values
            out[:, 17] = dataset.info.fault_labels(n)
    return ComprehensiveResults(out), export
