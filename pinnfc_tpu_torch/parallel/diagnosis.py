"""Row-sharded diagnosis fits over a mesh (counterpart of
``pinnfc_tpu/parallel/diagnosis.py``): the GMM EM of script 03 and the
logistic regression of scripts 02 and 05 with their rows split over the
mesh's ``"data"`` axis.

Every sum over rows in those fits (the EM moments, the standardization
statistics, the Newton gradient and Hessian, the L-BFGS loss and gradient) is
taken per shard on its device and added on the first device in mesh order
(``diagnosis/gmm.py::gmm_fit_shards``, ``diagnosis/logreg.py::
logreg_fit_shards``).  These wrappers only place the data: pad the rows with
zeros to a multiple of the data axis, split them over its devices, and pass a
1/0 row mask so that the padded rows carry exactly zero weight: the fitted
model is the unpadded one.  A data axis of size 1 runs the unsharded fit.
"""

from __future__ import annotations

from typing import Optional

import torch

from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.diagnosis.gmm import GMMParams, _torch_dtype, gmm_fit, gmm_fit_shards
from pinnfc_tpu_torch.diagnosis.kmeans import kmeans_fit
from pinnfc_tpu_torch.diagnosis.logreg import LogRegModel, logreg_fit, logreg_fit_shards
from pinnfc_tpu_torch.parallel.mesh import Mesh, shard_batch


def _pad_rows(arr: torch.Tensor, multiple: int):
    """Zero rows appended to a multiple of ``multiple``; returns (padded, mask
    of 1/0 in ``arr``'s float dtype, or float32).  Zeros, not edge copies:
    every consumer weights rows by the mask, so the pad content never
    counts."""
    n = arr.shape[0]
    pad = (-n) % multiple
    dt = arr.dtype if arr.is_floating_point() else torch.float32
    mask = torch.cat([torch.ones(n, dtype=dt, device=arr.device),
                      torch.zeros(pad, dtype=dt, device=arr.device)])
    if pad:
        arr = torch.cat([arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))])
    return arr, mask


def gmm_fit_dp(
    x,
    generator: Optional[torch.Generator],
    n_components: int,
    mesh: Mesh,
    max_iter: int = 100,
    tol: float = 1e-3,
    reg_covar: float = 1e-6,
    kmeans_iters: int = 50,
    init_resp=None,
    dtype="float32",
) -> GMMParams:
    """GMM EM with the rows over the mesh's ``"data"`` axis.  The k-means
    initialization (draws from ``generator``, a CPU ``torch.Generator``) runs
    unsharded on the real rows on the first device; ``init_resp`` (N, C)
    replaces it.  The mixture lives on the first device."""
    devices = [resolve_device(d) for d in mesh.axis_devices("data")]
    dt = _torch_dtype(dtype)
    if len(devices) == 1:
        return gmm_fit(x, generator, n_components, max_iter=max_iter, tol=tol,
                       reg_covar=reg_covar, kmeans_iters=kmeans_iters, init_resp=init_resp,
                       dtype=dtype, device=devices[0])
    x = torch.as_tensor(x, dtype=dt).to(devices[0])
    if init_resp is None:
        if generator is None:
            raise ValueError("gmm_fit_dp needs a generator for its k-means init (or init_resp)")
        km = kmeans_fit(x, generator, n_components, max_iter=kmeans_iters, device=devices[0])
        resp0 = torch.nn.functional.one_hot(km.assignments, n_components).to(dt)
    else:
        resp0 = torch.as_tensor(init_resp, dtype=dt).to(devices[0])
    x_pad, mask = _pad_rows(x, len(devices))
    resp_pad, _ = _pad_rows(resp0, len(devices))
    shards = shard_batch(mesh, x_pad, resp_pad, mask)
    return gmm_fit_shards(shards.array(0), shards.array(1), max_iter=max_iter, tol=tol,
                          reg_covar=reg_covar, masks=shards.array(2))


def logreg_fit_dp(
    x,
    y,
    n_classes: int,
    mesh: Mesh,
    max_iter: int = 1000,
    balanced: bool = True,
    c_reg: float = 1.0,
    tol: float = 1e-6,
    solver: str = "auto",
) -> LogRegModel:
    """Multinomial logistic regression with the rows over the mesh's
    ``"data"`` axis: padded rows at zero weight in the standardization
    statistics, the balanced class counts, the loss, gradient and Hessian;
    the solve itself is a small (D+1)·K system on the first device."""
    devices = [resolve_device(d) for d in mesh.axis_devices("data")]
    if len(devices) == 1:
        return logreg_fit(x, y, n_classes, max_iter=max_iter, balanced=balanced, c_reg=c_reg,
                          tol=tol, solver=solver, device=devices[0])
    x_pad, mask = _pad_rows(torch.as_tensor(x, dtype=torch.float32).to(devices[0]),
                            len(devices))
    y_pad, _ = _pad_rows(torch.as_tensor(y, dtype=torch.int64).to(devices[0]), len(devices))
    shards = shard_batch(mesh, x_pad, y_pad, mask)
    return logreg_fit_shards(shards.array(0), shards.array(1), n_classes, max_iter=max_iter,
                             balanced=balanced, c_reg=c_reg, tol=tol, solver=solver,
                             masks=shards.array(2))
