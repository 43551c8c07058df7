"""Fused physics-residual kernel ``csrc/residuals.cu`` and its wrapper
(counterpart of ``pinnfc_tpu/ops/pallas_residuals.py::all_residuals_pallas``).

``all_residuals_kernel`` has the ``ResidualBundle`` contract of
``physics.residuals.all_residuals``, which is its plain version: a CUDA
tensor launches the kernel, a CPU tensor runs the plain version.  On either
device the inputs must be what the kernel reads in place: float32,
contiguous, of the right sizes and on one device, else ``ValueError``.

An eager call launches the kernel directly (``launch_residuals``) or runs
the plain version (``plain_rows``).  Only a traced call (``torch.export``,
strict or not, ``torch.compile``, ``make_fx``: fake, functional or proxy
tensors) goes through the registered operator ``pinnfc_torch::residuals``
(``residuals_op``: the same two routes behind the dispatcher, an (8, N)
float32 result), so that the traced program records the call as one node: an
exported monitor step moved to the card launches the same kernel as the eager
monitor.  The dispatcher runs a custom operator under
``torch._disable_dynamo``, whose first call imports ``torch._dynamo``
(seconds); the test for a trace imports nothing, so an eager process never
loads it.
"""

from __future__ import annotations

from typing import Dict

import torch

from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.physics.residuals import ResidualBundle, all_residuals


def kernel_scalars(params, scaler_x: AffineScaler, scaler_y: AffineScaler
                   ) -> Dict[str, torch.Tensor]:
    """The tensors the kernel reads its scalars from, in the field order of
    ``build.ResidualScalars``."""
    return {"lam_v": params["lam_v"], "lam_t": params["lam_t"], "lam_h": params["lam_h"],
            "lam_o": params["lam_o"], "sx_scale": scaler_x.scale, "sx_min": scaler_x.min,
            "sy_scale": scaler_y.scale, "sy_min": scaler_y.min}


def check_inputs(x_norm: torch.Tensor, u_norm: torch.Tensor,
                 scalars: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Raise ``ValueError`` unless the kernel can read every input in place;
    returns ``u_norm`` as a 1-D view (a column of a wider tensor keeps its
    stride)."""
    n = x_norm.shape[0]
    if x_norm.dtype != torch.float32 or x_norm.shape != (n, 8) or not x_norm.is_contiguous():
        raise ValueError(f"x_norm must be contiguous float32 (N, 8), got {x_norm.dtype} "
                         f"{tuple(x_norm.shape)} with strides {x_norm.stride()}")
    if u_norm.dtype != torch.float32 or u_norm.numel() != n:
        raise ValueError(f"u_norm must be float32 with {n} values, got {u_norm.dtype} "
                         f"{tuple(u_norm.shape)}")
    try:
        u_flat = u_norm.view(-1)
    except RuntimeError as e:
        raise ValueError(f"u_norm {tuple(u_norm.shape)} with strides {u_norm.stride()} has "
                         "no 1-D view") from e
    for name, t in scalars.items():
        size = build.RESIDUAL_SCALAR_SIZES[name]
        if (t.dtype != torch.float32 or t.numel() != size or not t.is_contiguous()
                or t.device != x_norm.device):
            raise ValueError(f"{name} must be a contiguous float32 tensor of {size} values on "
                             f"{x_norm.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                             f"{'' if t.is_contiguous() else ', not contiguous'}")
    if u_norm.device != x_norm.device:
        raise ValueError(f"u_norm is on {u_norm.device}, x_norm on {x_norm.device}")
    return u_flat


def all_residuals_kernel(
    params,
    x_norm: torch.Tensor,
    u_norm: torch.Tensor,
    scaler_x: AffineScaler,
    scaler_y: AffineScaler,
) -> ResidualBundle:
    """x_norm (N, 8) and u_norm (N, 1) or (N,), float32 → ResidualBundle of (N, 1)."""
    scalars = kernel_scalars(params, scaler_x, scaler_y)
    u_flat = check_inputs(x_norm, u_norm, scalars)
    args = (x_norm, u_flat, *(scalars[k] for k in build.RESIDUAL_SCALAR_SIZES))
    if _traced(x_norm):
        out = residuals_op(*args)
    elif x_norm.device.type == "cuda":
        out = launch_residuals(x_norm, u_flat, scalars)
    else:
        out = plain_rows(*args)
    return ResidualBundle(*out.view(8, x_norm.shape[0], 1).unbind(0))


def _traced(x: torch.Tensor) -> bool:
    """Whether ``x`` reaches the wrapper inside a trace: torch.compile or
    torch.export (strict export never looks past these two flags), a tensor
    subclass (fake, functional), a C++ functional wrapper, or a dispatch mode
    (make_fx's proxy mode).  Reads flags only: imports nothing."""
    return (torch.compiler.is_compiling() or torch.compiler.is_exporting()
            or type(x) is not torch.Tensor or torch._is_functional_tensor(x)
            or torch._C._len_torch_dispatch_stack() > 0)


def _scaler(scale: torch.Tensor, min_: torch.Tensor) -> AffineScaler:
    # the physics reads a scaler's scale and min only (``inverse``)
    return AffineScaler(scale=scale, min=min_, data_min=min_, data_max=min_)


def plain_rows(x, u, lam_v, lam_t, lam_h, lam_o, sx_scale, sx_min, sy_scale, sy_min
               ) -> torch.Tensor:
    """The residual rows (8, N) of x (N, 8) and u (N,) by the plain version
    ``physics.residuals.all_residuals``: the operator's CPU kernel and the
    eager CPU route, so the two agree bitwise."""
    params = {"lam_v": lam_v, "lam_t": lam_t, "lam_h": lam_h, "lam_o": lam_o}
    bundle = all_residuals(params, x, u.reshape(-1, 1), _scaler(sx_scale, sx_min),
                           _scaler(sy_scale, sy_min))
    return torch.stack([t.reshape(-1) for t in bundle])


@torch.library.custom_op("pinnfc_torch::residuals", mutates_args=(), device_types="cpu")
def residuals_op(x: torch.Tensor, u: torch.Tensor, lam_v: torch.Tensor, lam_t: torch.Tensor,
                 lam_h: torch.Tensor, lam_o: torch.Tensor, sx_scale: torch.Tensor,
                 sx_min: torch.Tensor, sy_scale: torch.Tensor,
                 sy_min: torch.Tensor) -> torch.Tensor:
    """The residual rows (8, N) of x (N, 8) and u (N,): on the CPU
    ``plain_rows``, on CUDA the kernel."""
    return plain_rows(x, u, lam_v, lam_t, lam_h, lam_o, sx_scale, sx_min, sy_scale, sy_min)


@residuals_op.register_kernel("cuda")
def _residuals_cuda(x, u, lam_v, lam_t, lam_h, lam_o, sx_scale, sx_min, sy_scale, sy_min):
    names = build.RESIDUAL_SCALAR_SIZES
    scalars = dict(zip(names, (lam_v, lam_t, lam_h, lam_o, sx_scale, sx_min, sy_scale, sy_min)))
    return launch_residuals(x, u, scalars)


@residuals_op.register_fake
def _residuals_fake(x, u, *scalars):
    return x.new_empty((8, x.shape[0]))


def launch_residuals(x: torch.Tensor, u: torch.Tensor,
                     scalars: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Launch the kernel → (8, N) rows [f_v, f_t, f_h, f_o, v_phys_stack,
    t_phys, ratio_h, ratio_o]; raises ``ValueError`` where ``check_inputs``
    does.  Issues the output's allocation and the launch on the device,
    nothing else."""
    u_flat = check_inputs(x, u, scalars)
    if x.device.type != "cuda":
        raise ValueError(f"the residual kernel needs CUDA tensors, got {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("the residual kernel reads x_norm in 16-byte loads: its data must be "
                         "16-byte aligned")
    n = x.shape[0]
    out = torch.empty((8, n), dtype=torch.float32, device=x.device)
    lib = build.load()
    ptrs = build.ResidualScalars(*(scalars[k].data_ptr() for k in build.RESIDUAL_SCALAR_SIZES))
    build.launch(lib.pinnfc_residuals, "residuals", x.device, x.data_ptr(), u_flat.data_ptr(),
                 u_flat.stride(0), ptrs, out.data_ptr(), n)
    build.LAUNCHES["residuals"] += 1
    return out


def launch_floor(n: int, device) -> None:
    """Launch the empty kernel on the grid of ``launch_residuals`` for ``n``
    rows: the launch floor under the kernel's time (timing only; not counted)."""
    lib = build.load()
    build.launch(lib.pinnfc_residuals_floor, "residuals_floor", device, n)
