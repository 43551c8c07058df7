"""Port parity: physics residuals (pinnfc_tpu_torch.physics) and the fused
residual kernel's wrapper (pinnfc_tpu_torch.ops.residuals) against
pinnfc_tpu.physics and the Pallas kernel in interpret mode.  float32 on both
sides: NaN sets identical, rtol 2e-5 elsewhere (the tolerance of
tests/test_pallas.py); atol 1e-5 absorbs the cancellation in f_v = v_est − v_out."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinnfc_tpu.data.combine import combine_and_normalize as jax_combine
from pinnfc_tpu.models.pinn import LAMBDA_INIT
from pinnfc_tpu.ops.pallas_residuals import all_residuals_pallas
from pinnfc_tpu.physics import hydrogen as jax_h
from pinnfc_tpu.physics import oxygen as jax_o
from pinnfc_tpu.physics import residuals as jax_res
from pinnfc_tpu.physics import thermal as jax_t
from pinnfc_tpu.physics import voltage as jax_v
from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.ops import residuals as residuals_op
from pinnfc_tpu_torch.ops.residuals import all_residuals_kernel
from pinnfc_tpu_torch.physics import hydrogen, oxygen, residuals, thermal, voltage

RTOL, ATOL = 2e-5, 1e-5


@pytest.fixture(scope="module")
def case():
    normal, faults = synthesize_stack_data(n_normal=400, n_fault=40, seed=3)
    jds = jax_combine(normal, faults)
    x = np.array(jds.x_test)
    u = np.random.RandomState(0).uniform(-1.2, 1.2, (x.shape[0], 1)).astype(np.float32)
    sx = AffineScaler.from_numpy(jds.scaler_x.to_numpy(), device="cpu")
    sy = AffineScaler.from_numpy(jds.scaler_y.to_numpy(), device="cpu")
    return jds, x, u, sx, sy


def _lams(i_l=None):
    lams = {k: v.copy() for k, v in LAMBDA_INIT.items()}
    if i_l is not None:
        lams["lam_v"][2] = i_l  # rows with i > i_l give NaN in f_v
    return lams


def _assert_same(got, want, name):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{name}: NaN sets")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=name)


@pytest.mark.parametrize("i_l", [None, 1.2])
def test_all_residuals_match(case, i_l):
    jds, x, u, sx, sy = case
    lams = _lams(i_l)
    want = jax_res.all_residuals({k: jnp.asarray(v) for k, v in lams.items()},
                                 x, u, jds.scaler_x, jds.scaler_y)
    got = residuals.all_residuals({k: torch.as_tensor(v) for k, v in lams.items()},
                                  torch.as_tensor(x), torch.as_tensor(u), sx, sy)
    for name in residuals.ResidualBundle._fields:
        _assert_same(getattr(got, name), getattr(want, name), name)
    if i_l is not None:
        assert np.isnan(got.f_v.numpy()).any() and np.isnan(got.v_phys_stack.numpy()).any()


def test_voltage_outputs_match(case):
    jds, x, u, sx, sy = case
    lam = LAMBDA_INIT["lam_v"]
    want = jax_v.voltage_residual(jnp.asarray(lam), x, u, jds.scaler_x, jds.scaler_y)
    got = voltage.voltage_residual(torch.as_tensor(lam), torch.as_tensor(x),
                                   torch.as_tensor(u), sx, sy)
    for name in voltage.VoltageOutputs._fields:
        _assert_same(getattr(got, name), getattr(want, name), name)


@pytest.mark.parametrize("which", ["hydrogen", "oxygen", "thermal_simple"])
def test_single_models_match(case, which):
    jds, x, _, sx, _ = case
    if which == "hydrogen":
        lam, jf, f = LAMBDA_INIT["lam_h"], jax_h.hydrogen_residual, hydrogen.hydrogen_residual
    elif which == "oxygen":
        lam, jf, f = LAMBDA_INIT["lam_o"], jax_o.oxygen_residual, oxygen.oxygen_residual
    else:
        lam, jf, f = (LAMBDA_INIT["lam_t"], jax_t.thermal_residual_simple,
                      thermal.thermal_residual_simple)
    want = jf(jnp.asarray(lam), x, jds.scaler_x)
    got = f(torch.as_tensor(lam), torch.as_tensor(x), sx)
    for name in got._fields:
        _assert_same(getattr(got, name), getattr(want, name), f"{which}.{name}")


def test_thermal_euler_matches(case):
    jds, x, u, sx, sy = case
    lam = np.array([0.9, 5000.0, 1.1, 1.0, 10.0], np.float32)
    want = jax_t.thermal_residual_euler(jnp.asarray(lam), x, u, jds.scaler_x, jds.scaler_y)
    got = thermal.thermal_residual_euler(torch.as_tensor(lam), torch.as_tensor(x),
                                         torch.as_tensor(u), sx, sy)
    for name in thermal.ThermalOutputs._fields:
        _assert_same(getattr(got, name), getattr(want, name), name)


@pytest.mark.parametrize("i_l", [None, 1.2])
def test_kernel_wrapper_matches_pallas_interpret(case, i_l):
    """On CPU tensors the wrapper runs the plain version; it matches the
    Pallas kernel (interpret mode) and launches nothing."""
    jds, x, u, sx, sy = case
    lams = _lams(i_l)
    want = all_residuals_pallas({k: jnp.asarray(v) for k, v in lams.items()},
                                x, u, jds.scaler_x, jds.scaler_y, interpret=True)
    before = dict(build.LAUNCHES)
    got = all_residuals_kernel({k: torch.as_tensor(v) for k, v in lams.items()},
                               torch.as_tensor(x), torch.as_tensor(u[:, 0]), sx, sy)
    assert build.LAUNCHES == before
    for name in residuals.ResidualBundle._fields:
        _assert_same(getattr(got, name), getattr(want, name), name)


def test_kernel_wrapper_rejects_bad_inputs(case):
    _, x, u, sx, sy = case
    lams = {k: torch.as_tensor(v) for k, v in LAMBDA_INIT.items()}
    with pytest.raises(ValueError):
        all_residuals_kernel(lams, torch.as_tensor(x[:, :7]), torch.as_tensor(u), sx, sy)
    with pytest.raises(ValueError):
        all_residuals_kernel(lams, torch.as_tensor(x), torch.as_tensor(u[:-1]), sx, sy)
    with pytest.raises(ValueError):
        all_residuals_kernel(lams, torch.as_tensor(x, dtype=torch.float64),
                             torch.as_tensor(u), sx, sy)


def _bad_lam_v_strided(lams, sx, sy):
    lams["lam_v"] = torch.stack([lams["lam_v"], lams["lam_v"]], dim=1)[:, 0]
    return lams, sx, sy


def _bad_lam_t_size(lams, sx, sy):
    lams["lam_t"] = lams["lam_t"][:4]
    return lams, sx, sy


def _bad_scaler_x_float64(lams, sx, sy):
    return lams, dataclasses.replace(sx, scale=sx.scale.double()), sy


def _bad_scaler_y_device(lams, sx, sy):
    return lams, sx, dataclasses.replace(sy, min=torch.empty(1, device="meta"))


@pytest.mark.parametrize("spoil", [_bad_lam_v_strided, _bad_lam_t_size, _bad_scaler_x_float64,
                                   _bad_scaler_y_device])
def test_kernel_wrapper_rejects_scalars_it_cannot_read_in_place(case, spoil):
    """The kernel reads the λ's and the scalers' constants in place, so on
    either device the wrapper raises on a tensor it could not pass as is."""
    _, x, u, sx, sy = case
    lams, sx, sy = spoil({k: torch.as_tensor(v) for k, v in _lams().items()}, sx, sy)
    with pytest.raises(ValueError):
        all_residuals_kernel(lams, torch.as_tensor(x), torch.as_tensor(u), sx, sy)


def test_kernel_wrapper_takes_a_strided_column_on_the_cpu(case):
    """u as a column of a wider tensor (the exporter passes the MC sums' base
    column): the plain version's values, and nothing launched."""
    _, x, u, sx, sy = case
    lams = {k: torch.as_tensor(v) for k, v in _lams(1.2).items()}
    wide = torch.as_tensor(np.repeat(u, 4, axis=1))
    before = dict(build.LAUNCHES)
    got = all_residuals_kernel(lams, torch.as_tensor(x), wide[:, 0], sx, sy)
    assert build.LAUNCHES == before
    want = residuals.all_residuals(lams, torch.as_tensor(x), torch.as_tensor(u), sx, sy)
    for name, a, b in zip(residuals.ResidualBundle._fields, got, want):
        assert a.shape == b.shape == (x.shape[0], 1), name
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=name)


def test_launch_checks_its_inputs_before_the_device(case):
    """``launch_residuals`` is public: it runs ``check_inputs`` itself, so a
    caller that skips the wrapper gets a ValueError, never a read out of
    bounds, and a CPU tensor is refused rather than launched."""
    _, x, u, sx, sy = case
    lams = {k: torch.as_tensor(v) for k, v in _lams().items()}
    scalars = residuals_op.kernel_scalars(lams, sx, sy)
    x, u = torch.as_tensor(x), torch.as_tensor(u)
    with pytest.raises(ValueError, match="u_norm must be float32 with"):
        residuals_op.launch_residuals(x, u[:-1], scalars)
    with pytest.raises(ValueError, match="lam_h"):
        residuals_op.launch_residuals(x, u, {**scalars, "lam_h": scalars["lam_h"][:3]})
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        residuals_op.launch_residuals(x, u, scalars)
