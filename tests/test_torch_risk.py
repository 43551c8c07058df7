"""Port parity: the recurrences (pinnfc_tpu_torch.ops.recurrences) and the
RF(t) risk function (pinnfc_tpu_torch.risk) against the JAX package's, and
the ``risk`` command line against the JAX ``cmd_risk``.

Tolerances:
- recurrences, float32: rtol 5e-6 against the JAX functions (the doubling
  scan against XLA's associative scan and against the sequential
  ``lax.scan``, which the CPU backend may contract into fused multiply-adds;
  observed 1.7e-6);
- ``compute_rf_time_series`` 'torch' against JAX 'jax' at the tolerances of
  tests/test_risk.py:88-91 (s_tot rtol 1e-4 atol 1e-5; c rtol 1e-3 atol
  1e-3; rf_inst and rf_smooth rtol 1e-3 atol 1e-4);
- 'numpy' against JAX 'numpy': bitwise (the same float64 numpy and scipy
  operations);
- per condition: alarm indices, advance and sample counts exact on both
  backends; layer shares rtol 1e-9 on 'numpy' (observed: equal) and rtol
  1e-6 on 'torch' (float32 layer series; observed 4e-10)."""

import argparse
import contextlib
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinnfc_tpu.config as jax_config
from pinnfc_tpu.cli.diagnose import cmd_risk as jax_cmd_risk
from pinnfc_tpu.data import contract as jax_contract
from pinnfc_tpu.ops import recurrences as jax_rec
from pinnfc_tpu.risk import rf as jax_rf
from pinnfc_tpu_torch import config
from pinnfc_tpu_torch.data import contract
from pinnfc_tpu_torch.ops import recurrences
from pinnfc_tpu_torch.risk import rf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INDEX = contract.INDEX


def test_config_and_contract_are_the_jax_ones():
    assert tuple(vars(config.RiskConfig()).items()) == tuple(
        vars(jax_config.RiskConfig()).items())
    assert config.DEFAULT_RF_CONDITIONS == jax_config.DEFAULT_RF_CONDITIONS
    assert config.FAULT_RANGE_MAP == jax_config.FAULT_RANGE_MAP
    arr = np.random.RandomState(0).randn(20, 22)
    np.testing.assert_array_equal(contract.ComprehensiveResults(arr).residual_matrix(),
                                  jax_contract.ComprehensiveResults(arr).residual_matrix())


@pytest.mark.parametrize("n", [1, 2, 3, 511, 512, 513, 1050])
@pytest.mark.parametrize("fn", ["leaky_integral", "ema"])
@pytest.mark.parametrize("assoc", [True, False])
def test_recurrences_match_jax(n, fn, assoc):
    """The port's doubling scan against each of the JAX package's two forms
    (``assoc=True``: XLA's associative scan; ``assoc=False``: the sequential
    ``lax.scan``, the reference's loop)."""
    s = np.random.RandomState(n).uniform(0.0, 3.0, n).astype(np.float32)
    arg = 0.9971 if fn == "leaky_integral" else 0.2
    want = np.asarray(getattr(jax_rec, fn)(jnp.asarray(s), arg, assoc=assoc))
    got = getattr(recurrences, fn)(torch.as_tensor(s), arg).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=5e-6)


def test_recurrence_with_a_start_value():
    rs = np.random.RandomState(3)
    a = rs.uniform(0.5, 1.0, 37).astype(np.float32)
    b = rs.uniform(-1.0, 1.0, 37).astype(np.float32)
    got = recurrences.linear_recurrence_assoc(
        torch.as_tensor(a), torch.as_tensor(b), 2.5).numpy()
    for fn in (jax_rec.linear_recurrence_assoc, jax_rec.linear_recurrence_scan):
        want = np.asarray(fn(jnp.asarray(a), jnp.asarray(b), 2.5))
        np.testing.assert_allclose(got, want, rtol=5e-6, atol=1e-6)


def _fake_results():
    """tests/test_risk.py's fixture: growing residuals in the fault rows."""
    rng = np.random.RandomState(0)
    n_normal, n_fault = 600, 150
    n = n_normal + 12 * n_fault
    arr = np.zeros((n, 22))
    arr[:, INDEX["y_true"]] = 4.0 + 0.01 * rng.randn(n)
    for k in ("res", "pV", "pT", "pH", "pO"):
        arr[:, INDEX[k]] = 0.1 * rng.randn(n)
    pos, label = n_normal, 1
    for _ in range(4):
        for amps in (108.0, 270.0, 405.0):
            seg = slice(pos, pos + n_fault)
            arr[seg, INDEX["label"]] = label
            arr[seg, INDEX["x0"]] = amps
            ramp = np.linspace(0, 3.0, n_fault)
            arr[seg, INDEX["res"]] += ramp * 0.5
            arr[seg, INDEX["pV"]] += ramp * 0.4
            arr[seg, INDEX["y_true"]] = 4.0 - np.linspace(0, 0.3, n_fault)
            pos += n_fault
            label += 1
    arr[:n_normal, INDEX["x0"]] = rng.uniform(100, 400, n_normal)
    return arr


def _campaign_scale_results():
    """tests/test_risk.py:237-288's adversarial artifact: 12 fault segments of
    1,050 rows with slow-onset ramps, so that rf_smooth grazes the 0.3 warning
    threshold for many samples and a float32 rounding flip would move a
    crossing."""
    rng = np.random.RandomState(7)
    n_normal, n_fault = 2000, 1050
    n = n_normal + 12 * n_fault
    arr = np.zeros((n, 22))
    arr[:, INDEX["y_true"]] = 4.0 + 0.01 * rng.randn(n)
    for k in ("res", "pV", "pT", "pH", "pO"):
        arr[:, INDEX[k]] = 0.1 * rng.randn(n)
    arr[:n_normal, INDEX["x0"]] = rng.uniform(100, 400, n_normal)
    pos, label = n_normal, 1
    for _ in range(4):
        for amps in (108.0, 270.0, 405.0):
            seg = slice(pos, pos + n_fault)
            arr[seg, INDEX["label"]] = label
            arr[seg, INDEX["x0"]] = amps
            t = np.linspace(0.0, 1.0, n_fault)
            ramp = np.clip((t - 0.25) / 0.75, 0.0, 1.0)
            arr[seg, INDEX["res"]] += ramp * 0.35
            arr[seg, INDEX["pV"]] += ramp * 0.3
            arr[seg, INDEX["pT"]] += ramp * 0.25
            arr[seg, INDEX["y_true"]] = 4.0 - ramp * 0.15
            pos += n_fault
            label += 1
    return arr


ARTIFACTS = {"fake": _fake_results, "campaign_scale": _campaign_scale_results}


@pytest.fixture(scope="module")
def artifacts():
    return {name: make() for name, make in ARTIFACTS.items()}


def test_mu_sigma_bitwise(artifacts):
    for arr in artifacts.values():
        for got, want in zip(rf.estimate_mu_sigma_normal(arr),
                             jax_rf.estimate_mu_sigma_normal(arr)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="normal labels"):
        rf.estimate_mu_sigma_normal(np.ones((4, 22)))


@pytest.mark.parametrize("rows", [slice(0, 800), slice(600, 1650), slice(0, 1)])
def test_rf_time_series_matches_jax(artifacts, rows):
    arr = artifacts["fake"]
    cfg = config.RiskConfig()
    mu, sigma = rf.estimate_mu_sigma_normal(arr)
    r = np.stack([arr[rows, INDEX[k]] for k in cfg.res_keys], axis=1)
    got = rf.compute_rf_time_series(r, mu, sigma, cfg, backend="torch", device="cpu")
    want = jax_rf.compute_rf_time_series(r, mu, sigma, jax_config.RiskConfig(), backend="jax")
    tol = {"s_tot": (1e-4, 1e-5), "c": (1e-3, 1e-3), "rf_inst": (1e-3, 1e-4),
           "rf_smooth": (1e-3, 1e-4)}
    for key, (rtol, atol) in tol.items():
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol, err_msg=key)
    for name in want["s_layers"]:
        np.testing.assert_allclose(got["s_layers"][name], want["s_layers"][name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    got_np = rf.compute_rf_time_series(r, mu, sigma, cfg, backend="numpy")
    want_np = jax_rf.compute_rf_time_series(r, mu, sigma, backend="numpy")
    for key in ("rf_inst", "rf_smooth", "c", "s_tot"):
        np.testing.assert_array_equal(got_np[key], want_np[key], err_msg=key)
    for name in want_np["s_layers"]:
        np.testing.assert_array_equal(got_np["s_layers"][name], want_np["s_layers"][name])


def test_unknown_backend_and_absent_card():
    r, mu, sigma = np.zeros((4, 5)), np.zeros(5), np.ones(5)
    with pytest.raises(ValueError, match="backend"):
        rf.compute_rf_time_series(r, mu, sigma, backend="jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rf.compute_rf_time_series(r, mu, sigma)


def test_find_first_alarm_index():
    s = np.array([0.1, 0.2, 0.35, 0.25, 0.5])
    for args in ((0.3, "above"), (0.15, "below"), (0.9, "above")):
        assert rf.find_first_alarm_index(s, *args) == jax_rf.find_first_alarm_index(s, *args)
    with pytest.raises(ValueError):
        rf.find_first_alarm_index(s, 0.3, "sideways")


@pytest.mark.parametrize("index_range", [None, (0, 50), (60, 50), (0, 1050)])
def test_condition_rows_match_jax(artifacts, index_range):
    arr = artifacts["fake"]
    for cur, fault in ((108.0, "水淹"), (405.0, "氢饥饿"), (999.0, "膜干")):
        got = rf.condition_row_indices(arr, fault, cur, index_range=index_range)
        want = jax_rf.condition_row_indices(arr, fault, cur, index_range=index_range)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown fault"):
        rf.condition_row_indices(arr, "rust", 108.0)


@pytest.mark.parametrize("artifact", sorted(ARTIFACTS))
@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_risk_pipeline_table_matches_jax(artifacts, artifact, backend):
    arr = artifacts[artifact]
    got = rf.run_risk_pipeline(arr, backend=backend, device="cpu")
    want = jax_rf.run_risk_pipeline(arr, backend="jax" if backend == "torch" else "numpy")
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        assert (a.current_target, a.fault_name, a.n_samples) == \
            (b.current_target, b.fault_name, b.n_samples)
        assert (a.idx_v_alarm, a.idx_rf_alarm, a.advance) == \
            (b.idx_v_alarm, b.idx_rf_alarm, b.advance)
        assert a.v_threshold == b.v_threshold
        np.testing.assert_array_equal(a.row_indices, b.row_indices)
        assert a.layer_shares.keys() == b.layer_shares.keys()
        assert a.dominant_layer == b.dominant_layer
        for name, share in b.layer_shares.items():
            rtol = 1e-9 if backend == "numpy" else 1e-6
            assert a.layer_shares[name] == pytest.approx(share, rel=rtol, abs=1e-12)
        if backend == "numpy":
            np.testing.assert_array_equal(a.rf_smooth, b.rf_smooth)
            for name in b.layer_c:
                np.testing.assert_array_equal(a.layer_c[name], b.layer_c[name])
    if artifact == "campaign_scale":
        assert sum(a.idx_rf_alarm is not None for a in got) == 12


def _jax_table(mat):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = jax_cmd_risk(argparse.Namespace(mat=mat, backend="jax", plot_dir=None))
    assert rc == 0
    return buf.getvalue()


def test_cli_risk_prints_the_jax_table_without_jax(artifacts, tmp_path, capsys):
    """``risk --device cpu`` (the torch backend) in a process that must not
    import jax, and ``risk --backend numpy``: each table equal, line for line,
    to the JAX ``cmd_risk``'s."""
    from pinnfc_tpu_torch import cli

    mat = str(tmp_path / "F01_output.mat")
    contract.save_comprehensive_results(contract.ComprehensiveResults(
        artifacts["campaign_scale"]), mat)
    script = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from pinnfc_tpu_torch.cli import main\n"
        "rc = main(sys.argv[1:])\n"
        "assert 'jax' not in sys.modules, 'the port imported jax'\n"
        "sys.exit(rc)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    want = _jax_table(mat).splitlines()
    assert len(want) == 13
    proc = subprocess.run([sys.executable, "-c", script, "risk", "--mat", mat, "--device", "cpu"],
                          cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines() == want
    capsys.readouterr()
    assert cli.main(["risk", "--mat", mat, "--backend", "numpy"]) == 0
    assert capsys.readouterr().out.splitlines() == want


def test_cli_risk_needs_the_card_unless_asked_for_the_cpu(artifacts, tmp_path, capsys):
    from pinnfc_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    mat = str(tmp_path / "F01_output.mat")
    contract.save_comprehensive_results(contract.ComprehensiveResults(artifacts["fake"]), mat)
    assert cli.main(["risk", "--mat", mat]) == 1
    assert "CUDA" in capsys.readouterr().err
    assert cli.main(["risk", "--mat", str(tmp_path / "missing.mat"), "--device", "cpu"]) == 1
