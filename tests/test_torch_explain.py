"""Port parity: split-conformal coverage, input saliency and λ
identifiability (pinnfc_tpu_torch.uq) and the ``conformal``, ``explain``,
``identify`` and ``inspect`` command lines, against the JAX package's, on the
CPU with a narrow MLP (8→32→32→1) on a 660-row synthetic campaign.

The λ's are set so that the voltage residual is NaN on the rows past the
limiting current (i_l = 1.2 A/cm²) and λH0 sits at its lower bound.
Tolerances:
- conformal: ``to_dict()`` equal, floats bitwise (float64 numpy in both);
- saliency: ``jac_norm`` and ``jac_range`` at rtol 1e-4 / atol 1e-6, the
  class tables at rtol 1e-4, each class's driver (argmax) equal;
- identifiability: flags, ``n_residuals``, ``n_dropped``, ``dof`` and the
  values equal; stderr, CI, sensitivity, corr and σ̂² at rtol 1e-3 on finite
  entries, inf and NaN in the same places; the dead parameters' Jacobian
  columns exactly zero;
- the commands' ``--json`` documents at the same tolerances, their text
  tables with the same rows; their ``--plot-dir`` figures with JAX's file
  names and artist data (tests/_torch_figures.py) at rtol 1e-6.
"""

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pinnfc_tpu.cli import diagnose as jax_diagnose
from pinnfc_tpu.cli import explain as jax_explain
from pinnfc_tpu.uq import conformal as jax_conformal
from pinnfc_tpu.uq import identifiability as jax_ident
from pinnfc_tpu.uq import saliency as jax_saliency
from pinnfc_tpu.utils import checkpoint as jax_ckpt
from pinnfc_tpu.viz import plots as jax_plots
from pinnfc_tpu_torch import cli
from pinnfc_tpu_torch.data.contract import INDEX, save_comprehensive_results
from pinnfc_tpu_torch.uq import conformal, identifiability, saliency
from pinnfc_tpu_torch.utils.threads import one_thread
from pinnfc_tpu_torch.viz import plots

from _torch_explain_model import DEAD, explain_model
from _torch_figures import captured, same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _pinned():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The shared miniature model, artifact and checkpoints
    (tests/_torch_explain_model.py)."""
    return explain_model(tmp_path_factory.mktemp("explain"))


def _same_floats(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0)


# ---- conformal ----

@pytest.mark.parametrize("score,alpha,calib_frac,seed", [
    ("adaptive", 0.1, 0.5, 0), ("absolute", 0.05, 0.3, 7), ("adaptive", 0.2, 0.9, 3)])
def test_conformal_report_equals_jax(model, score, alpha, calib_frac, seed):
    got = conformal.conformal_report(model.arr, alpha, score, calib_frac, seed)
    want = jax_conformal.conformal_report(model.arr, alpha, score, calib_frac, seed)
    assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
    assert got.n_dropped == int(np.isnan(model.arr[got.calib_mask, INDEX["res"]]).sum())
    assert len(got.classes) == 13
    for name in ("pvalues", "covered", "calib_mask", "calib_scores"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(
        conformal.normal_calibration_scores(model.arr, score, calib_frac, seed),
        jax_conformal.normal_calibration_scores(model.arr, score, calib_frac, seed))


def test_conformal_edges_equal_jax(model):
    for s, a in (([], 0.1), ([1.0, 2.0], 0.1), (np.arange(20.0), 0.1), (np.arange(20.0), 0.5)):
        assert conformal.conformal_quantile(s, a) == jax_conformal.conformal_quantile(s, a)
    calib = np.array([0.1, 0.5, 0.5, 2.0])
    scores = np.array([0.0, 0.5, np.nan, 3.0, np.inf])
    np.testing.assert_array_equal(conformal.conformal_pvalues(calib, scores),
                                  jax_conformal.conformal_pvalues(calib, scores))
    for bad in (dict(alpha=0.0), dict(calib_frac=1.0), dict(score="relative")):
        with pytest.raises(ValueError):
            conformal.conformal_report(model.arr, **bad)
    one_normal = model.arr[model.labels > 0]
    with pytest.raises(ValueError, match="normal"):
        conformal.conformal_report(one_normal)


# ---- saliency ----

def test_input_saliency_matches_jax(model):
    x_phys = model.arr[:, :8]
    got = saliency.input_saliency(model.tp, x_phys, model.sx, model.sy, labels=model.labels,
                                  device="cpu")
    want = jax_saliency.input_saliency(model.jp, x_phys, model.jds.scaler_x,
                                       model.jds.scaler_y, labels=model.labels)
    assert got.channel_names == want.channel_names
    for field in ("jac_norm", "jac_phys", "jac_range", "sigma_jac_range"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape == (len(x_phys), 8)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    for field in ("jac_range", "sigma_jac_range"):
        gt, wt = saliency.coarse_class_saliency(got, field), jax_saliency.coarse_class_saliency(
            want, field)
        assert list(gt) == list(wt) == ["normal", "Flooding", "Oxygen starvation",
                                        "Membrane drying", "Hydrogen starvation"]
        for name in wt:
            np.testing.assert_allclose(gt[name], wt[name], rtol=1e-4)
            assert np.argmax(gt[name]) == np.argmax(wt[name])
        gl, wl = saliency.class_mean_saliency(got, field), jax_saliency.class_mean_saliency(
            want, field)
        assert list(gl) == list(wl) == list(range(13))
        for k in wl:
            np.testing.assert_allclose(gl[k], wl[k], rtol=1e-4)
    with pytest.raises(ValueError, match="labels"):
        saliency.coarse_class_saliency(got._replace(labels=None))
    with pytest.raises(ValueError, match="x_phys"):
        saliency.input_saliency(model.tp, x_phys[:, :5], model.sx, model.sy, device="cpu")


# ---- identifiability ----

def test_lambda_identifiability_matches_jax(model):
    got = identifiability.lambda_identifiability(model.tp, model.x_norm, model.sx, model.sy)
    want = jax_ident.lambda_identifiability(model.jp, model.x_norm, model.jds.scaler_x,
                                            model.jds.scaler_y)
    assert list(got) == list(want) == ["lam_v", "lam_t", "lam_h", "lam_o"]
    for g, w in zip(got.values(), want.values()):
        assert g.names == w.names
        for name in ("identifiable", "at_bound", "values"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
        assert (g.n_residuals, g.n_dropped, g.dof) == (w.n_residuals, w.n_dropped, w.dof)
        for name in ("stderr", "ci_lo", "ci_hi", "sensitivity", "corr", "sigma2"):
            _same_floats(getattr(g, name), getattr(w, name), rtol=1e-3)
        dead = DEAD[g.group]
        assert not g.identifiable[dead].any() and (g.sensitivity[dead] == 0.0).all()
        assert np.isinf(g.stderr[dead]).all()
    assert got["lam_v"].n_dropped > 0 and got["lam_t"].n_dropped == 0
    assert got["lam_h"].at_bound.tolist() == [True, False, False, False]


def test_dead_columns_are_exact_zeros_on_the_finite_rows(model):
    x = torch.from_numpy(np.array(model.x_norm))
    for group, dead in DEAD.items():
        r, jac = identifiability.residual_and_jacobian(group, model.tp, x, model.sx, model.sy)
        finite = torch.isfinite(r)
        assert jac.shape == (len(x), model.tp[group].numel())
        assert bool((jac[finite][:, dead] == 0.0).all())


def test_gauss_newton_ci_equals_jax():
    rng = np.random.RandomState(3)
    jac = rng.randn(200, 4)
    jac[:, 2] = 0.0
    jac[:, 3] = jac[:, 0] * 2.0 + 1e-3 * rng.randn(200)  # a sloppy pair
    r = rng.randn(200)
    r[5], jac[9, 1] = np.nan, np.inf
    got = identifiability.gauss_newton_ci(r, jac)
    want = jax_ident.gauss_newton_ci(r, jac)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="non-finite"):
        identifiability.gauss_newton_ci(np.full(3, np.nan), np.ones((3, 2)))


# ---- the command lines ----

def _jax_out(fn, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argparse.Namespace(**kw))
    return rc, buf.getvalue()


def _port_out(capsys, *argv):
    capsys.readouterr()
    rc = cli.main(list(argv))
    return rc, capsys.readouterr().out


def _mask(text):
    return [re.sub(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?", "#", ln) for ln in text.splitlines()]


def test_cli_identify_matches_jax(model, capsys):
    rc, out = _port_out(capsys, "identify", "--ckpt", model.ckpt, "--mat", model.mat,
                        "--device", "cpu", "--json")
    jrc, jout = _jax_out(jax_explain.cmd_identify, ckpt=model.ckpt, mat=model.mat, json=True,
                         plot_dir=None, data_parallel=False)
    assert rc == jrc == 0
    got, want = json.loads(out), json.loads(jout)
    assert list(got) == list(want)
    for g in want:
        for key in ("names", "values", "identifiable", "at_bound", "n_residuals", "n_dropped",
                    "dof"):
            assert got[g][key] == want[g][key]
        for key in ("stderr", "sensitivity", "sigma2"):
            _same_floats(_nan(got[g][key]), _nan(want[g][key]), rtol=1e-3)
        _same_floats(_nan(got[g]["ci95"]), _nan(want[g]["ci95"]), rtol=1e-3)
        _same_floats(_nan(got[g]["corr"]), _nan(want[g]["corr"]), rtol=1e-3)
    rc, out = _port_out(capsys, "identify", "--ckpt", model.ckpt, "--mat", model.mat,
                        "--device", "cpu")
    _, jout = _jax_out(jax_explain.cmd_identify, ckpt=model.ckpt, mat=model.mat, json=False,
                       plot_dir=None, data_parallel=False)
    assert rc == 0 and _mask(out) == _mask(jout)
    assert out.count("UNIDENTIFIABLE") == 5 and "AT-BOUND" in out


def _nan(xs):
    """A JSON list with nulls → float array with NaN in their place."""
    return np.array(json.loads(json.dumps(xs).replace("null", "NaN")), np.float64)


def test_cli_explain_matches_jax(model, capsys):
    rc, out = _port_out(capsys, "explain", "--ckpt", model.ckpt, "--mat", model.mat,
                        "--device", "cpu", "--json")
    jrc, jout = _jax_out(jax_explain.cmd_explain, ckpt=model.ckpt, mat=model.mat, json=True,
                         plot_dir=None, data_parallel=False)
    assert rc == jrc == 0
    got, want = json.loads(out), json.loads(jout)
    assert {k: got[k] for k in ("unit", "channels", "n_rows")} == \
        {k: want[k] for k in ("unit", "channels", "n_rows")}
    assert list(got["classes"]) == list(want["classes"])
    for name, w in want["classes"].items():
        assert got["classes"][name]["driver"] == w["driver"]
        for key in ("voltage", "sigma"):
            np.testing.assert_allclose(got["classes"][name][key], w[key], rtol=1e-4)
    rc, out = _port_out(capsys, "explain", "--ckpt", model.ckpt, "--mat", model.mat,
                        "--device", "cpu")
    _, jout = _jax_out(jax_explain.cmd_explain, ckpt=model.ckpt, mat=model.mat, json=False,
                       plot_dir=None, data_parallel=False)
    assert rc == 0 and _mask(out) == _mask(jout)
    # the drivers, the last word of each class row
    assert [ln.split()[-1] for ln in out.splitlines()[2:]] == \
        [ln.split()[-1] for ln in jout.splitlines()[2:]]


def test_cli_inspect_matches_jax(model, capsys, tmp_path):
    orbax = str(tmp_path / "orbax")
    jax_ckpt.save_checkpoint(orbax, model.jp, model.jds.scaler_x, model.jds.scaler_y, step=9,
                             meta={"seed": 5})
    assert os.path.isfile(os.path.join(orbax, "_METADATA"))
    for path in (model.ckpt, orbax, model.bare):
        for as_json in (True, False):
            argv = ["inspect", "--ckpt", path] + (["--json"] if as_json else [])
            rc, out = _port_out(capsys, *argv)
            jrc, jout = _jax_out(jax_explain.cmd_inspect, ckpt=path, json=as_json)
            assert rc == jrc == 0
            if as_json:
                assert json.loads(out) == json.loads(jout)
            else:
                assert sorted(out.splitlines()) == sorted(jout.splitlines())
    rc, out = _port_out(capsys, "inspect", "--ckpt", model.ckpt)
    assert "scaler_x: 8 features" in out and "step: 3" in out


def test_cli_conformal_matches_jax(model, capsys):
    for extra, kw in (([], {}), (["--score", "absolute", "--alpha", "0.05", "--seed", "4",
                                 "--calib-frac", "0.25"],
                                dict(score="absolute", alpha=0.05, seed=4, calib_frac=0.25))):
        jkw = dict(dict(alpha=0.1, score="adaptive", calib_frac=0.5, seed=0), **kw)
        for as_json in (True, False):
            rc, out = _port_out(capsys, "conformal", "--mat", model.mat, *extra,
                                *(["--json"] if as_json else []))
            jrc, jout = _jax_out(jax_diagnose.cmd_conformal, mat=model.mat, json=as_json,
                                 plot_dir=None, **jkw)
            assert rc == jrc == 0 and out == jout
    # a fault-free artifact: detection AUC NaN → null in strict JSON
    healthy = str(model.root / "healthy.mat")
    save_comprehensive_results(model.arr[model.labels == 0], healthy)
    rc, out = _port_out(capsys, "conformal", "--mat", healthy, "--json")
    assert rc == 0 and json.loads(out)["detection_auc"] is None


def test_cli_needs_scalers_and_the_card(model, capsys):
    for cmd in ("identify", "explain"):
        assert cli.main([cmd, "--ckpt", model.bare, "--mat", model.mat, "--device", "cpu"]) == 2
        assert "no stored scalers" in capsys.readouterr().err
        jrc, _ = _jax_out(getattr(jax_explain, f"cmd_{cmd}"), ckpt=model.bare, mat=model.mat,
                          json=False, plot_dir=None, data_parallel=False)
        assert jrc == 2
        assert cli.main([cmd, "--ckpt", model.ckpt, "--mat", str(model.root / "missing.mat"),
                         "--device", "cpu"]) == 1
        assert "missing.mat" in capsys.readouterr().err
        if not torch.cuda.is_available():
            assert cli.main([cmd, "--ckpt", model.ckpt, "--mat", model.mat]) == 1
            assert "CUDA" in capsys.readouterr().err
    assert cli.main(["inspect", "--ckpt", str(model.root / "nothing")]) == 1
    assert cli.main(["conformal", "--mat", str(model.root / "missing.mat")]) == 1


_BLOCKED = (
    "import json, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['matplotlib'] = None\n"
    "import torch\n"
    "torch.set_num_threads(1)\n"
    "from pinnfc_tpu_torch.cli import main\n"
    "for argv in json.loads(sys.argv[1]):\n"
    "    rc = main(argv)\n"
    "    sys.stdout.flush()\n"
    "    print(f'RC {rc}', flush=True)\n"
    "assert not [m for m in sys.modules if m == 'pinnfc_tpu' or m.startswith('pinnfc_tpu.')]\n"
    "assert not torch.cuda.is_initialized()\n"
)


def test_cli_runs_without_jax_and_matplotlib(model, tmp_path):
    """The four commands in a process in which jax and matplotlib cannot be
    imported: each ``--json`` document as in-process; ``--plot-dir`` exits 1
    naming matplotlib."""
    argvs = [["inspect", "--ckpt", model.ckpt, "--json"],
             ["conformal", "--mat", model.mat, "--json"],
             ["identify", "--ckpt", model.ckpt, "--mat", model.mat, "--device", "cpu", "--json"],
             ["explain", "--ckpt", model.ckpt, "--mat", model.mat, "--device", "cpu", "--json"],
             ["conformal", "--mat", model.mat, "--plot-dir", str(tmp_path / "figs")]]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, json.dumps(argvs)], cwd=REPO,
                          env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    parts = re.split(r"^RC (-?\d+)\n", proc.stdout, flags=re.M)
    outs, rcs = parts[0:-1:2], [int(rc) for rc in parts[1::2]]
    assert rcs == [0, 0, 0, 0, 1]
    assert "matplotlib" in proc.stderr
    _, want = _jax_out(jax_diagnose.cmd_conformal, mat=model.mat, json=True, plot_dir=None,
                       alpha=0.1, score="adaptive", calib_frac=0.5, seed=0)
    assert outs[1] == want
    _, want = _jax_out(jax_explain.cmd_inspect, ckpt=model.ckpt, json=True)
    assert json.loads(outs[0]) == json.loads(want)
    ident, expl = json.loads(outs[2]), json.loads(outs[3])
    assert ident["lam_v"]["n_dropped"] > 0 and not math.isnan(ident["lam_t"]["sigma2"])
    assert set(expl["classes"]) == {"normal", "Flooding", "Oxygen starvation",
                                    "Membrane drying", "Hydrogen starvation"}


@pytest.mark.parametrize("command", ["identify", "explain", "conformal"])
def test_cli_explainability_plot_dir(model, tmp_path, monkeypatch, command):
    """``--plot-dir``: JAX's file names, and JAX's figures at rtol 1e-6, the
    JAX command drawing the port's report (identify, explain), whose numbers
    the tests above hold to JAX's."""
    import pinnfc_tpu.uq as jax_uq

    from pinnfc_tpu_torch.uq import input_saliency, lambda_identifiability

    if command == "identify":
        report = lambda_identifiability(model.tp, model.x_norm, model.sx, model.sy)
        monkeypatch.setattr(jax_uq, "lambda_identifiability", lambda *a, **k: report)
    elif command == "explain":
        report = input_saliency(model.tp, model.arr[:, :8], model.sx, model.sy,
                                labels=model.labels, device="cpu")
        monkeypatch.setattr(jax_uq, "input_saliency", lambda *a, **k: report)
    kw = {"identify": dict(ckpt=model.ckpt, json=False, data_parallel=False),
          "explain": dict(ckpt=model.ckpt, json=False, data_parallel=False),
          "conformal": dict(alpha=0.1, score="adaptive", calib_frac=0.5, seed=0,
                            json=False)}[command]
    fn = getattr(jax_diagnose if command == "conformal" else jax_explain, f"cmd_{command}")
    with captured(monkeypatch, jax_plots, save=False) as want:
        assert _jax_out(fn, mat=model.mat, plot_dir=str(tmp_path / "j"), **kw)[0] == 0
    argv = [command, "--mat", model.mat, "--plot-dir", str(tmp_path / "p")]
    if command != "conformal":
        argv += ["--ckpt", model.ckpt, "--device", "cpu"]
    with captured(monkeypatch, plots) as got, contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(argv) == 0
    assert sorted(os.listdir(tmp_path / "p")) == sorted(want) == {
        "identify": ["identifiability.png"], "explain": ["saliency_sigma.png",
                                                        "saliency_voltage.png"],
        "conformal": ["conformal_coverage.png"]}[command]
    same(got, want, 1e-6)
