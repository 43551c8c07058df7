"""Port parity: counterfactual recovery (pinnfc_tpu_torch.uq.counterfactual)
and the ``whatif`` command line, against the JAX package's, on the CPU with
the shared miniature model (tests/_torch_explain_model.py: 8→32→32→1 on a
660-row synthetic campaign whose 12 fault conditions all alarm).

Tolerances: ``v_before`` within 1e-6 V (one float32 eval forward in each);
after ≤ 40 Adam steps ``delta_range`` within 2e-5 and ``v_after`` within
2e-6 V, ``recovered`` equal (float32 in both, the same arithmetic order;
XLA and torch round the bias corrections and the autograd sums in another
order, and Adam's step is sign-like where a gradient is near 0).  The
properties the JAX tests hold (masked channels and recovered rows exactly
unmoved, out-of-box rows feasible) hold exactly.  The ``--json`` documents
at the same tolerances; the text tables equal with numbers masked.
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from pinnfc_tpu.cli import explain as jax_explain
from pinnfc_tpu.uq import counterfactual as jax_cf
from pinnfc_tpu.viz import plots as jax_plots
from pinnfc_tpu_torch import cli
from pinnfc_tpu_torch.data.contract import INDEX, INPUT_CHANNELS
from pinnfc_tpu_torch.uq import counterfactual as cf
from pinnfc_tpu_torch.utils.threads import one_thread
from pinnfc_tpu_torch.viz import plots

from _torch_explain_model import explain_model
from _torch_figures import captured, same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _pinned():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return explain_model(tmp_path_factory.mktemp("whatif"))


def _rows(model):
    """The fault rows (x, measured v) of the miniature artifact."""
    fault = model.labels > 0
    return (model.arr[fault, :8].astype(np.float32),
            model.arr[fault, INDEX["y_true"]].astype(np.float32))


def _both(model, x, target, steps, **kw):
    got = cf.counterfactual_recovery(model.tp, x, target, model.sx, model.sy,
                                     config=cf.CounterfactualConfig(steps=steps),
                                     device="cpu", **kw)
    want = jax_cf.counterfactual_recovery(model.jp, x, target, model.jds.scaler_x,
                                          model.jds.scaler_y,
                                          config=jax_cf.CounterfactualConfig(steps=steps), **kw)
    return got, want


def _same_report(got, want):
    assert got.channel_names == want.channel_names
    np.testing.assert_array_equal(got.actuatable, want.actuatable)
    for f in ("x_phys", "v_target", "v_meas"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)
    for f, atol in (("v_before", 1e-6), ("v_after", 2e-6), ("delta_range", 2e-5),
                    ("v_expected", 2e-6)):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None)
        if b is not None:
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f)
    np.testing.assert_allclose(got.x_cf_phys, want.x_cf_phys, rtol=2e-5, atol=1e-5)
    np.testing.assert_array_equal(got.recovered, want.recovered)


@pytest.mark.parametrize("mode", ["gain", "absolute"])
def test_recovery_matches_jax(model, mode):
    x, v = _rows(model)
    if mode == "gain":
        got, want = _both(model, x, v + 0.005, 40, v_meas=v)
        assert got.v_expected is not None
    else:
        v0 = jax_cf.counterfactual_recovery(model.jp, x, 0.0, model.jds.scaler_x,
                                            model.jds.scaler_y,
                                            config=jax_cf.CounterfactualConfig(steps=0)).v_before
        got, want = _both(model, x, v0 + 0.005, 40)
        assert got.v_meas is None and got.v_expected is None
    _same_report(got, want)
    assert np.abs(got.delta_range).max() > 0 and got.recovered.any()


@pytest.mark.parametrize("actuatable", [None, ("air_flow",), ("h2_flow", "coolant_t_in")])
def test_masked_channels_exactly_zero(model, actuatable):
    x, v = _rows(model)
    got, want = _both(model, x, v + 0.5, 30, v_meas=v, actuatable=actuatable)
    _same_report(got, want)
    free = cf.DEFAULT_ACTUATABLE if actuatable is None else actuatable
    for k, name in enumerate(INPUT_CHANNELS):
        assert got.actuatable[k] == (name in free)
        if name not in free:
            np.testing.assert_array_equal(got.delta_phys[:, k], 0.0)
            np.testing.assert_array_equal(got.x_cf_phys[:, k], x[:, k])
        else:
            assert np.abs(got.delta_phys[:, k]).max() > 0


def test_recovered_rows_keep_zero_and_out_of_box_rows_stay_feasible(model):
    """Rows already over their target keep δ = 0 exactly, also a row outside
    the training box (the box widens to it); an unreachable target drives
    δ into the box faces and no further.  The first case is held to the
    property alone: in the JAX function one of these rows moves, because
    XLA's v̂(0) inside the gradient lies an ulp below the v̂(x₀) of the
    target, which makes the hinge active and Adam's first step a full one."""
    x, v = _rows(model)
    x = x[:40].copy()
    k = INPUT_CHANNELS.index("air_flow")
    span = float(model.sx.data_max[k] - model.sx.data_min[k])
    x[3, k] = float(model.sx.data_max[k]) + 0.5 * span
    got = cf.counterfactual_recovery(model.tp, x, v[:40] - 5.0, model.sx, model.sy,
                                     config=cf.CounterfactualConfig(steps=20), device="cpu",
                                     v_meas=v[:40])
    np.testing.assert_array_equal(got.delta_phys, 0.0)
    np.testing.assert_array_equal(got.v_after, got.v_before)
    np.testing.assert_array_equal(got.x_cf_phys, x)
    assert got.recovered.all()
    got, want = _both(model, x, 1e4, 40)
    _same_report(got, want)
    lo, hi = model.sx.data_min.numpy(), model.sx.data_max.numpy()
    lo_eff, hi_eff = np.minimum(lo, x), np.maximum(hi, x)
    eps = 1e-4 * (hi - lo)
    assert (got.x_cf_phys >= lo_eff - eps).all() and (got.x_cf_phys <= hi_eff + eps).all()


def test_box_edge_rows_take_the_balanced_clip_gradient(model):
    """Rows at the training extrema sit exactly on the box: jnp.clip's
    gradient there is split in half (max/min ties), as torch.maximum/minimum
    split it; the trajectories agree step by step from the first."""
    x, v = _rows(model)
    x = x[:24].copy()
    for k in range(8):
        x[3 * k, k] = float(model.sx.data_min[k])
        x[3 * k + 1, k] = float(model.sx.data_max[k])
    for steps in (1, 3, 12):
        got, want = _both(model, x, v[:24] + 0.4, steps, v_meas=v[:24])
        _same_report(got, want)


def test_zero_span_channel_frozen_even_if_requested(model):
    from pinnfc_tpu.data.scaling import AffineScaler as JaxScaler
    from pinnfc_tpu_torch.data.scaling import AffineScaler

    x, v = _rows(model)
    x = x[:30].copy()
    k = INPUT_CHANNELS.index("h2_flow")
    x[:, k] = 25.0
    sx = AffineScaler.fit(x, device="cpu")
    jsx = JaxScaler.fit(x)
    cfg = dict(actuatable=("h2_flow", "air_flow"), v_meas=v[:30])
    got = cf.counterfactual_recovery(model.tp, x, v[:30] + 0.5, sx, model.sy,
                                     config=cf.CounterfactualConfig(steps=20), device="cpu",
                                     **cfg)
    want = jax_cf.counterfactual_recovery(model.jp, x, v[:30] + 0.5, jsx, model.jds.scaler_y,
                                          config=jax_cf.CounterfactualConfig(steps=20), **cfg)
    _same_report(got, want)
    assert not got.actuatable[k]
    np.testing.assert_array_equal(got.x_cf_phys[:, k], 25.0)


def test_gain_mode_equals_absolute_when_meas_equals_model(model):
    x, _ = _rows(model)
    x = x[:60]
    absolute = cf.counterfactual_recovery(model.tp, x, 3.5, model.sx, model.sy,
                                          config=cf.CounterfactualConfig(steps=30), device="cpu")
    gain = cf.counterfactual_recovery(model.tp, x, 3.5, model.sx, model.sy,
                                      config=cf.CounterfactualConfig(steps=30), device="cpu",
                                      v_meas=absolute.v_before)
    np.testing.assert_allclose(gain.delta_phys, absolute.delta_phys, atol=2e-4)
    np.testing.assert_allclose(gain.v_expected, gain.v_meas + (gain.v_after - gain.v_before),
                               atol=1e-6)


def test_bad_arguments_raise(model):
    x, _ = _rows(model)
    with pytest.raises(ValueError, match="x_phys must be"):
        cf.counterfactual_recovery(model.tp, x[:, :5], 3.0, model.sx, model.sy, device="cpu")
    with pytest.raises(ValueError, match="unknown channels"):
        cf.actuatable_mask(("air_flow", "warp_core"))
    np.testing.assert_array_equal(cf.actuatable_mask(cf.DEFAULT_ACTUATABLE),
                                  jax_cf.actuatable_mask(jax_cf.DEFAULT_ACTUATABLE))
    with pytest.raises(ValueError, match="target must be"):
        cf.condition_recovery(model.arr, model.tp, model.sx, model.sy, target="bogus",
                              device="cpu")


@pytest.mark.parametrize("target", ["gain", "absolute"])
def test_condition_recovery_and_summary_match_jax(model, target):
    """All 12 conditions of the miniature artifact alarm; one batched solve
    over ≤ 8 rows each, sliced per condition; the summaries as JAX's."""
    kw = dict(max_rows=8, target=target)
    got = cf.condition_recovery(model.arr, model.tp, model.sx, model.sy,
                                config=cf.CounterfactualConfig(steps=40), device="cpu", **kw)
    want = jax_cf.condition_recovery(model.arr, model.jp, model.jds.scaler_x,
                                     model.jds.scaler_y,
                                     config=jax_cf.CounterfactualConfig(steps=40), **kw)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert (g.fault_name, g.current_target, g.v_threshold, g.idx_v_alarm, g.n_rows) == \
            (w.fault_name, w.current_target, w.v_threshold, w.idx_v_alarm, w.n_rows)
        assert g.n_rows == 8
        _same_report(g.report, w.report)
        gs, ws = cf.summarize_recovery(g.report), jax_cf.summarize_recovery(w.report)
        assert list(gs) == list(ws)
        for key in ("dominant", "dominant_index", "n_moved", "recovered_frac"):
            assert gs[key] == ws[key], key
        for key in ("mean_delta_range", "mean_delta_phys"):
            np.testing.assert_allclose(gs[key], ws[key], rtol=1e-4, atol=2e-5)


def test_summarize_recovery_edges(model):
    x, v = _rows(model)
    rep = cf.counterfactual_recovery(model.tp, x[:10], v[:10] - 5, model.sx, model.sy,
                                     config=cf.CounterfactualConfig(steps=5), device="cpu",
                                     v_meas=v[:10])
    got, want = cf.summarize_recovery(rep), jax_cf.summarize_recovery(rep)
    assert got["dominant"] is None and got["dominant_index"] == -1 and got["n_moved"] == 0
    assert got["recovered_frac"] == want["recovered_frac"] == 1.0
    np.testing.assert_array_equal(got["mean_delta_range"], want["mean_delta_range"])


# ---- cli whatif ----

def _jax_whatif(model, **kw):
    args = dict(ckpt=model.ckpt, mat=model.mat, steps=40, lr=0.05, alpha=0.05, margin=0.01,
                actuate=None, max_rows=8, absolute_target=False, json=False, plot_dir=None,
                data_parallel=False)
    args.update(kw)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = jax_explain.cmd_whatif(argparse.Namespace(**args))
    return rc, buf.getvalue()


def _port_whatif(capsys, model, *extra):
    capsys.readouterr()
    rc = cli.main(["whatif", "--ckpt", model.ckpt, "--mat", model.mat, "--steps", "40",
                   "--max-rows", "8", "--device", "cpu", *extra])
    return rc, capsys.readouterr().out


def _mask(text):
    return [re.sub(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?", "#", ln) for ln in text.splitlines()]


@pytest.mark.parametrize("extra,kw", [
    ([], {}),
    (["--absolute-target"], dict(absolute_target=True)),
    (["--actuate", "air_flow,p_air_in", "--alpha", "0.01"],
     dict(actuate="air_flow,p_air_in", alpha=0.01)),
])
def test_cli_whatif_matches_jax(model, capsys, extra, kw):
    rc, out = _port_whatif(capsys, model, *extra, "--json")
    jrc, jout = _jax_whatif(model, json=True, **kw)
    assert rc == jrc == 0
    got, want = json.loads(out), json.loads(jout)
    assert {k: got[k] for k in ("unit", "target_mode", "channels")} == \
        {k: want[k] for k in ("unit", "target_mode", "channels")}
    assert len(got["conditions"]) == len(want["conditions"]) == 12
    for g, w in zip(got["conditions"], want["conditions"]):
        assert list(g) == list(w)
        for key in ("fault", "current", "v_threshold", "alarmed", "n_rows", "dominant",
                    "recovered_frac"):
            assert g[key] == w[key], key
        if "mean_short_v" in w:
            assert g["mean_short_v"] == pytest.approx(w["mean_short_v"], rel=1e-6)
        np.testing.assert_allclose(g["mean_delta_range"], w["mean_delta_range"], atol=2e-5)
    rc, out = _port_whatif(capsys, model, *extra)
    _, jout = _jax_whatif(model, **kw)
    assert rc == 0 and _mask(out) == _mask(jout)
    # the knob column names the same channel on every row
    assert [ln.split("  ")[-1].split(" (")[0] for ln in out.splitlines()[2:]] == \
        [ln.split("  ")[-1].split(" (")[0] for ln in jout.splitlines()[2:]]


def test_cli_whatif_errors(model, capsys):
    assert cli.main(["whatif", "--ckpt", model.bare, "--mat", model.mat, "--device",
                     "cpu"]) == 2
    assert "no stored scalers" in capsys.readouterr().err
    assert _jax_whatif(model, ckpt=model.bare)[0] == 2
    assert cli.main(["whatif", "--ckpt", model.ckpt, "--mat", model.mat, "--device", "cpu",
                     "--actuate", "warp_core", "--steps", "2"]) == 1
    assert "unknown channels" in capsys.readouterr().err


def test_cli_whatif_plot_dir(model, tmp_path, monkeypatch):
    """``--plot-dir``: JAX's file name and figure at rtol 1e-6, the JAX
    command drawing the port's recovery table (held to JAX's above)."""
    import pinnfc_tpu.uq as jax_uq

    recs = cf.condition_recovery(model.arr, model.tp, model.sx, model.sy,
                                 config=cf.CounterfactualConfig(steps=40), max_rows=8,
                                 device="cpu")
    monkeypatch.setattr(jax_uq, "condition_recovery", lambda *a, **k: recs)
    with captured(monkeypatch, jax_plots, save=False) as want:
        assert _jax_whatif(model, plot_dir=str(tmp_path / "j"))[0] == 0
    with captured(monkeypatch, plots) as got, contextlib.redirect_stdout(io.StringIO()) as buf:
        assert cli.main(["whatif", "--ckpt", model.ckpt, "--mat", model.mat, "--steps", "40",
                         "--max-rows", "8", "--device", "cpu", "--plot-dir",
                         str(tmp_path / "p")]) == 0
    assert f"figures → {tmp_path / 'p'}/whatif_actuation.png" in buf.getvalue()
    assert sorted(os.listdir(tmp_path / "p")) == sorted(want) == ["whatif_actuation.png"]
    same(got, want, 1e-6)


def test_cli_whatif_runs_without_jax(model, tmp_path):
    """``whatif --json`` in a process in which jax and matplotlib cannot be
    imported, and ``--plot-dir`` there exiting 1 naming matplotlib."""
    code = (
        "import json, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from pinnfc_tpu_torch.cli import main\n"
        "base = json.loads(sys.argv[1])\n"
        "rc = main(base + ['--json'])\n"
        "print(f'RC {rc}', flush=True)\n"
        "rc = main(base + ['--plot-dir', sys.argv[2]])\n"
        "print(f'RC {rc}', flush=True)\n"
        "assert not [m for m in sys.modules if m == 'pinnfc_tpu' or m.startswith('pinnfc_tpu.')]\n"
    )
    base = ["whatif", "--ckpt", model.ckpt, "--mat", model.mat, "--steps", "40",
            "--max-rows", "8", "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(base), str(tmp_path / "f")],
                          cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc, rest = proc.stdout.split("RC 0\n", 1)
    assert rest.splitlines()[-1] == "RC 1" and "matplotlib" in proc.stderr
    _, want = _jax_whatif(model, json=True)
    got, want = json.loads(doc), json.loads(want)
    assert [c["dominant"] for c in got["conditions"]] == \
        [c["dominant"] for c in want["conditions"]]
