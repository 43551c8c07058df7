"""Port parity: the streaming monitor and the fleet replay
(pinnfc_tpu_torch.serving) and the ``monitor`` command line, against the JAX
package's, on the CPU with the shared miniature model
(tests/_torch_explain_model.py: 8→32→32→1 on a 660-row synthetic campaign,
i_l = 1.2 so that rows past the limiting current have a NaN voltage
residual and glitch).  The artifact's residual columns are the model's own
(y_pred off the eval pass by 1 mV of noise, as an MC mean is), with the
normal rows' spread shrunk threefold about its median so that the faults
warn: μ/σ come from them as ``cli monitor`` takes them.

Tolerances, per ``MonitorOutput`` field, against JAX on the same blocks:
- residuals, v_pred, layer_scores: rtol 1e-5, atol 1e-5 (one float32
  forward and the same residual arithmetic in each; XLA contracts some
  products into FMAs);
- rf_inst, rf_smooth: atol 2e-6; layer_c: rtol 1e-5, atol 1e-4 (the port
  runs the recurrences as doubling scans, JAX as a sequential scan: they
  differ by rounding only);
- fault_probs: atol 1e-3, fault_pred equal where the top posterior leads
  by more than 2e-3 (the mixture's tight components amplify the features'
  float32 rounding: pT runs to |600| here);
- conformal_p: the ranks (p·(n+1)) equal, the values within 1 ulp (XLA
  divides by the constant n+1 through its reciprocal); aci_alpha: atol
  1e-6 (float32 on the host; XLA fuses a multiply-add);
- every flag equal, except warn/danger on samples whose rf_smooth lies
  within 1e-5 of the threshold (none do here);
- NaN sets equal in every float field, dtypes and shapes equal.
Two runs of the port compared with each other (save/load, block sizes,
``observe_many``) are held bitwise where the arithmetic is the same and at
the tolerances above where the scan order changes.
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinnfc_tpu.cli import serve as jax_serve
from pinnfc_tpu.diagnosis import gmm as jax_gmm
from pinnfc_tpu.diagnosis import gmm_pipeline as jax_gmm_pipeline
from pinnfc_tpu.models.mlp import mlp_forward as jax_mlp_forward
from pinnfc_tpu.physics.residuals import all_residuals as jax_all_residuals
from pinnfc_tpu.serving import monitor as jax_monitor
from pinnfc_tpu.serving import replay as jax_replay
from pinnfc_tpu_torch import cli
from pinnfc_tpu_torch.data.contract import INDEX, save_comprehensive_results
from pinnfc_tpu_torch.diagnosis import gmm, run_gmm_pipeline
from pinnfc_tpu_torch.physics.residuals import all_residuals
from pinnfc_tpu_torch.risk import estimate_mu_sigma_normal
from pinnfc_tpu_torch.serving import monitor, replay
from pinnfc_tpu_torch.utils.threads import one_thread

from _torch_explain_model import explain_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOATS = {"residuals": (1e-5, 1e-5), "v_pred": (1e-5, 1e-5), "layer_scores": (1e-5, 1e-5),
          "rf_inst": (0, 2e-6), "rf_smooth": (0, 2e-6), "layer_c": (1e-5, 1e-4),
          "fault_probs": (0, 1e-3), "aci_alpha": (0, 1e-6)}
FLAGS = ("warn", "danger", "v_alarm", "glitch", "sensor_alarm", "oob", "aci_anomaly")


@pytest.fixture(autouse=True)
def _pinned():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def mon(tmp_path_factory):
    """The miniature model with an artifact whose res/pV/pT/pH/pO, y_pred and
    physics columns are the model's own (as the exporter writes them), its
    .mat file, and μ/σ of its normal rows."""
    root = tmp_path_factory.mktemp("monitor")
    m = explain_model(root)
    u, _ = jax_mlp_forward(m.jp["mlp"], m.x_norm, train=False)
    b = jax_all_residuals(m.jp, m.x_norm, u, m.jds.scaler_x, m.jds.scaler_y)
    arr = m.arr.copy()
    arr[:, INDEX["y_pred"]] = (np.asarray(m.jds.scaler_y.inverse(np.asarray(u)))[:, 0]
                               + 1e-3 * np.random.RandomState(3).randn(len(arr)))
    arr[:, INDEX["res"]] = arr[:, INDEX["y_true"]] - arr[:, INDEX["y_pred"]]
    for key, col in (("pV", b.f_v), ("pT", b.f_t), ("pH", b.f_h), ("pO", b.f_o),
                     ("v_phys", b.v_phys_stack), ("t_phys", b.t_phys),
                     ("ratio_H", b.ratio_h), ("ratio_O", b.ratio_o)):
        arr[:, INDEX[key]] = np.asarray(col)[:, 0]
    normal = m.labels == 0
    for key in ("res", "pV", "pT", "pH", "pO"):
        col = arr[normal, INDEX[key]]
        med = np.nanmedian(col)
        arr[normal, INDEX[key]] = med + 0.3 * (col - med)
    mat = str(root / "F01_monitor.mat")
    save_comprehensive_results(arr, mat)
    mu, sigma = estimate_mu_sigma_normal(arr)
    return argparse.Namespace(
        m=m, arr=arr, mat=mat, mu=mu, sigma=sigma, root=root,
        x=arr[:, :8].astype(np.float32), v=arr[:, INDEX["y_true"]].astype(np.float32),
        calib=np.abs(arr[(m.labels == 0) & np.isfinite(arr[:, INDEX["res"]]),
                         INDEX["res"]]).astype(np.float32),
        # normal rows below the limiting current: no glitch of their own
        clean=np.flatnonzero(normal & np.isfinite(arr[:, INDEX["pV"]])))


def _pair(mon, sigma=None, **kw):
    """(port monitor on the CPU, JAX monitor) with the same options; a
    ``head`` is a (port head, JAX head) pair."""
    port_kw, jax_kw = dict(kw), dict(kw)
    if "head" in kw:
        port_kw["diagnosis"], jax_kw["diagnosis"] = kw["head"]
        del port_kw["head"], jax_kw["head"]
    m = mon.m
    sigma = mon.sigma if sigma is None else sigma
    return (monitor.OnlineMonitor(m.tp, m.sx, m.sy, mon.mu, sigma, device="cpu", **port_kw),
            jax_monitor.OnlineMonitor(m.jp, m.jds.scaler_x, m.jds.scaler_y, mon.mu, sigma,
                                      **jax_kw))


def _same_out(got, want, cfg=monitor.RiskConfig(), n_calib=None):
    for f in FLOATS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if b is None:
            continue
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        rtol, atol = FLOATS[f]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, equal_nan=True, err_msg=f)
    near = np.zeros(len(got.rf_smooth), bool)
    for thr in (cfg.warn_threshold, cfg.danger_threshold):
        near |= np.abs(np.asarray(want.rf_smooth) - thr) <= 1e-5
    for f in FLAGS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if b is None:
            continue
        b = np.asarray(b)
        assert a.dtype == b.dtype == bool, f
        keep = ~near if f in ("warn", "danger") else slice(None)
        np.testing.assert_array_equal(a[keep], b[keep], err_msg=f)
    assert (got.conformal_p is None) == (want.conformal_p is None)
    if want.conformal_p is not None:
        a, b = got.conformal_p, np.asarray(want.conformal_p)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.rint(a[fin] * (n_calib + 1)),
                                      np.rint(b[fin] * (n_calib + 1)))
        np.testing.assert_array_max_ulp(a[fin], b[fin], maxulp=1)
    assert (got.fault_pred is None) == (want.fault_pred is None)
    if want.fault_pred is not None:
        b = np.asarray(want.fault_pred)
        assert got.fault_pred.dtype == b.dtype == np.int32
        p = np.sort(np.nan_to_num(np.asarray(want.fault_probs), nan=0.0), axis=1)
        clear = (p[:, -1] - p[:, -2] > 2e-3) | (b < 0)
        np.testing.assert_array_equal(got.fault_pred[clear], b[clear])


STATE_TOL = {"c": (1e-5, 1e-4), "layer_c": (1e-5, 1e-4), "rf_smooth": (0, 2e-6),
             "aci_alpha": (0, 1e-6)}


def _same_state(got, want, exact=False):
    """Two carried states: dtypes and shapes equal; v_first, the flags and
    the counters equal; the recurrences' values at the outputs' tolerances
    (or bitwise with ``exact``)."""
    for f in monitor.MonitorState._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if exact or f not in STATE_TOL:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            rtol, atol = STATE_TOL[f]
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f)


def _replay(mon_pair, x, v, block, stream="default"):
    """Feed both monitors the same blocks; hold every block's outputs and
    the final state."""
    port, ref = mon_pair
    outs = []
    for lo in range(0, len(x), block):
        got = port.observe(x[lo:lo + block], v[lo:lo + block], stream=stream)
        want = ref.observe(x[lo:lo + block], v[lo:lo + block], stream=stream)
        _same_out(got, want, n_calib=None if port.conformal_calib is None
                  else len(port.conformal_calib))
        outs.append(got)
    _same_state(port._streams[stream], jax.device_get(ref._streams[stream]))
    return outs


# ---- the residual kernel's contract on non-finite inputs ----

@pytest.mark.parametrize("kind", ["nan", "+inf", "-inf", "nan u"])
def test_plain_residuals_give_jax_nan_sets_on_nonfinite_rows(mon, kind):
    """The port's plain ``all_residuals`` (the residual kernel's contract,
    chip_smoke.py phase 3) against JAX's on rows with NaN, +inf or -inf in
    each input channel in turn, or a NaN network output: NaN sets equal,
    values within rtol 2e-5 (inf where inf)."""
    m = mon.m
    x = np.array(m.x_norm[:16], np.float32)
    u = np.array(jax_mlp_forward(m.jp["mlp"], x, train=False)[0], np.float32)
    bad = {"nan": np.nan, "+inf": np.inf, "-inf": -np.inf}
    if kind == "nan u":
        u[[1, 6, 11]] = np.nan
    else:
        for ch in range(8):
            x[2 * ch, ch] = bad[kind]
    want = jax_all_residuals(m.jp, x, u, m.jds.scaler_x, m.jds.scaler_y)
    got = all_residuals(m.tp, torch.from_numpy(x), torch.from_numpy(u), m.sx, m.sy)
    for name, a, b in zip(got._fields, got, want):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5, equal_nan=True, err_msg=name)
    # a NaN stack current leaves the gas ratios NaN (fmaxf would make them finite)
    if kind == "nan":
        assert np.isnan(got.ratio_h.numpy()[0, 0]) and np.isnan(got.ratio_o.numpy()[0, 0])


# ---- the monitor against JAX ----

@pytest.mark.parametrize("case", ["plain block 64", "head, conformal ACI, block 37"])
def test_observe_matches_jax_block_by_block(mon, case):
    kw = {}
    if case.startswith("head"):
        head = _heads(mon)
        kw = dict(head=head, conformal_calib=mon.calib, conformal_alpha=0.2,
                  conformal_gamma=0.01, glitch_alarm_n=5)
    pair = _pair(mon, **kw)
    outs = _replay(pair, mon.x, mon.v, 64 if case.startswith("plain") else 37)
    cat = {f: np.concatenate([getattr(o, f) for o in outs]) for f in ("glitch", "warn")}
    # rows past the limiting current glitch; the campaign warns
    assert cat["glitch"].any() and not cat["glitch"].all() and cat["warn"].any()
    assert pair[0].stream_low_p() == pair[1].stream_low_p()
    assert pair[0].stream_aci_alpha() == pytest.approx(pair[1].stream_aci_alpha(), abs=1e-6)
    np.testing.assert_array_equal(pair[0].stream_oob_counts(), pair[1].stream_oob_counts())


def test_block_size_invariance(mon):
    """1 × 400 and 8 × 50 give the same series (the carried recurrences),
    and each equals JAX's."""
    x, v = mon.x[:400], mon.v[:400]
    one = _pair(mon)
    whole = _replay(one, x, v, 400)[0]
    eight = _pair(mon)
    parts = _replay(eight, x, v, 50)
    for f in ("rf_inst", "rf_smooth", "layer_c", "residuals", "v_pred"):
        np.testing.assert_allclose(np.concatenate([getattr(p, f) for p in parts]),
                                   getattr(whole, f), rtol=1e-5, atol=2e-5, err_msg=f)
    for f in FLAGS[:6]:
        np.testing.assert_array_equal(np.concatenate([getattr(p, f) for p in parts]),
                                      getattr(whole, f), err_msg=f)


def test_layer_c_sums_to_c(mon):
    port, _ = _pair(mon)
    for lo in range(0, 660, 110):
        out = port.observe(mon.x[lo:lo + 110], mon.v[lo:lo + 110])
        assert out.layer_c.shape == (110, 3)
        np.testing.assert_allclose(out.layer_c[-1].sum(), port.state.c, rtol=1e-5)
        np.testing.assert_array_equal(out.layer_c[-1], port.state.layer_c)
    assert port.layer_names == ("voltage", "gas", "temp")


def _tiny_heads():
    """A 2-component head over (pV, pT) in both packages."""
    w, mu_, cov = [0.5, 0.5], [[0.0, 0.0], [1.0, 1.0]], [np.eye(2), np.eye(2)]
    comp = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    port = monitor.DiagnosisHead(
        gmm=gmm.GMMParams(torch.tensor(w), torch.tensor(mu_), torch.tensor(
            np.array(cov, np.float32)), True, 3, -1.0),
        comp_fault_prob=torch.from_numpy(comp), class_names=("normalish", "faultish"),
        feature_indices=(1, 2))
    ref = jax_monitor.DiagnosisHead(
        gmm=jax_gmm.GMMParams(jnp.asarray(w), jnp.asarray(mu_), jnp.asarray(np.array(cov)),
                              jnp.asarray(True), jnp.asarray(3), jnp.asarray(-1.0)),
        comp_fault_prob=jnp.asarray(comp), class_names=("normalish", "faultish"),
        feature_indices=(1, 2))
    return port, ref


GLITCH_CASES = ["nan row mid-stream", "glitch run flagged", "voltage-only outage",
                "sensor alarm across blocks", "v_first defers in block",
                "v_first defers across blocks", "glitches vote -1", "nan current",
                "inf is glitch not drift"]


@pytest.mark.parametrize("case", GLITCH_CASES)
def test_glitch_cases_match_jax(mon, case):
    """The glitch cases of tests/test_serving.py:812-1012 on both packages:
    the outputs equal block by block, and the case's own property."""
    x, v = mon.x[mon.clean][:120].copy(), mon.v[mon.clean][:120].copy()
    kw, block = {}, 40
    if case == "nan row mid-stream":
        x[40] = np.nan
    elif case == "glitch run flagged":
        x[30:35] = np.nan
    elif case == "voltage-only outage":
        v[10:17] = np.nan
        kw = dict(glitch_alarm_n=5)
    elif case == "sensor alarm across blocks":
        x[20:32], v[20:32] = np.nan, np.nan
        kw, block = dict(glitch_alarm_n=10), 6
    elif case == "v_first defers in block":
        v[:3] = np.nan
    elif case == "v_first defers across blocks":
        v[:4] = np.nan
        block = 4
    elif case == "glitches vote -1":
        x[4] = np.nan
        kw = dict(head=_tiny_heads())
    elif case == "nan current":
        x[[5, 50, 95], 0] = np.nan
    else:
        x[7, 3], x[60, 6] = np.inf, -np.inf
    pair = _pair(mon, **kw)
    outs = _replay(pair, x, v, block)
    got = {f: np.concatenate([getattr(o, f) for o in outs])
           for f in ("glitch", "sensor_alarm", "v_alarm", "rf_smooth", "oob", "residuals")}
    port = pair[0]
    if case == "nan row mid-stream":
        assert np.isfinite(got["rf_smooth"][41:]).all()
    elif case == "glitch run flagged":
        assert got["glitch"][30:35].all() and not got["sensor_alarm"].any()
    elif case == "voltage-only outage":
        assert got["glitch"][10:17].all() and got["sensor_alarm"][14:17].all()
        assert not got["sensor_alarm"][:14].any() and not got["sensor_alarm"][17:].any()
    elif case == "sensor alarm across blocks":
        assert not got["sensor_alarm"][:29].any() and got["sensor_alarm"][29:32].all()
        assert not got["sensor_alarm"][32:].any()
    elif case == "v_first defers in block":
        assert not got["v_alarm"][:3].any() and port.state.v_first == v[3]
    elif case == "v_first defers across blocks":
        assert port.state.v_first_set and port.state.v_first == v[4]
    elif case == "glitches vote -1":
        pred = np.concatenate([o.fault_pred for o in outs])
        assert pred[4] == -1 and (np.delete(pred, np.flatnonzero(got["glitch"])) >= 0).all()
    elif case == "nan current":
        # the voltage and gas residuals NaN, as in JAX; the row glitches
        assert np.isnan(got["residuals"][[5, 50, 95]][:, [1, 3, 4]]).all()
        assert got["glitch"][[5, 50, 95]].all()
    else:
        assert got["glitch"][[7, 60]].all() and not got["oob"][[7, 60]].any()


def test_aci_level_and_anomaly_counter_match_jax(mon):
    """γ > 0: the adaptive level α_t, run on the host in float32, against
    JAX's scan over a stream with a fault segment, in blocks of 64."""
    pair = _pair(mon, conformal_calib=mon.calib, conformal_alpha=0.1, conformal_gamma=0.05)
    outs = _replay(pair, mon.x, mon.v, 64)
    a = np.concatenate([o.aci_alpha for o in outs])
    assert a.min() < 0.1 - 0.05 and np.concatenate([o.aci_anomaly for o in outs]).any()
    assert pair[0].stream_low_p() == pair[1].stream_low_p() > 0


def test_drift_counter_matches_jax(mon):
    x, v = mon.x[:96].copy(), mon.v[:96]
    span = mon.m.sx.data_max.numpy() - mon.m.sx.data_min.numpy()
    x[10:20, 1] = mon.m.sx.data_max.numpy()[1] + 0.1 * span[1]
    x[50:53, 7] = mon.m.sx.data_min.numpy()[7] - 0.1 * span[7]
    pair = _pair(mon)
    outs = _replay(pair, x, v, 32)
    counts = pair[0].stream_oob_counts()
    assert counts[1] >= 10 and counts[7] >= 3 and counts.dtype == np.int64
    assert np.concatenate([o.oob for o in outs])[[10, 19, 50, 52]].all()
    np.testing.assert_array_equal(pair[0].stream_oob_counts("other"), np.zeros(8, np.int64))


def test_monitor_validates_its_arguments(mon):
    m = mon.m
    for bad, match in ((dict(glitch_alarm_n=0), "glitch_alarm_n"),
                       (dict(conformal_calib=[]), "non-empty"),
                       (dict(conformal_calib=[np.nan]), "finite"),
                       (dict(conformal_calib=[1.0], conformal_alpha=1.0), "conformal_alpha"),
                       (dict(conformal_gamma=0.1), "conformal_calib"),
                       (dict(conformal_calib=[1.0], conformal_gamma=1.0), "conformal_gamma")):
        with pytest.raises(ValueError, match=match):
            monitor.OnlineMonitor(m.tp, m.sx, m.sy, mon.mu, mon.sigma, device="cpu", **bad)
    port, _ = _pair(mon)
    with pytest.raises(ValueError, match="x_bank"):
        port.observe_many(mon.x[:8], mon.v[:8], ["a"])
    with pytest.raises(ValueError, match="unique"):
        port.observe_many(np.stack([mon.x[:8]] * 2), np.stack([mon.v[:8]] * 2), ["a", "a"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            monitor.OnlineMonitor(m.tp, m.sx, m.sy, mon.mu, mon.sigma)


# ---- diagnosis head ----

def _heads(mon):
    """(port head, JAX head) of one mixture: the port's GMM fit, saved by the
    port, loaded by JAX."""
    if not hasattr(mon, "heads"):
        port = monitor.DiagnosisHead.from_gmm_result(run_gmm_pipeline(mon.arr, device="cpu"))
        path = port.save(str(mon.root / "port_head"))
        mon.heads = (port, jax_monitor.DiagnosisHead.load(path))
    return mon.heads


@pytest.mark.parametrize("direction", ["port to jax", "jax to port"])
def test_diagnosis_head_npz_crosses_packages(mon, direction, tmp_path):
    """A head saved by either package loads in the other with the same keys,
    dtypes and values, and both monitors diagnose the same."""
    if direction == "port to jax":
        port, ref = _heads(mon)
        saved = port.save(str(tmp_path / "h"))
        again = jax_monitor.DiagnosisHead.load(saved).save(str(tmp_path / "again"))
    else:
        result = jax_gmm_pipeline.run_gmm_pipeline(mon.arr)
        ref = jax_monitor.DiagnosisHead.from_gmm_result(result)
        saved = ref.save(str(tmp_path / "h"))
        port = monitor.DiagnosisHead.load(saved, device="cpu")
        again = port.save(str(tmp_path / "again"))
    a, b = np.load(saved), np.load(again)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert port.class_names == tuple(ref.class_names)
    assert port.feature_indices == tuple(ref.feature_indices) == (1, 2, 3, 4)
    _replay(_pair(mon, head=(port, ref)), mon.x, mon.v, 110)


def test_diagnosis_head_validation(mon, tmp_path):
    result = run_gmm_pipeline(mon.arr, device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        monitor.DiagnosisHead.from_gmm_result(result, features="pV,pT")
    result.features = "pV,epi"
    with pytest.raises(ValueError, match="not streamable"):
        monitor.DiagnosisHead.from_gmm_result(result)
    path = _heads(mon)[0].save(str(tmp_path / "h"))
    for key, value, match in (("feature_indices", np.array([1, 9], np.int32), "outside"),
                              ("class_names", np.array(["a"]), "class names"),
                              ("gmm_means", np.zeros((20, 3), np.float32), "means shape")):
        payload = dict(np.load(path))
        payload[key] = value
        bad = str(tmp_path / f"bad_{key}.npz")
        np.savez(bad, **payload)
        with pytest.raises(ValueError, match=match):
            monitor.DiagnosisHead.load(bad, device="cpu")


# ---- fleets and the state bank ----

def test_observe_many_equals_observe(mon):
    """S = 3 streams × B = 40 in one step against three single-stream
    monitors (and against JAX's vmapped step)."""
    port, ref = _pair(mon, conformal_calib=mon.calib, conformal_gamma=0.02)
    single, _ = _pair(mon, conformal_calib=mon.calib, conformal_gamma=0.02)
    keys = ["a", "b", "c"]
    for rnd in range(3):
        lo = [rnd * 40, 300 + rnd * 40, 500 + rnd * 40]
        xb = np.stack([mon.x[s:s + 40] for s in lo])
        vb = np.stack([mon.v[s:s + 40] for s in lo])
        got = port.observe_many(xb, vb, keys)
        want = ref.observe_many(xb, vb, keys)
        for i, k in enumerate(keys):
            one = single.observe(xb[i], vb[i], stream=k)
            _same_out(got[k], want[k], n_calib=len(mon.calib))
            _same_out(got[k], one, n_calib=len(mon.calib))
    for k in keys:
        _same_state(port._streams[k], single._streams[k])
        _same_state(port._streams[k], jax.device_get(ref._streams[k]))
        assert port.stream_n_seen(k) == 120
    assert port.n_seen == 360


def test_state_bank_round_trip_is_bitwise(mon, tmp_path):
    ref, _ = _pair(mon, conformal_calib=mon.calib, conformal_gamma=0.02)
    port, _ = _pair(mon, conformal_calib=mon.calib, conformal_gamma=0.02)
    for m_ in (ref, port):
        m_.observe(mon.x[:64], mon.v[:64], stream="a")
        m_.observe(mon.x[300:364], mon.v[300:364], stream="b")
    path = port.save_state_bank(str(tmp_path / "bank"))
    assert path.endswith(".npz") and not any(p.name.endswith(".tmp.npz")
                                             for p in tmp_path.iterdir())
    again, _ = _pair(mon, conformal_calib=mon.calib, conformal_gamma=0.02)
    again.load_state_bank(path)
    assert set(again.streams) == {"default", "a", "b"} and again.n_seen == ref.n_seen
    for s in ("a", "b"):
        _same_state(again._streams[s], ref._streams[s], exact=True)
        want = ref.observe(mon.x[364:430], mon.v[364:430], stream=s)
        got = again.observe(mon.x[364:430], mon.v[364:430], stream=s)
        for f in ("rf_smooth", "rf_inst", "layer_c", "conformal_p", "aci_alpha"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert again.stream_low_p(s) == ref.stream_low_p(s)


@pytest.mark.parametrize("direction", ["port to jax", "jax to port"])
def test_state_bank_crosses_packages(mon, tmp_path, direction):
    """A bank saved by either package has the other's keys and dtypes, loads
    into the other, and the streams continue as in the package that saved
    it."""
    port, ref = _pair(mon, conformal_calib=mon.calib, conformal_gamma=0.02)
    for m_ in (port, ref):
        m_.observe(mon.x[:64], mon.v[:64], stream="a")
        m_.observe(mon.x[400:464], mon.v[400:464], stream="b")
    p_path = port.save_state_bank(str(tmp_path / "port"))
    j_path = ref.save_state_bank(str(tmp_path / "jax"))
    a, b = np.load(p_path), np.load(j_path)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    saver, loader = (port, _pair(mon, conformal_calib=mon.calib, conformal_gamma=0.02)[1]) \
        if direction == "port to jax" else \
        (ref, _pair(mon, conformal_calib=mon.calib, conformal_gamma=0.02)[0])
    loader.load_state_bank(p_path if direction == "port to jax" else j_path)
    for s in ("a", "b"):
        _same_state(jax.device_get(loader._streams[s]), jax.device_get(saver._streams[s]),
                    exact=True)
        got = loader.observe(mon.x[464:530], mon.v[464:530], stream=s)
        want = saver.observe(mon.x[464:530], mon.v[464:530], stream=s)
        if direction == "port to jax":
            got, want = want, got
        _same_out(got, want, n_calib=len(mon.calib))


def test_state_bank_older_snapshot_and_validation(mon, tmp_path, capsys):
    ref, _ = _pair(mon)
    port, _ = _pair(mon)
    for m_ in (ref, port):
        m_.observe(mon.x[:64], mon.v[:64], stream="a")
    path = port.save_state_bank(str(tmp_path / "bank"))
    payload = dict(np.load(path))
    for f in ("state_layer_c", "state_oob_count", "state_aci_alpha", "low_p"):
        del payload[f]
    old = str(tmp_path / "old.npz")
    np.savez(old, **payload)
    again, jref = _pair(mon)
    again.load_state_bank(old)
    jref.load_state_bank(old)
    err = capsys.readouterr().err
    assert "layer_c" in err and "oob_count" in err and "aci_alpha" in err
    _same_state(again._streams["a"], jax.device_get(jref._streams["a"]), exact=True)
    np.testing.assert_array_equal(again._streams["a"].layer_c, np.zeros(3, np.float32))
    assert again.stream_low_p("a") == 0
    out_ref = ref.observe(mon.x[64:128], mon.v[64:128], stream="a")
    out_new = again.observe(mon.x[64:128], mon.v[64:128], stream="a")
    np.testing.assert_array_equal(out_new.rf_smooth, out_ref.rf_smooth)
    for key, change, match in (("state_c", None, "missing"),
                               ("n_seen", lambda a: a[:0], "n_seen"),
                               ("state_rf_smooth", lambda a: a[:, None], "state_rf_smooth"),
                               ("streams", lambda a: np.array(["a", "a"]), "duplicate")):
        payload = dict(np.load(path))
        if change is None:
            del payload[key]
        else:
            payload[key] = change(payload[key])
        bad = str(tmp_path / f"bad_{key}.npz")
        np.savez(bad, **payload)
        with pytest.raises(ValueError, match=match):
            again.load_state_bank(bad)


def test_fleet_replay_matches_jax(mon):
    """The 12 conditions as concurrent streams in blocks of 8 (lockstep
    observe_many rounds, one partial observe per stream) against JAX's
    replay: the same table, first alarms within one sample where an RF
    threshold crossing lies within 1e-5, shares within 1e-5; every stream's
    carried state as JAX's."""
    port, ref = _pair(mon, sigma=mon.sigma / 3)  # 30-row streams: a tighter band warns
    got = replay.fleet_replay(port, mon.arr, block=8)
    want = jax_replay.fleet_replay(ref, mon.arr, block=8)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert (g.stream, g.fault_name, g.current_target, g.n_samples) == \
            (w.stream, w.fault_name, w.current_target, w.n_samples)
        assert g.first_v_alarm == w.first_v_alarm and g.first_warn == w.first_warn
        assert g.first_danger == w.first_danger and g.advance == w.advance
        assert list(g.layer_shares) == list(w.layer_shares)
        np.testing.assert_allclose(list(g.layer_shares.values()),
                                   list(w.layer_shares.values()), atol=1e-5)
        _same_state(port._streams[g.stream], jax.device_get(ref._streams[g.stream]))
    assert sum(r.first_warn is not None for r in got) > 0
    assert replay.FleetConditionResult._fields == jax_replay.FleetConditionResult._fields


# ---- cli monitor ----

def _jax_monitor(mon, **kw):
    args = dict(mat=mon.mat, ckpt=mon.m.ckpt, block=64, fault_label=None, lead=200,
                diagnose=False, head=None, save_head=None, glitch_alarm_n=None, fleet=False,
                data_parallel=False, whatif=False, conformal=False, conformal_alpha=0.1,
                conformal_gamma=0.0)
    args.update(kw)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = jax_serve.cmd_monitor(argparse.Namespace(**args))
    return rc, out.getvalue(), err.getvalue()


def _port_monitor(capsys, mon, *extra):
    capsys.readouterr()
    rc = cli.main(["monitor", "--mat", mon.mat, "--ckpt", mon.m.ckpt, "--device", "cpu",
                   *extra])
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _mask_actuation(text):
    """The suggested-actuation line's numbers masked: the 400-step solve is
    held to JAX's by tests/test_torch_counterfactual.py."""
    return [re.sub(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?", "#", ln)
            if ln.startswith("suggested actuation") else ln for ln in text.splitlines()]


@pytest.mark.parametrize("extra,kw", [
    ([], {}),
    (["--block", "37", "--fault-label", "4", "--lead", "50"],
     dict(block=37, fault_label=4, lead=50)),
    (["--conformal", "--conformal-alpha", "0.2", "--conformal-gamma", "0.01"],
     dict(conformal=True, conformal_alpha=0.2, conformal_gamma=0.01)),
    (["--fault-label", "1", "--lead", "40", "--whatif"],
     dict(fault_label=1, lead=40, whatif=True)),
    (["--fleet", "--block", "16"], dict(fleet=True, block=16)),
    (["--glitch-alarm-n", "3", "--block", "100"], dict(glitch_alarm_n=3, block=100)),
], ids=["plain", "fault-label", "conformal", "whatif", "fleet", "glitch-alarm-n"])
def test_cli_monitor_matches_jax(mon, capsys, extra, kw):
    rc, out, _ = _port_monitor(capsys, mon, *extra)
    jrc, jout, _ = _jax_monitor(mon, **kw)
    assert rc == jrc == 0
    assert _mask_actuation(out) == _mask_actuation(jout)
    if "whatif" in kw:
        assert "suggested actuation" in out
    assert "streamed" in out or "fleet replay: 12 conditions" in out


def test_cli_monitor_diagnosis_head(mon, capsys, tmp_path):
    """``--diagnose --save-head`` writes the port's fit; JAX's ``--head`` on
    that file prints what the port's ``--head`` prints."""
    head = str(tmp_path / "head")
    rc, out, _ = _port_monitor(capsys, mon, "--diagnose", "--save-head", head)
    assert rc == 0 and f"diagnosis head → {head}.npz" in out
    assert "online diagnosis while warned:" in out
    rc, out, _ = _port_monitor(capsys, mon, "--head", head + ".npz", "--fault-label", "10",
                               "--lead", "30")
    jrc, jout, _ = _jax_monitor(mon, head=head + ".npz", fault_label=10, lead=30)
    assert rc == jrc == 0 and out == jout and "online diagnosis" in out


def test_cli_monitor_argument_errors(mon, capsys):
    for extra, kw, msg in ((["--fleet", "--conformal"], dict(fleet=True, conformal=True),
                            "--conformal applies"),
                           (["--conformal-gamma", "0.1"], dict(conformal_gamma=0.1),
                            "needs --conformal"),
                           (["--fleet", "--whatif"], dict(fleet=True, whatif=True),
                            "--whatif applies")):
        rc, _, err = _port_monitor(capsys, mon, *extra)
        jrc, _, jerr = _jax_monitor(mon, **kw)
        assert rc == jrc == 2 and msg in err and err == jerr
    rc, _, err = _port_monitor(capsys, mon, "--glitch-alarm-n", "0")
    assert rc == 1 and "glitch_alarm_n" in err
    with pytest.raises(ValueError, match="glitch_alarm_n"):
        _jax_monitor(mon, glitch_alarm_n=0)
    assert cli.main(["monitor", "--mat", str(mon.root / "missing.mat"), "--ckpt", mon.m.ckpt,
                     "--device", "cpu"]) == 1


def test_cli_monitor_runs_without_jax(mon):
    """``monitor`` and ``monitor --fleet`` in a process in which jax cannot
    be imported print what they print in-process."""
    code = (
        "import json, sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from pinnfc_tpu_torch.cli import main\n"
        "for argv in json.loads(sys.argv[1]):\n"
        "    rc = main(argv)\n"
        "    print(f'RC {rc}', flush=True)\n"
        "assert not [m for m in sys.modules if m == 'pinnfc_tpu' or m.startswith('pinnfc_tpu.')]\n"
    )
    base = ["monitor", "--mat", mon.mat, "--ckpt", mon.m.ckpt, "--device", "cpu"]
    argvs = [base + ["--fault-label", "2", "--lead", "60"], base + ["--fleet"]]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(argvs)], cwd=REPO, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    parts = re.split(r"^RC (-?\d+)\n", proc.stdout, flags=re.M)
    assert [int(rc) for rc in parts[1::2]] == [0, 0]
    assert parts[0] == _jax_monitor(mon, fault_label=2, lead=60)[1]
    assert parts[2] == _jax_monitor(mon, fleet=True)[1]
