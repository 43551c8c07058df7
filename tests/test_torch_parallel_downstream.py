"""Port parity: the downstream half of ``parallel/`` — the masked logistic
regression and GMM fits, ``parallel/diagnosis.py``, ``run_gmm_pipeline``,
``input_saliency``, ``lambda_identifiability``, ``condition_recovery`` and
``OnlineMonitor`` (``_shard_fleet``, ``fleet_replay``) with ``mesh=``, and
``--data-parallel`` on gmm, identify, explain, whatif, monitor and serve —
against the JAX package on its 8 virtual CPU devices (tests/conftest.py) and
against the port's own unsharded paths.  A port mesh lists the CPU k times
(``make_mesh(devices=["cpu"] * k)``); where padding changes the result both
packages use the same k, and every k leaves a remainder, so the pad rows or
pad streams are there.

Tolerances:
- masked fits against JAX's on the same padded rows, and sharded fits
  against JAX's mesh fits: tests/test_parallel.py's — logreg coef and
  intercept atol 5e-5 with equal predictions; GMM lower bound rtol 1e-5,
  means atol 1e-4 (the covariances, float32 sums in another order, rtol
  1e-3 atol 1e-5), equal iteration counts; against the port's unsharded fit
  on the unpadded rows the same bands (the mask is the semantics);
- ``run_gmm_pipeline(mesh=)`` with sklearn's init: accuracy and confusion
  equal to JAX's mesh run and to the port's unsharded run, y_prob atol 1e-4;
- saliency: tests/test_parallel.py's atol 1e-6 × max|J| against both;
- identifiability: n_residuals, n_dropped, dof and flags equal, σ̂² rtol 1e-5
  and stderr rtol 1e-4 against both;
- the counterfactual at 40 Adam steps: tests/test_torch_counterfactual.py's
  bands against JAX's mesh solve (the same padded count in the means), and
  tests/test_parallel.py's atol 5e-4 on δ and 5e-3 V on v_after against the
  port's unsharded solve (1/N_pad against 1/N in the gradient scale);
- the sharded monitor: tests/test_torch_monitor.py's per-field bands against
  JAX's sharded monitor and the port's unsharded one, the carried states
  likewise; the fleet replay's first alarms equal;
- bitwise: a data axis of size 1 against no mesh for every function, and
  each command's output with ``--data-parallel --device cpu`` (one CPU
  device) against its output without the flag, the JAX mesh banner line
  aside.
"""

import argparse
import threading
import urllib.error

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from pinnfc_tpu.cli import parser as jax_parser
from pinnfc_tpu.cli import serve as jax_serve_cli
from pinnfc_tpu.config import GmmConfig as JaxGmmConfig
from pinnfc_tpu.data.contract import INDEX as JAX_INDEX
from pinnfc_tpu.diagnosis import gmm as jax_gmm
from pinnfc_tpu.diagnosis import logreg as jax_logreg
from pinnfc_tpu.diagnosis import run_gmm_pipeline as jax_run_gmm_pipeline
from pinnfc_tpu.parallel import diagnosis as jax_pd
from pinnfc_tpu.parallel import make_mesh as jax_make_mesh
from pinnfc_tpu.serving import fleet_replay as jax_fleet_replay
from pinnfc_tpu.serving import monitor as jax_monitor
from pinnfc_tpu.uq import condition_recovery as jax_condition_recovery
from pinnfc_tpu.uq import counterfactual as jax_cf
from pinnfc_tpu.uq import input_saliency as jax_input_saliency
from pinnfc_tpu.uq import lambda_identifiability as jax_lambda_identifiability
from pinnfc_tpu_torch import cli
from pinnfc_tpu_torch.cli import serve as serve_cli
from pinnfc_tpu_torch.config import GmmConfig
from pinnfc_tpu_torch.diagnosis import gmm, logreg, run_gmm_pipeline
from pinnfc_tpu_torch.parallel import diagnosis as pd
from pinnfc_tpu_torch.parallel import mesh as pm
from pinnfc_tpu_torch.serving import fleet_replay, monitor
from pinnfc_tpu_torch.uq import counterfactual as cf
from pinnfc_tpu_torch.uq import input_saliency, lambda_identifiability

from test_torch_monitor import _heads, _pinned, _same_out, _same_state, mon  # noqa: F401
from test_torch_serving_export import _free_port, _request, _run

N_BLOBS = 501


def _cpu_mesh(k):
    return pm.make_mesh(devices=["cpu"] * k)


@pytest.fixture(scope="module")
def blobs():
    """Four Gaussian blobs in 4-D (tests/test_parallel.py's), N = 501 rows,
    and a k-means-like one-hot start for EM."""
    rng = np.random.RandomState(0)
    centers = np.array([[0, 0, 0, 0], [3, 0, 1, 0], [0, 3, 0, 1], [3, 3, 1, 1]], float)
    sizes = [130, 120, 131, 120]
    x = np.concatenate([c + 0.4 * rng.randn(m, 4) for c, m in zip(centers, sizes)])
    y = np.concatenate([np.full(m, i) for i, m in enumerate(sizes)]).astype(np.int64)
    resp = np.eye(4, dtype=np.float32)[np.where(rng.rand(N_BLOBS) < 0.9, y,
                                                rng.randint(0, 4, N_BLOBS))]
    return argparse.Namespace(x=x.astype(np.float32), y=y, resp=resp)


def _padded(b, pad=7):
    z = np.zeros((pad, 4), np.float32)
    mask = np.concatenate([np.ones(N_BLOBS, np.float32), np.zeros(pad, np.float32)])
    return (np.concatenate([b.x, z]), np.concatenate([b.y, np.zeros(pad, np.int64)]),
            np.concatenate([b.resp, z]), mask)


def _same_logreg(got, want, x):
    """coef and intercept (up to the softmax shift, which the Newton solve
    projects out and L-BFGS does not) at atol 5e-5, predictions equal."""
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef), rtol=0, atol=5e-5)
    a, b = got.intercept.numpy(), np.asarray(want.intercept)
    np.testing.assert_allclose(a - a.mean(), b - b.mean(), rtol=0, atol=5e-5)
    np.testing.assert_array_equal(
        logreg.logreg_predict(got, x).numpy(),
        np.asarray(logreg.logreg_predict(logreg.LogRegModel(
            *(torch.as_tensor(np.array(t)) for t in want[:4]), 0), x)))


def _same_gmm(got, want):
    assert got.n_iter == int(want.n_iter) and got.converged == bool(want.converged)
    np.testing.assert_allclose(got.lower_bound, float(want.lower_bound), rtol=1e-5)
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.covariances.numpy(), np.asarray(want.covariances),
                               rtol=1e-3, atol=1e-5)


# ---- masked fits and parallel/diagnosis ----

@pytest.mark.parametrize("balanced", [True, False])
def test_masked_logreg_matches_jax_and_the_unpadded_fit(blobs, balanced):
    x_pad, y_pad, _, mask = _padded(blobs)
    got = logreg.logreg_fit(x_pad, y_pad, 4, balanced=balanced, mask=mask, device="cpu")
    want = jax_logreg.logreg_fit(x_pad, y_pad.astype(np.int32), 4, balanced=balanced,
                                 mask=mask)
    assert got.n_iter == int(want.n_iter)
    _same_logreg(got, want, blobs.x)
    plain = logreg.logreg_fit(blobs.x, blobs.y, 4, balanced=balanced, device="cpu")
    _same_logreg(got, plain, blobs.x)
    np.testing.assert_allclose(got.x_mean.numpy(), plain.x_mean.numpy(), rtol=0, atol=1e-6)


def test_masked_gmm_matches_jax_and_the_unpadded_fit(blobs):
    x_pad, _, resp_pad, mask = _padded(blobs)
    got = gmm.gmm_fit(x_pad, None, 4, max_iter=20, mask=mask, init_resp=resp_pad, device="cpu")
    want = jax_gmm.gmm_fit(x_pad, jax.random.PRNGKey(0), 4, max_iter=20, mask=mask,
                           init_resp=resp_pad)
    _same_gmm(got, want)
    _same_gmm(got, gmm.gmm_fit(blobs.x, None, 4, max_iter=20, init_resp=blobs.resp,
                               device="cpu"))
    with pytest.raises(ValueError, match="mask requires init_resp"):
        gmm.gmm_fit(x_pad, torch.Generator(), 4, mask=mask, device="cpu")


@pytest.mark.parametrize("k", [4, 7])
def test_logreg_fit_dp_matches_jax_mesh_and_unsharded(blobs, k):
    assert N_BLOBS % k
    got = pd.logreg_fit_dp(blobs.x, blobs.y, 4, _cpu_mesh(k))
    _same_logreg(got, jax_pd.logreg_fit_dp(blobs.x, blobs.y, 4, jax_make_mesh(k)), blobs.x)
    _same_logreg(got, logreg.logreg_fit(blobs.x, blobs.y, 4, device="cpu"), blobs.x)


def test_logreg_fit_dp_lbfgs_matches_the_unsharded_optimum(blobs):
    """The L-BFGS branch over shards (JAX runs optax's L-BFGS, whose iterates
    are not the port's: parity is on the optimum, held against the port's
    unsharded L-BFGS and JAX's Newton)."""
    got = pd.logreg_fit_dp(blobs.x, blobs.y, 4, _cpu_mesh(4), solver="lbfgs", max_iter=300)
    _same_logreg(got, logreg.logreg_fit(blobs.x, blobs.y, 4, solver="lbfgs", max_iter=300,
                                        device="cpu"), blobs.x)
    _same_logreg(got, jax_logreg.logreg_fit(blobs.x, blobs.y.astype(np.int32), 4), blobs.x)


@pytest.mark.parametrize("k", [4, 7])
def test_gmm_fit_dp_matches_jax_mesh_and_unsharded(blobs, k):
    got = pd.gmm_fit_dp(blobs.x, None, 4, _cpu_mesh(k), max_iter=20, init_resp=blobs.resp)
    _same_gmm(got, jax_pd.gmm_fit_dp(blobs.x, jax.random.PRNGKey(0), 4, jax_make_mesh(k),
                                     max_iter=20, init_resp=blobs.resp))
    _same_gmm(got, gmm.gmm_fit(blobs.x, None, 4, max_iter=20, init_resp=blobs.resp,
                               device="cpu"))


def test_gmm_fit_dp_kmeans_init_is_the_unsharded_init(blobs):
    """The k-means init runs unsharded on the real rows with the same
    generator draws, so the sharded EM starts where the unsharded one does."""
    got = pd.gmm_fit_dp(blobs.x, torch.Generator().manual_seed(3), 4, _cpu_mesh(3))
    want = gmm.gmm_fit(blobs.x, torch.Generator().manual_seed(3), 4, device="cpu")
    _same_gmm(got, want)


def test_a_data_axis_of_one_is_the_unsharded_fit_bitwise(blobs):
    one = _cpu_mesh(1)
    a = pd.gmm_fit_dp(blobs.x, torch.Generator().manual_seed(1), 4, one)
    b = gmm.gmm_fit(blobs.x, torch.Generator().manual_seed(1), 4, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a[:3], b[:3])) and a[3:] == b[3:]
    a = pd.logreg_fit_dp(blobs.x, blobs.y, 4, one)
    b = logreg.logreg_fit(blobs.x, blobs.y, 4, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a[:4], b[:4])) and a.n_iter == b.n_iter


def test_pad_rows_are_zeros_with_a_mask():
    x = torch.arange(10.0).reshape(5, 2)
    padded, mask = pd._pad_rows(x, 4)
    assert padded.shape == (8, 2) and not padded[5:].any()
    assert mask.tolist() == [1.0] * 5 + [0.0] * 3
    same, ones = pd._pad_rows(x, 5)
    assert same is x and ones.tolist() == [1.0] * 5


def _gmm_artifact():
    """tests/test_parallel.py::test_gmm_pipeline_mesh_parity's artifact."""
    rng = np.random.RandomState(5)
    n_normal, n_fault = 200, 30
    n = n_normal + 12 * n_fault
    arr = np.zeros((n, 22))
    for k in ("res", "pV", "pT", "pH", "pO"):
        arr[:, JAX_INDEX[k]] = 0.05 * rng.randn(n)
    lab = np.zeros(n)
    for k in range(12):
        seg = slice(n_normal + k * n_fault, n_normal + (k + 1) * n_fault)
        lab[seg] = k + 1
        arr[seg, JAX_INDEX[("pV", "pT", "pH", "pO")[k // 3]]] += np.linspace(0.5, 2.0, n_fault)
    arr[:, JAX_INDEX["label"]] = lab
    return arr


def test_run_gmm_pipeline_mesh_matches_jax_mesh_and_unsharded():
    arr = _gmm_artifact()
    got = run_gmm_pipeline(arr, GmmConfig(init="sklearn"), mesh=_cpu_mesh(3), device="cpu")
    assert len(got.y_true) and (len(arr) - len(got.y_true)) % 3  # training rows pad
    want = jax_run_gmm_pipeline(arr, JaxGmmConfig(init="sklearn"), mesh=jax_make_mesh(3))
    plain = run_gmm_pipeline(arr, GmmConfig(init="sklearn"), device="cpu")
    for other in (want, plain):
        assert got.accuracy == other.accuracy
        np.testing.assert_array_equal(got.confusion, other.confusion)
        np.testing.assert_allclose(got.y_prob, other.y_prob, rtol=0, atol=1e-4)
    one = run_gmm_pipeline(arr, GmmConfig(init="sklearn"), mesh=_cpu_mesh(1), device="cpu")
    np.testing.assert_array_equal(one.y_prob, plain.y_prob)


# ---- saliency, identifiability, the counterfactual ----

def test_saliency_mesh_matches_jax_mesh_and_unsharded(mon):  # noqa: F811
    m = mon.m
    x = m.arr[:, :8]
    assert len(x) % 7
    got = input_saliency(m.tp, x, m.sx, m.sy, labels=m.labels, mesh=_cpu_mesh(7))
    want = jax_input_saliency(m.jp, x, m.jds.scaler_x, m.jds.scaler_y, mesh=jax_make_mesh(7))
    plain = input_saliency(m.tp, x, m.sx, m.sy, device="cpu")
    one = input_saliency(m.tp, x, m.sx, m.sy, device="cpu", mesh=_cpu_mesh(1))
    for f in ("jac_norm", "jac_phys", "jac_range", "sigma_jac_range"):
        a = getattr(got, f)
        assert a.shape == (len(x), 8) and a.dtype == np.float32
        for other in (want, plain):
            b = getattr(other, f)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * max(np.abs(b).max(), 1.0),
                                       err_msg=f)
        np.testing.assert_array_equal(getattr(one, f), getattr(plain, f))


def test_identifiability_mesh_trims_before_the_interval_math(mon):  # noqa: F811
    m = mon.m
    assert len(m.x_norm) % 7
    got = lambda_identifiability(m.tp, m.x_norm, m.sx, m.sy, mesh=_cpu_mesh(7))
    want = jax_lambda_identifiability(m.jp, m.x_norm, m.jds.scaler_x, m.jds.scaler_y,
                                      mesh=jax_make_mesh(7))
    plain = lambda_identifiability(m.tp, m.x_norm, m.sx, m.sy)
    one = lambda_identifiability(m.tp, m.x_norm, m.sx, m.sy, mesh=_cpu_mesh(1))
    assert list(got) == list(want) == list(plain)
    assert got["lam_v"].n_dropped > 0  # rows past the limiting current
    for g in got:
        for other in (want[g], plain[g]):
            assert (got[g].n_residuals, got[g].n_dropped, got[g].dof) == \
                (other.n_residuals, other.n_dropped, other.dof)
            np.testing.assert_array_equal(got[g].identifiable, other.identifiable)
            np.testing.assert_array_equal(got[g].at_bound, other.at_bound)
            np.testing.assert_allclose(got[g].sigma2, other.sigma2, rtol=1e-5, atol=1e-12)
            np.testing.assert_allclose(got[g].stderr, other.stderr, rtol=1e-4, atol=1e-12)
        np.testing.assert_array_equal(one[g].stderr, plain[g].stderr)
        assert one[g].sigma2 == plain[g].sigma2


@pytest.mark.parametrize("target", ["gain", "absolute"])
def test_condition_recovery_mesh_matches_jax_mesh_and_unsharded(mon, target):  # noqa: F811
    from test_torch_counterfactual import _same_report

    m = mon.m
    kw = dict(max_rows=8, target=target)
    got = cf.condition_recovery(m.arr, m.tp, m.sx, m.sy, config=cf.CounterfactualConfig(steps=40),
                                mesh=_cpu_mesh(5), **kw)
    want = jax_condition_recovery(m.arr, m.jp, m.jds.scaler_x, m.jds.scaler_y,
                                  config=jax_cf.CounterfactualConfig(steps=40),
                                  mesh=jax_make_mesh(5), **kw)
    plain = cf.condition_recovery(m.arr, m.tp, m.sx, m.sy,
                                  config=cf.CounterfactualConfig(steps=40), device="cpu", **kw)
    one = cf.condition_recovery(m.arr, m.tp, m.sx, m.sy, config=cf.CounterfactualConfig(steps=40),
                                device="cpu", mesh=_cpu_mesh(1), **kw)
    assert sum(r.n_rows for r in got) % 5  # the solve's rows pad
    for g, w, p, o in zip(got, want, plain, one):
        assert (g.fault_name, g.current_target, g.n_rows) == (w.fault_name, w.current_target,
                                                              w.n_rows)
        _same_report(g.report, w.report)
        np.testing.assert_allclose(g.report.delta_range, p.report.delta_range, rtol=0,
                                   atol=5e-4)
        np.testing.assert_allclose(g.report.v_after, p.report.v_after, rtol=0, atol=5e-3)
        np.testing.assert_array_equal(o.report.x_cf_phys, p.report.x_cf_phys)
        np.testing.assert_array_equal(o.report.v_after, p.report.v_after)


# ---- the monitor ----

def _monitors(mon, k, **kw):  # noqa: F811
    """(port sharded over k CPUs, JAX sharded over k devices, port unsharded)."""
    m = mon.m
    port_kw, jax_kw = dict(kw), dict(kw)
    if "head" in kw:
        port_kw["diagnosis"], jax_kw["diagnosis"] = kw.pop("head")
        del port_kw["head"], jax_kw["head"]
    return (monitor.OnlineMonitor(m.tp, m.sx, m.sy, mon.mu, mon.sigma, device="cpu",
                                  mesh=_cpu_mesh(k), **port_kw),
            jax_monitor.OnlineMonitor(m.jp, m.jds.scaler_x, m.jds.scaler_y, mon.mu, mon.sigma,
                                      mesh=jax_make_mesh(k), **jax_kw),
            monitor.OnlineMonitor(m.tp, m.sx, m.sy, mon.mu, mon.sigma, device="cpu", **port_kw))


def test_sharded_observe_many_matches_jax_and_unsharded(mon):  # noqa: F811
    """S = 5 streams on a 3-way data axis (one fresh-state dummy stream), two
    rounds (the carried state continues), with the diagnosis head and
    conformal p-values; dummy streams never reach the bank."""
    sharded, jax_sharded, plain = _monitors(mon, 3, head=_heads(mon), conformal_calib=mon.calib)
    streams = [f"s{i}" for i in range(5)]
    x_bank = np.stack([mon.x[120 + 40 * i:160 + 40 * i] for i in range(5)])
    v_bank = np.stack([mon.v[120 + 40 * i:160 + 40 * i] - 0.05 * i for i in range(5)])
    for rnd in (0, 1):
        xb = x_bank + np.float32(0.01 * rnd)
        got = sharded.observe_many(xb, v_bank, streams)
        for other in (jax_sharded, plain):
            want = other.observe_many(xb, v_bank, streams)
            for s in streams:
                _same_out(got[s], want[s], n_calib=len(mon.calib))
    assert set(sharded.streams) == {"default", *streams}
    for s in streams:
        _same_state(sharded._streams[s], plain._streams[s])
        assert sharded.stream_n_seen(s) == 80 and sharded.stream_low_p(s) == plain.stream_low_p(s)
    # observe (one stream) stays unsharded: bitwise the plain monitor's
    a, b = sharded.observe(mon.x[:50], mon.v[:50]), plain.observe(mon.x[:50], mon.v[:50])
    np.testing.assert_array_equal(a.rf_smooth, b.rf_smooth)
    np.testing.assert_array_equal(a.residuals, b.residuals)


def test_sharded_fleet_replay_matches_jax_and_unsharded(mon):  # noqa: F811
    sharded, jax_sharded, plain = _monitors(mon, 5)
    got = fleet_replay(sharded, mon.arr, block=64)
    assert len(got) % 5  # pad streams on the sharded rounds
    for other in (jax_fleet_replay(jax_sharded, mon.arr, block=64),
                  fleet_replay(plain, mon.arr, block=64)):
        assert len(got) == len(other)
        for g, w in zip(got, other):
            assert (g.stream, g.n_samples, g.first_warn, g.first_danger, g.first_v_alarm) == \
                (w.stream, w.n_samples, w.first_warn, w.first_danger, w.first_v_alarm)
            assert list(g.layer_shares) == list(w.layer_shares)
            for key in g.layer_shares:
                assert g.layer_shares[key] == pytest.approx(w.layer_shares[key], abs=1e-5)


def test_a_mesh_without_a_data_axis_is_refused_as_in_jax(mon):  # noqa: F811
    m = mon.m
    port_mesh = pm.Mesh(np.array([torch.device("cpu")], dtype=object), ("model",))
    with pytest.raises(ValueError, match="data") as got:
        monitor.OnlineMonitor(m.tp, m.sx, m.sy, mon.mu, mon.sigma, device="cpu",
                              mesh=port_mesh)
    with pytest.raises(ValueError) as want:
        jax_monitor.OnlineMonitor(m.jp, m.jds.scaler_x, m.jds.scaler_y, mon.mu, mon.sigma,
                                  mesh=JaxMesh(np.array(jax.devices()[:1]), ("model",)))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="data"):
        monitor.OnlineMonitor.from_checkpoint(m.ckpt, mon.mu, mon.sigma, device="cpu",
                                              mesh=port_mesh)


def test_a_monitor_replica_holds_every_step_input_on_its_device(mon):  # noqa: F811
    """``_replica`` copies what ``_device_step`` reads (here onto the CPU it
    lies on: the same tensors, a new monitor object) and its step equals the
    monitor's bitwise."""
    base = monitor.OnlineMonitor(mon.m.tp, mon.m.sx, mon.m.sy, mon.mu, mon.sigma,
                                 diagnosis=_heads(mon)[0], conformal_calib=mon.calib,
                                 device="cpu")
    rep = base._replica(torch.device("cpu"))
    assert rep is not base and rep.params["mlp"] is base.params["mlp"]
    x = torch.from_numpy(mon.x[:64].reshape(2, 32, 8).copy())
    v = torch.from_numpy(mon.v[:64].reshape(2, 32).T.copy())
    carry = torch.from_numpy(base._carry([base._fresh_state()] * 2))
    a = base._device_step(x, v, carry, base.mu, base.sigma)
    b = rep._device_step(x, v, carry, rep.mu, rep.sigma)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


# ---- the command lines ----

def test_data_parallel_flags_are_jax_s(monkeypatch):
    """--data-parallel on exactly the subcommands where the JAX parser has
    it, among the subcommands both packages have."""
    class Built(Exception):
        pass

    def grab(self, *a, **k):
        raise Built(self)

    def flagged(parser):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return {name: any("--data-parallel" in a.option_strings for a in p._actions)
                for name, p in sub.choices.items()}

    port = flagged(cli.build_parser())
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Built) as built:
        jax_parser.main([])
    jax_flags = flagged(built.value.args[0])
    common = set(port) & set(jax_flags)
    assert {c for c in common if port[c]} == {c for c in common if jax_flags[c]} == {
        "train", "score", "gmm", "identify", "explain", "whatif", "monitor", "serve"}


MESH_BANNER = ("GMM EM data-parallel over 1 devices\n",
               "residual Jacobians data-parallel over 1 devices\n",
               "saliency data-parallel over 1 devices\n",
               "recovery solve data-parallel over 1 devices\n")


@pytest.mark.parametrize("argv", [
    ["gmm"], ["identify", "CK"], ["identify", "CK", "--json"], ["explain", "CK"],
    ["whatif", "CK", "--steps", "40", "--max-rows", "8", "--json"],
    ["monitor", "CK", "--fleet", "--block", "64"]], ids=lambda a: " ".join(a))
def test_data_parallel_on_one_cpu_changes_no_byte(mon, capsys, argv):  # noqa: F811
    argv = [mon.m.ckpt if a == "CK" else a for a in argv]
    argv = [argv[0], "--mat", mon.mat, *(["--ckpt"] if argv[1:2] == [mon.m.ckpt] else []),
            *argv[1:], "--device", "cpu"]
    rc, plain, _ = _run(cli.main, argv, capsys)
    rc_dp, flagged, _ = _run(cli.main, argv + ["--data-parallel"], capsys)
    assert rc == rc_dp == 0 and plain
    banners = [b for b in MESH_BANNER if flagged.startswith(b)]
    assert len(banners) == (0 if argv[0] == "monitor" else 1)
    assert flagged[len(banners[0]) if banners else 0:] == plain


def _serve_once(argv, request, capsys):
    """``cli serve`` in a thread for one request: (payload, its standard
    output with the port number as PORT)."""
    port = _free_port()
    t = threading.Thread(target=cli.main, args=(argv + ["--port", str(port),
                                                        "--max-requests", "1"],), daemon=True)
    t.start()
    for _ in range(200):
        try:
            payload = _request(port, *request)[1]
            break
        except urllib.error.URLError:
            threading.Event().wait(0.05)
    t.join(60)
    assert not t.is_alive()
    return payload, capsys.readouterr().out.replace(str(port), "PORT")


@pytest.mark.parametrize("shards", [1, 3])
def test_cli_serve_data_parallel_observe_many(mon, capsys, monkeypatch, shards):  # noqa: F811
    """``serve --data-parallel --device cpu``: one CPU gives a mesh of one
    device and the unflagged bytes; a 3-way CPU mesh (put in place of the
    visible devices) splits /observe_many's streams, within the monitor's
    bands of the unflagged payload."""
    xs = np.stack([mon.x[150 + 30 * i:180 + 30 * i] for i in range(4)])
    vs = np.stack([mon.v[150 + 30 * i:180 + 30 * i] for i in range(4)])
    req = ("/observe_many", {"streams": ["a", "b", "c", "d"], "x": xs.tolist(),
                             "v": vs.tolist()})
    argv = ["serve", "--mat", mon.mat, "--ckpt", mon.m.ckpt, "--device", "cpu"]
    plain, out_plain = _serve_once(argv, req, capsys)
    if shards > 1:
        monkeypatch.setattr(serve_cli, "_data_parallel_mesh",
                            lambda args: _cpu_mesh(shards) if args.data_parallel else None)
    flagged, out = _serve_once(argv + ["--data-parallel"], req, capsys)
    if shards == 1:
        assert flagged == plain and out == out_plain
        return
    assert out.startswith(f"fleet sharding: streams over {shards} devices\n")
    assert flagged.keys() == plain.keys() and flagged["n_seen"] == plain["n_seen"]
    for s in "abcd":
        g, w = flagged["results"][s], plain["results"][s]
        assert g.keys() == w.keys() and g["warn"] == w["warn"] and g["glitch"] == w["glitch"]
        for f in ("rf_smooth", "v_pred"):
            np.testing.assert_allclose(np.array(g[f], float), np.array(w[f], float),
                                       rtol=1e-5, atol=2e-6, err_msg=f)


def test_cli_serve_artifact_data_parallel_exits_2_as_jax(mon, tmp_path, capsys):  # noqa: F811
    art = str(tmp_path / "a.pt2")
    open(art, "wb").close()
    argv = ["serve", "--mat", mon.mat, "--artifact", art, "--data-parallel"]
    rc, _, err = _run(cli.main, argv, capsys)
    assert rc == 2 and "--data-parallel needs the checkpoint path" in err
    jrc, _, jerr = _run(jax_serve_cli.cmd_serve, cli.build_parser().parse_args(argv), capsys)
    assert jrc == 2 and jerr == err
