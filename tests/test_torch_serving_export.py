"""Port parity: the ``torch.export`` artifacts (pinnfc_tpu_torch.serving.
exported), the HTTP server (serving/server.py) and the ``export-model`` and
``serve`` command lines, against the JAX package's, on the CPU with the
miniature model of tests/test_torch_monitor.py (8→32→32→1, i_l = 1.2, the
artifact's normal spread shrunk so that the faults warn).

Tolerances:
- the scorer artifact against the port's eval forward: bitwise; against
  JAX's exported scorer: rtol 1e-5, atol 1e-6 (one float32 forward each);
- the exported monitor step against the eager ``OnlineMonitor._step`` it
  traces: bitwise in every output and in the carried state (blocks of 1, 7,
  64 and 256 rows from one artifact), the fixed-depth scans of
  ``ops/recurrences.py`` against the scans by block size bitwise;
- the exported step against JAX's exported step on the same blocks: the
  tolerances of tests/test_torch_monitor.py (``_same_out``/``_same_state``);
- the fleet artifact against the eager ``observe_many``: bitwise; against
  single-stream artifact calls: ``_same_out``'s tolerances, as the eager
  ``observe_many`` is held against ``observe``;
- a block longer than ``block_max``, served in pieces, against one eager
  block: the block-size invariance of tests/test_torch_monitor.py (rtol
  1e-5, atol 1e-6);
- the server's JSON payloads against JAX's server on the same requests: the
  same keys, flags and counters, floats at ``_same_out``'s tolerances; the
  /metrics exposition: the same HELP/TYPE lines, series names and labels;
- a ``--state-path`` restart: bitwise the uninterrupted run.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from pinnfc_tpu.cli import export as jax_export_cli
from pinnfc_tpu.cli import serve as jax_serve_cli
from pinnfc_tpu.serving import exported as jax_exported
from pinnfc_tpu.serving import monitor as jax_monitor
from pinnfc_tpu.serving import server as jax_server
from pinnfc_tpu_torch import cli
from pinnfc_tpu_torch.config import RiskConfig, risk_config_from_dict
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.ops.recurrences import linear_recurrence_assoc
from pinnfc_tpu_torch.ops.residuals import kernel_scalars, residuals_op
from pinnfc_tpu_torch.physics.residuals import all_residuals
from pinnfc_tpu_torch.serving import exported, monitor, server

from test_torch_monitor import _heads, _pinned, _same_out, _same_state, mon  # noqa: F401

BLOCKS = (1, 7, 64, 256)
GAMMA = 0.01


def _stream(mon, rows=256):  # noqa: F811
    """``rows`` rows from the normal tail into the first fault segments (some
    past the limiting current: NaN residuals, glitches), and their voltages."""
    return mon.x[150:150 + rows], mon.v[150:150 + rows]


# rows replayed per block size: every block size sees glitches and warns
REPLAY_ROWS = {1: 40, 7: 70, 64: 256, 256: 256}


def _port(mon, device="cpu", **kw):  # noqa: F811
    m = mon.m
    return monitor.OnlineMonitor(m.tp, m.sx, m.sy, mon.mu, mon.sigma, device=device, **kw)


def _full_kw(mon):  # noqa: F811
    """The options of the artifacts under test: the port's GMM head and the
    conformal calibration with an adaptive level."""
    return dict(diagnosis=_heads(mon)[0], conformal_calib=mon.calib, conformal_gamma=GAMMA)


@pytest.fixture(scope="module")
def artifacts(mon):  # noqa: F811
    """The monitor-step and fleet-step artifacts of the port (head and
    conformal calibration baked in, traced once for the module), and JAX's
    exported step of the same model and options."""
    src = _port(mon, **_full_kw(mon))
    jsrc = jax_monitor.OnlineMonitor(mon.m.jp, mon.m.jds.scaler_x, mon.m.jds.scaler_y, mon.mu,
                                     mon.sigma, diagnosis=_heads(mon)[1],
                                     conformal_calib=mon.calib, conformal_gamma=GAMMA)
    return argparse.Namespace(
        step=exported.export_monitor_step(src),
        fleet=exported.export_monitor_fleet_step(src),
        jax_step=jax_exported.export_monitor_step(jsrc, platforms=("cpu",)))


def _artifact_monitor(mon, blob, **kw):  # noqa: F811
    return exported.monitor_from_artifact(
        blob, mon.mu, mon.sigma, class_names=_heads(mon)[0].class_names,
        conformal_gamma=GAMMA, device="cpu", **kw)


def _bitwise_out(got, want):
    for f in monitor.MonitorOutput.__dataclass_fields__:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


# ---- the fixed-depth scan ----

@pytest.mark.parametrize("n", [1, 2, 7, 64, 100, 256])
def test_fixed_depth_scan_equals_the_scan_by_block_size(n):
    rs = np.random.RandomState(n)
    a = torch.from_numpy(rs.uniform(0.5, 1.0, (n, 3)).astype(np.float32))
    b = torch.from_numpy(rs.randn(n, 3).astype(np.float32))
    y0 = torch.from_numpy(rs.randn(3).astype(np.float32))
    want = linear_recurrence_assoc(a, b, y0)
    for max_len in (n, 256, 4096):
        if max_len >= n:
            assert torch.equal(linear_recurrence_assoc(a, b, y0, max_len=max_len), want)


# ---- the registered residual operator ----

def test_the_residual_operator_is_the_plain_version_on_the_cpu(mon):  # noqa: F811
    m = mon.m
    x = torch.from_numpy(np.asarray(m.x_norm[:37], np.float32))
    u = torch.from_numpy(np.random.RandomState(2).uniform(-1, 1, 37).astype(np.float32))
    scalars = kernel_scalars(m.tp, m.sx, m.sy)
    out = residuals_op(x, u, *(scalars[k] for k in build.RESIDUAL_SCALAR_SIZES))
    want = all_residuals(m.tp, x, u[:, None], m.sx, m.sy)
    assert out.shape == (8, 37) and out.dtype == torch.float32
    for row, w in zip(out, want):
        np.testing.assert_array_equal(row.numpy(), w[:, 0].numpy())
    assert build.LAUNCHES == {k: 0 for k in build.LAUNCHES}


def test_the_exported_step_records_the_residual_operator(mon, artifacts):  # noqa: F811
    ep = torch.export.load(io.BytesIO(artifacts.step))
    targets = [str(n.target) for gm in ep.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule)
               for n in gm.graph.nodes if n.op == "call_function"]
    assert targets.count("pinnfc_torch.residuals.default") == 1


# ---- the scorer ----

@pytest.fixture(scope="module")
def scorers(mon):  # noqa: F811
    m = mon.m
    return (exported.load_scorer(exported.export_scorer(m.tp, m.sx, m.sy), device="cpu"),
            jax_exported.load_scorer(jax_exported.export_scorer(
                m.jp, m.jds.scaler_x, m.jds.scaler_y, platforms=("cpu",))))


@pytest.mark.parametrize("rows", BLOCKS)
def test_scorer_artifact_matches_the_eval_forward_and_jax(mon, scorers, rows):  # noqa: F811
    m = mon.m
    x = torch.from_numpy(mon.x[:rows])
    port, jax_scorer = scorers
    v, log_var = port(x)
    with torch.no_grad():
        pred, lv = m.tp["mlp"](m.sx.transform(x))
    assert v.shape == log_var.shape == (rows,)
    assert torch.equal(v, m.sy.inverse(pred)[:, 0]) and torch.equal(log_var, lv[:, 0])
    jv, jlv = jax_scorer(mon.x[:rows])
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(log_var.numpy(), np.asarray(jlv), rtol=1e-5, atol=1e-6)


def test_scorer_artifact_loads_with_torch_alone(mon, tmp_path):  # noqa: F811
    """The scorer artifact runs in a process where this package cannot be
    imported: ``torch.export.load`` and the program alone."""
    m = mon.m
    path = tmp_path / "scorer.pt2"
    path.write_bytes(exported.export_scorer(m.tp, m.sx, m.sy))
    np.save(tmp_path / "x.npy", mon.x[:9])
    code = (
        "import importlib.util, sys, numpy as np, torch\n"
        "assert importlib.util.find_spec('pinnfc_tpu_torch') is None\n"
        "ep = torch.export.load(sys.argv[1])\n"
        "with torch.no_grad():\n"
        "    v, lv = ep.module()(torch.from_numpy(np.load(sys.argv[2])))\n"
        "np.save(sys.argv[3], v.numpy())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(path), str(tmp_path / "x.npy"),
                           str(tmp_path / "v.npy")], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    v, _ = exported.load_scorer(path.read_bytes(), device="cpu")(torch.from_numpy(mon.x[:9]))
    np.testing.assert_array_equal(np.load(tmp_path / "v.npy"), v.numpy())


# ---- the monitor step ----

@pytest.mark.parametrize("block", BLOCKS)
def test_exported_step_is_the_eager_step_bitwise(mon, artifacts, block):  # noqa: F811
    x, v = _stream(mon, REPLAY_ROWS[block])
    eager = _port(mon, **_full_kw(mon))
    art = _artifact_monitor(mon, artifacts.step)
    for lo in range(0, len(x), block):
        _bitwise_out(art.observe(x[lo:lo + block], v[lo:lo + block]),
                     eager.observe(x[lo:lo + block], v[lo:lo + block]))
    _same_state(art.state, eager.state, exact=True)
    assert art.stream_low_p() == eager.stream_low_p() and art.n_seen == eager.n_seen


@pytest.mark.parametrize("block", BLOCKS)
def test_exported_step_matches_jax_exported_step(mon, artifacts, block):  # noqa: F811
    x, v = _stream(mon, REPLAY_ROWS[block])
    art = _artifact_monitor(mon, artifacts.step)
    ref = jax_exported.monitor_from_artifact(
        artifacts.jax_step, mon.mu, mon.sigma, class_names=_heads(mon)[1].class_names)
    for lo in range(0, len(x), block):
        _same_out(art.observe(x[lo:lo + block], v[lo:lo + block]),
                  ref.observe(x[lo:lo + block], v[lo:lo + block]), n_calib=len(mon.calib))
    _same_state(art.state, jax.device_get(ref.state))
    assert art.stream_low_p() == ref.stream_low_p()


def test_fleet_step_equals_single_stream_steps(mon, artifacts):  # noqa: F811
    """``observe_many`` of 5 streams through the fleet artifact (one call per
    round) is the eager ``observe_many`` bitwise and each stream's
    single-step artifact calls at the tolerances of ``_same_out`` (the
    mixture's products run over S·B rows at once, as in the eager monitor),
    and a single ``observe`` rides the fleet program at s = 1."""
    x, v = _stream(mon)
    fleet = _artifact_monitor(mon, artifacts.fleet)
    single = _artifact_monitor(mon, artifacts.step)
    eager = _port(mon, **_full_kw(mon))
    assert fleet.fleet_baked and not single.fleet_baked
    keys = [f"s{i}" for i in range(5)]
    for rnd in range(2):
        xb = np.stack([x[40 * i + 20 * rnd:40 * i + 20 * rnd + 20] for i in range(5)])
        vb = np.stack([v[40 * i + 20 * rnd:40 * i + 20 * rnd + 20] for i in range(5)])
        got = fleet.observe_many(xb, vb, keys)
        want = eager.observe_many(xb, vb, keys)
        for i, k in enumerate(keys):
            _bitwise_out(got[k], want[k])
            _same_out(got[k], single.observe(xb[i], vb[i], stream=k), n_calib=len(mon.calib))
    for k in keys:
        _same_state(fleet._streams[k], eager._streams[k], exact=True)
        _same_state(fleet._streams[k], single._streams[k])
    _bitwise_out(fleet.observe(x[:33], v[:33], stream="one"),
                 single.observe(x[:33], v[:33], stream="one"))
    with pytest.raises(ValueError, match="unique"):
        fleet.observe_many(xb[:2], vb[:2], ["a", "a"])
    assert "a" not in fleet.streams


def test_a_block_past_block_max_is_served_in_pieces(mon, monkeypatch):  # noqa: F811
    monkeypatch.setattr(exported, "BLOCK_MAX", 32)
    blob = exported.export_monitor_step(_port(mon))
    art = exported.monitor_from_artifact(blob, mon.mu, mon.sigma, device="cpu")
    assert art.block_max == 32
    x, v = _stream(mon)
    got, want = art.observe(x[:100], v[:100]), _port(mon).observe(x[:100], v[:100])
    for f in ("rf_smooth", "rf_inst", "residuals", "v_pred", "layer_c"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    for f in ("warn", "glitch", "sensor_alarm", "v_alarm", "oob"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert art.state.n_seen == 100
    # a wrong risk config, a scorer blob and noise raise
    with pytest.raises(ValueError, match="risk layers"):
        exported.monitor_from_artifact(
            blob, mon.mu, mon.sigma, device="cpu",
            config=dataclasses.replace(RiskConfig(), layer_config=(("voltage", ("res",)),)))
    m = mon.m
    for other in (exported.export_scorer(m.tp, m.sx, m.sy), b"not an artifact"):
        with pytest.raises(ValueError, match="not an `export-model --monitor-step` artifact"):
            exported.monitor_from_artifact(other, mon.mu, mon.sigma, device="cpu")


def test_artifact_monitor_validates_its_options(mon, artifacts):  # noqa: F811
    with pytest.raises(ValueError, match="4-class head but 3"):
        exported.monitor_from_artifact(artifacts.step, mon.mu, mon.sigma, device="cpu",
                                       class_names=("a", "b", "c"))
    with pytest.raises(ValueError, match="glitch_alarm_n"):
        exported.monitor_from_artifact(artifacts.step, mon.mu, mon.sigma, device="cpu",
                                       glitch_alarm_n=0)
    art = exported.monitor_from_artifact(artifacts.step, mon.mu, mon.sigma, device="cpu")
    assert art.diagnosis.class_names == tuple(f"class_{i}" for i in range(4))
    assert art.conformal_baked
    with pytest.raises(ValueError, match="platform"):
        exported.export_monitor_step(_port(mon), platforms=("cpu", "tpu"))


def test_observe_timing_builds_its_monitor_on_the_cpu():
    """The monitor and stream of ``python3 -m pinnfc_tpu_torch.serving.
    observe_timing`` on the CPU: the step runs the head and the p-values,
    the stream's glitches are where it puts them, and each time is taken."""
    from pinnfc_tpu_torch.serving import observe_timing

    mon, x, v = observe_timing.build_monitor("cpu")
    assert x.shape == (1000, 8) and v.shape == (1000,)
    out = mon.observe(x[:64], v[:64])
    assert out.fault_probs.shape == (64, 5) and out.conformal_p.shape == (64,)
    assert out.glitch[:3].all() and np.isfinite(out.v_pred).all()
    times = observe_timing.time_observe(mon, x, v)
    assert sorted(times["observe_ms"]) == [1, 64, 256]
    assert all(t > 0 for t in times["observe_ms"].values()) and times["observe_many_12x64_ms"] > 0


def test_risk_config_from_dict_inverts_asdict():
    cfg = dataclasses.replace(RiskConfig(), warn_threshold=0.25, layer_weights=(
        ("voltage", 2.0), ("gas", 1.0), ("temp", 0.5)))
    assert risk_config_from_dict(json.loads(json.dumps(dataclasses.asdict(cfg)))) == cfg


# ---- export-model ----

def _run(fn, argv_or_ns, capsys):
    rc = fn(argv_or_ns)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_export_model_and_its_sidecar(mon, tmp_path, capsys):  # noqa: F811
    """``export-model`` in three forms; the sidecars carry the JAX keys with
    the port's kind, the baked values, α* and γ; each artifact loads."""
    m = mon.m
    head = _heads(mon)[0].save(str(tmp_path / "head"))
    scorer, step = str(tmp_path / "scorer.pt2"), str(tmp_path / "step.pt2")
    rc, out, _ = _run(cli.main, ["export-model", "--ckpt", m.ckpt, "--out", scorer], capsys)
    assert rc == 0 and out.startswith(f"scorer (cpu,cuda; any batch size) → {scorer} (")
    side = json.load(open(scorer + ".meta.json"))
    assert side["kind"] == "pinnfc_torch_scorer" and side["platforms"] == ["cpu", "cuda"]
    assert side["checkpoint_meta"]["n_normal"] == 300
    assert side["signature"] == "f32[b,8] raw sensors -> (f32[b] v_pred, f32[b] log_var)"
    rc, out, _ = _run(cli.main, ["export-model", "--ckpt", m.ckpt, "--out", step, "--platforms",
                                 "cpu", "--monitor-step", "--head", head, "--glitch-alarm-n",
                                 "7", "--conformal-mat", mon.mat, "--conformal-gamma", "0.005"],
                      capsys)
    assert rc == 0 and "conformal calibration:" in out and "monitor step (cpu;" in out
    side = json.load(open(step + ".meta.json"))
    assert side["kind"] == "pinnfc_torch_monitor_step" and side["fleet_step"] is False
    assert side["platforms"] == ["cpu"]
    # the artifact keeps its platforms: it does not load onto another device type
    with pytest.raises(ValueError, match="exported for cpu, not cuda"):
        exported.monitor_from_artifact(open(step, "rb").read(), mon.mu, mon.sigma,
                                       device="cuda")
    assert side["glitch_alarm_n"] == 7 and side["block_max"] == exported.BLOCK_MAX
    assert risk_config_from_dict(side["risk_config"]) == RiskConfig()
    assert side["class_names"] == list(_heads(mon)[0].class_names)
    assert side["conformal_alpha"] == 0.1 and side["conformal_gamma"] == 0.005
    assert side["conformal_n_calib"] > 0 and side["conformal_source"] == os.path.abspath(mon.mat)
    assert side["diagnosis_head"] == os.path.abspath(head)
    assert side["signature"].startswith("(state tuple c/rf_smooth/v_first/n_seen/")
    art = exported.monitor_from_artifact(open(step, "rb").read(), mon.mu, mon.sigma,
                                         device="cpu", glitch_alarm_n=7,
                                         conformal_gamma=side["conformal_gamma"])
    assert art.conformal_baked and art.diagnosis is not None
    x, v = _stream(mon)
    eager = monitor.OnlineMonitor.from_checkpoint(
        m.ckpt, mon.mu, mon.sigma, diagnosis=monitor.DiagnosisHead.load(head, device="cpu"),
        glitch_alarm_n=7, conformal_calib=art_calib(mon), conformal_gamma=0.005, device="cpu")
    _bitwise_out(art.observe(x[:64], v[:64]), eager.observe(x[:64], v[:64]))


def art_calib(mon):  # noqa: F811
    """The calibration vector ``export-model --conformal-mat`` bakes."""
    from pinnfc_tpu_torch.uq import normal_calibration_scores

    return normal_calibration_scores(mon.arr, score="absolute", calib_frac=1.0)


EXPORT_EXIT_2 = {
    "empty platforms": (["--platforms", " ,"], "--platforms must name at least one target"),
    "head without monitor step": (["--head", "h.npz"], "--head requires --monitor-step"),
    "conformal-mat without monitor step": (["--conformal-mat", "c.mat"],
                                           "--conformal-mat requires --monitor-step"),
    "gamma without conformal-mat": (["--monitor-step", "--conformal-gamma", "0.01"],
                                    "--conformal-gamma requires --conformal-mat"),
    "fleet step without monitor step": (["--fleet-step"], "--fleet-step requires --monitor-step"),
}


@pytest.mark.parametrize("case", sorted(EXPORT_EXIT_2))
def test_cli_export_model_argument_errors_match_jax(mon, tmp_path, capsys, case):  # noqa: F811
    extra, message = EXPORT_EXIT_2[case]
    argv = ["export-model", "--ckpt", mon.m.ckpt, "--out", str(tmp_path / "o"), *extra]
    rc, _, err = _run(cli.main, argv, capsys)
    assert rc == 2 and message in err and not os.path.exists(tmp_path / "o")
    # the JAX command on the port's arguments (the same flags, with --device)
    jrc, _, jerr = _run(jax_export_cli.cmd_export_model, cli.build_parser().parse_args(argv), capsys)
    assert jrc == 2 and jerr == err


def test_cli_export_model_names_its_platforms_and_needs_scalers(mon, tmp_path, capsys):  # noqa: F811
    rc, _, err = _run(cli.main, ["export-model", "--ckpt", mon.m.ckpt, "--out",
                                 str(tmp_path / "o"), "--platforms", "cpu,tpu"], capsys)
    assert rc == 2 and "['tpu']" in err and "cpu, cuda" in err
    rc, _, err = _run(cli.main, ["export-model", "--ckpt", mon.m.bare, "--out",
                                 str(tmp_path / "o")], capsys)
    assert rc == 2 and "has no stored scalers" in err


# ---- serve ----

SERVE_EXIT_2 = {
    "neither": ([], "exactly one of --ckpt or --artifact"),
    "both": (["--ckpt", "c", "--artifact", "ART"], "exactly one of --ckpt or --artifact"),
    "artifact and head": (["--artifact", "ART", "--head", "h.npz"], "--head is baked"),
    "artifact and glitch": (["--artifact", "ART", "--glitch-alarm-n", "5"],
                            "--glitch-alarm-n is baked"),
    "artifact and conformal": (["--artifact", "ART", "--conformal"],
                               "--conformal calibration is baked"),
    "artifact and gamma": (["--artifact", "ART", "--conformal-gamma", "0.1"],
                           "--conformal-gamma is baked"),
    "gamma without conformal": (["--ckpt", "c", "--conformal-gamma", "0.1"],
                                "--conformal-gamma needs --conformal"),
}


@pytest.mark.parametrize("case", sorted(SERVE_EXIT_2))
def test_cli_serve_argument_errors_match_jax(mon, tmp_path, capsys, case):  # noqa: F811
    extra, message = SERVE_EXIT_2[case]
    art = str(tmp_path / "a.pt2")
    open(art, "wb").close()
    argv = ["serve", "--mat", mon.mat, *[art if a == "ART" else a for a in extra]]
    rc, _, err = _run(cli.main, argv, capsys)
    assert rc == 2 and message in err
    # the JAX command on the port's arguments (the same flags, with --device)
    jrc, _, jerr = _run(jax_serve_cli.cmd_serve, cli.build_parser().parse_args(argv), capsys)
    assert jrc == 2 and jerr == err


@pytest.mark.parametrize("kind", ["pinnfc_monitor_step_stablehlo", "pinnfc_torch_scorer"])
def test_cli_serve_refuses_a_jax_or_scorer_artifact(mon, tmp_path, capsys, kind):  # noqa: F811
    art = str(tmp_path / "a.bin")
    open(art, "wb").close()
    json.dump({"kind": kind}, open(art + ".meta.json", "w"))
    rc, _, err = _run(cli.main, ["serve", "--mat", mon.mat, "--artifact", art, "--device",
                                 "cpu"], capsys)
    assert rc == 2 and repr(kind) in err
    if kind.endswith("stablehlo"):
        assert "JAX package" in err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(port, path, obj=None):
    url = f"http://127.0.0.1:{port}{path}"
    req = urllib.request.Request(url, data=None if obj is None else json.dumps(obj).encode(),
                                 method="GET" if obj is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read().decode()
            return r.status, (body if path == "/metrics" else json.loads(body))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextlib.contextmanager
def _running(make):
    srv = make()
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()


def _requests(x, v):
    return [("/observe", {"x": x[:60].tolist(), "v": v[:60].tolist()}),
            ("/observe", {"x": x[60:130].tolist(), "v": v[60:130].tolist(), "stream": "b"}),
            ("/observe_many", {"streams": ["b", "c"], "x": np.stack([x[130:160], x[160:190]])
                               .tolist(), "v": np.stack([v[130:160], v[160:190]]).tolist()}),
            ("/reset", {"stream": "c"}),
            ("/observe", {"x": x[190:256].tolist(), "v": v[190:256].tolist()}),
            ("/observe", {"x": [[1.0, 2.0]], "v": [3.0]}),
            ("/health", None), ("/metrics", None)]


def _payload_as_output(p):
    """A JSON /observe payload as MonitorOutput arrays (null → NaN)."""
    def f(key, dtype=np.float32):
        return None if key not in p else np.asarray(
            [np.nan if a is None else a for a in p[key]] if dtype == np.float32 else p[key],
            dtype)

    def rows(key):
        return np.asarray([[np.nan if a is None else a for a in r] for r in p[key]], np.float32)

    return monitor.MonitorOutput(
        rf_smooth=f("rf_smooth"), rf_inst=f("rf_inst"), residuals=None, v_pred=f("v_pred"),
        warn=f("warn", bool), danger=f("danger", bool), v_alarm=f("v_alarm", bool),
        glitch=f("glitch", bool), sensor_alarm=f("sensor_alarm", bool),
        fault_probs=rows("fault_probs"), fault_pred=f("fault_pred", np.int32),
        layer_scores=rows("layer_scores"), layer_c=rows("layer_c"), oob=f("oob", bool),
        conformal_p=f("conformal_p"), aci_alpha=f("aci_alpha"),
        aci_anomaly=f("aci_anomaly", bool))


def _same_payload(got, want, n_calib):
    assert got.keys() == want.keys()
    for k in ("n_seen", "stream", "stream_n_seen", "layer_names", "conformal_alpha",
              "stream_low_p"):
        assert got.get(k) == want.get(k), k
    _same_out(_payload_as_output(got), _payload_as_output(want), n_calib=n_calib)
    clear = [None in p or sorted(p)[-1] - sorted(p)[-2] > 2e-3 for p in want["fault_probs"]]
    assert [g for g, c in zip(got["fault_names"], clear) if c] == [
        w for w, c in zip(want["fault_names"], clear) if c]


def _metrics_skeleton(text):
    """The exposition's HELP/TYPE lines and series (name and labels), values
    dropped, timing series left out."""
    return [ln.rsplit(" ", 1)[0] if not ln.startswith("#") else ln
            for ln in text.splitlines() if "observe_seconds_sum" not in ln]


def test_server_payloads_and_metrics_match_jax(mon):  # noqa: F811
    """The same requests to the port's server and JAX's, each around its
    package's monitor (head, conformal with an adaptive level, provenance)."""
    x, v = _stream(mon)
    prov = {"created": "2026-01-01T00:00:00+00:00", "seed": 7}
    port_mon = _port(mon, **_full_kw(mon))
    jax_mon = jax_monitor.OnlineMonitor(mon.m.jp, mon.m.jds.scaler_x, mon.m.jds.scaler_y,
                                        mon.mu, mon.sigma, diagnosis=_heads(mon)[1],
                                        conformal_calib=mon.calib, conformal_gamma=GAMMA)
    results = []
    for make in (lambda: server.make_server(port_mon, port=0, provenance=prov),
                 lambda: jax_server.make_server(jax_mon, port=0, provenance=prov)):
        with _running(make) as port:
            results.append([_request(port, path, obj) for path, obj in _requests(x, v)])
    got, want = results
    assert [c for c, _ in got] == [c for c, _ in want] == [200, 200, 200, 200, 200, 400, 200, 200]
    for (_, g), (_, w), (path, _) in zip(got, want, _requests(x, v)):
        if path == "/observe" and "error" not in w:
            _same_payload(g, w, len(mon.calib))
        elif path == "/observe_many":
            assert g["n_seen"] == w["n_seen"] and g["results"].keys() == w["results"].keys()
            for k in w["results"]:
                _same_payload(g["results"][k], w["results"][k], len(mon.calib))
        elif path == "/metrics":
            assert _metrics_skeleton(g) == _metrics_skeleton(w)
            exact = [ln for ln in w.splitlines() if ln.startswith(
                ("pinnfc_requests_total", "pinnfc_samples", "pinnfc_streams ",
                 "pinnfc_stream_n_seen", "pinnfc_stream_oob", "pinnfc_stream_conformal_low_p",
                 "pinnfc_model_info"))]
            assert exact and set(exact) <= set(g.splitlines())
        else:
            assert g == w, path


def test_state_path_restart_resumes_the_bank_bitwise(mon, tmp_path):  # noqa: F811
    """``serve(state_path=)`` snapshots after every request; a new server on
    the same path restores the bank and continues as the uninterrupted
    monitor does, bit for bit."""
    x, v = _stream(mon)
    path = str(tmp_path / "bank")
    blocks = [(x[i:i + 50], v[i:i + 50]) for i in range(0, 200, 50)]

    def serve_blocks(pairs):
        port = _free_port()
        mon_ = _port(mon, **_full_kw(mon))
        t = threading.Thread(target=server.serve, args=(mon_,), kwargs=dict(
            port=port, max_requests=len(pairs), state_path=path), daemon=True)
        t.start()
        outs = []
        for xb, vb in pairs:
            for _ in range(100):
                try:
                    outs.append(_request(port, "/observe", {"x": xb.tolist(), "v": vb.tolist(),
                                                            "stream": "s"})[1])
                    break
                except urllib.error.URLError:
                    threading.Event().wait(0.05)
        t.join(60)
        return outs

    first = serve_blocks(blocks[:2])
    second = serve_blocks(blocks[2:])
    whole = _port(mon, **_full_kw(mon))
    want = [server._json_payload(whole.observe(xb, vb, stream="s"), whole, "s")
            for xb, vb in blocks]
    assert len(first) == len(second) == 2
    for g, w in zip(first + second, want):
        assert g["rf_smooth"] == w["rf_smooth"] and g["layer_c"] == w["layer_c"]
        assert g["conformal_p"] == w["conformal_p"] and g["aci_alpha"] == w["aci_alpha"]
        assert g["stream_n_seen"] == w["stream_n_seen"]


def test_cli_serve_from_a_checkpoint_and_an_artifact(mon, tmp_path, capsys):  # noqa: F811
    """``cli serve --ckpt`` and ``--artifact`` (an ``export-model
    --monitor-step`` file) on the CPU answer /observe with the same payload."""
    m = mon.m
    step = str(tmp_path / "step.pt2")
    assert cli.main(["export-model", "--ckpt", m.ckpt, "--out", step, "--monitor-step"]) == 0
    x, v = _stream(mon)
    payloads = []
    for source in (["--ckpt", m.ckpt], ["--artifact", step]):
        port = _free_port()
        t = threading.Thread(target=cli.main, args=(["serve", "--mat", mon.mat, *source,
                                                     "--port", str(port), "--max-requests", "2",
                                                     "--device", "cpu"],), daemon=True)
        t.start()
        for _ in range(200):
            try:
                payloads.append(_request(port, "/observe", {"x": x[:40].tolist(),
                                                            "v": v[:40].tolist()})[1])
                break
            except urllib.error.URLError:
                threading.Event().wait(0.05)
        health = _request(port, "/health")[1]
        t.join(60)
        assert not t.is_alive() and health["ok"] and health["n_seen"] == 40
    out = capsys.readouterr().out
    assert "serving from torch.export artifact" in out and out.count("server closed") == 2
    a, b = payloads
    assert a.keys() == b.keys() and a["rf_smooth"] == b["rf_smooth"]
    assert a["v_pred"] == b["v_pred"] and a["layer_c"] == b["layer_c"]
