"""Port parity for real measurement campaigns: ``pinnfc_tpu_torch.data.loaders``
and ``data.campaign`` against the JAX package's, the ``campaign=`` path of the
pipelines, and ``cli synth`` / ``--normal-mat`` / ``--fault-dir``.

Both packages load the same .mat files on the CPU.  The loaders are numpy and
scipy in both, and normalization runs in numpy in both, so every array of the
datasets is compared bitwise, as are the error classes and messages of the
loaders on malformed files (those of ``tests/test_malformed_ingestion.py``).
The command-line round trip runs in a subprocess that must not import JAX.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import scipy.io
import torch

from _torch_campaign import N_FAULT, campaign  # noqa: F401  (fixture)
from pinnfc_tpu.data import campaign as jax_campaign
from pinnfc_tpu.data import loaders as jax_loaders
from pinnfc_tpu.data.scaling import AffineScaler as JaxScaler
import pinnfc_tpu_torch
from pinnfc_tpu_torch import cli
from pinnfc_tpu_torch.cli._common import _small_schedule
from pinnfc_tpu_torch.config import TrainConfig, train_config_to_dict
from pinnfc_tpu_torch.data import campaign as port_campaign
from pinnfc_tpu_torch.data import loaders as port_loaders
from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.data.contract import load_comprehensive_results
from pinnfc_tpu_torch.pipeline import score as score_mod
from pinnfc_tpu_torch.pipeline.train_pipeline import run_training_pipeline
from pinnfc_tpu_torch.utils.checkpoint import save_checkpoint
from pinnfc_tpu_torch.utils.threads import one_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_datasets_equal(jds, ds):
    for name in ("x_train", "y_train", "x_test", "y_test"):
        a, b = np.asarray(getattr(jds, name)), getattr(ds, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in ("scaler_x", "scaler_y"):
        ja, pa = getattr(jds, name).to_numpy(), getattr(ds, name).to_numpy()
        assert set(ja) == set(pa)
        for key in ja:
            np.testing.assert_array_equal(pa[key], np.asarray(ja[key]), err_msg=f"{name}.{key}")
    ji, pi = jds.info, ds.info
    assert list(pi.boundary_lines) == list(ji.boundary_lines)
    assert list(pi.segment_labels) == list(ji.segment_labels)
    assert (pi.normal_samples, pi.fault_samples) == (ji.normal_samples, ji.fault_samples)
    np.testing.assert_array_equal(pi.train_indices, ji.train_indices)


@pytest.mark.parametrize("names", ["ascii", "zh"])
@pytest.mark.parametrize("with_scalers", [False, True])
def test_campaign_dataset_matches_jax(campaign, names, with_scalers):  # noqa: F811
    d = campaign.ascii_dir if names == "ascii" else campaign.zh_dir
    jcfg = jax_campaign.CampaignConfig.from_dir(f"{d}/Polar-1.mat", d)
    cfg = port_campaign.CampaignConfig.from_dir(f"{d}/Polar-1.mat", d)
    assert cfg.fault_paths == jcfg.fault_paths
    assert all(os.path.exists(p) for p, _ in cfg.fault_paths)
    jscalers = scalers = None
    if with_scalers:  # the scoring path: a checkpoint's scalers, fitted elsewhere
        rs = np.random.RandomState(3)
        jscalers = (JaxScaler.fit(rs.uniform(0, 500, (50, 8))),
                    JaxScaler.fit(rs.uniform(20, 40, (50, 1))))
        scalers = tuple(AffineScaler.from_numpy(s.to_numpy(), device="cpu") for s in jscalers)
    jds = jax_campaign.load_campaign_dataset(jcfg, scalers=jscalers)
    ds = port_campaign.load_campaign_dataset(cfg, scalers=scalers, device="cpu")
    assert ds.x_test.shape == (jds.info.normal_samples + 12 * N_FAULT, 8)
    _assert_datasets_equal(jds, ds)


def test_port_writer_matches_the_jax_layout(campaign, tmp_path):  # noqa: F811
    """The port's write_campaign_mats writes files the JAX loader reads to the
    arrays the JAX writer's files give, under the same names."""
    for ascii_names, ref in ((True, campaign.ascii_dir), (False, campaign.zh_dir)):
        out = str(tmp_path / str(ascii_names))
        cfg = port_campaign.write_campaign_mats(out, campaign.normal, campaign.faults,
                                                ascii_names=ascii_names)
        assert sorted(os.listdir(out)) == sorted(os.listdir(ref))
        want = jax_campaign.load_campaign(jax_campaign.CampaignConfig.from_dir(
            f"{ref}/Polar-1.mat", ref))
        got = jax_campaign.load_campaign(jax_campaign.CampaignConfig(
            normal_path=cfg.normal_path, fault_paths=cfg.fault_paths))
        for a, b in zip(want[0], got[0]):
            np.testing.assert_array_equal(b, a)
        for (xa, ya, la), (xb, yb, lb) in zip(want[1], got[1]):
            assert la == lb
            np.testing.assert_array_equal(xb, xa)
            np.testing.assert_array_equal(yb, ya)
    with pytest.raises(ValueError, match="12 fault segments"):
        port_campaign.write_campaign_mats(str(tmp_path / "short"), campaign.normal,
                                          campaign.faults[:5])


def test_default_fault_paths_prefer_chinese_names(tmp_path):
    d = tmp_path / "mixed"
    d.mkdir()
    (d / "水淹_108A.mat").write_bytes(b"")
    (d / "water_flooding_108A.mat").write_bytes(b"")
    (d / "oxygen_starvation_270A.mat").write_bytes(b"")
    got = port_campaign.default_fault_paths(str(d))
    assert got == jax_campaign.default_fault_paths(str(d))
    assert got[0] == (str(d / "水淹_108A.mat"), "水淹故障(108A)")
    assert got[4] == (str(d / "oxygen_starvation_270A.mat"), "氧饥饿故障(270A)")
    assert got[1][0] == str(d / "水淹_270A.mat")  # neither exists: the Chinese name
    assert port_campaign.default_fault_paths(str(tmp_path / "none")) == \
        jax_campaign.default_fault_paths(str(tmp_path / "none"))


def _normal(path, n=100, **overrides):
    rng = np.random.RandomState(0)
    data = {k: rng.uniform(0.5, 1.5, n) for k in jax_loaders.NORMAL_X_KEYS}
    data["I"] = rng.uniform(100, 400, n)
    data["U"] = rng.uniform(80, 100, n)
    data.update(overrides)
    scipy.io.savemat(path, data)


def _fault(path, n=50, n_cols=70, **cols):
    seg = np.random.RandomState(1).uniform(0.5, 1.5, (n, n_cols))
    for k, v in cols.items():
        seg[:, int(k)] = v
    scipy.io.savemat(path, {"segment_double": seg})


def _truncated(path, keep):
    _normal(path)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:keep(len(blob))])


def _without(path, *keys):
    _normal(path)
    data = {k: v for k, v in scipy.io.loadmat(path).items()
            if not k.startswith("__") and k not in keys}
    scipy.io.savemat(path, data)


MALFORMED = {
    "truncated_third": ("normal", lambda p: _truncated(p, lambda n: n // 3)),
    "cut0": ("normal", lambda p: _truncated(p, lambda n: 0)),
    "cut8": ("normal", lambda p: _truncated(p, lambda n: 8)),
    "cut64": ("normal", lambda p: _truncated(p, lambda n: 64)),
    "cut100": ("normal", lambda p: _truncated(p, lambda n: 100)),
    "garbage": ("fault", lambda p: open(p, "wb").write(b"\x00\x01not a mat file" * 10)),
    "missing_channels": ("normal", lambda p: _without(p, "m_H2", "U")),
    "no_segment_double": ("fault", lambda p: scipy.io.savemat(
        p, {"wrong_name": np.zeros((10, 70))})),
    "length_mismatch": ("normal", lambda p: _normal(p, m_O2=np.ones(37))),
    "too_few_columns": ("fault", lambda p: _fault(
        p, n_cols=int(jax_loaders.FAULT_CORR_INDEX.max()) + 1 - 10)),
    "one_dimensional": ("fault", lambda p: scipy.io.savemat(
        p, {"segment_double": np.arange(5.0)})),
    "nan_current": ("normal", lambda p: _normal(p, I=np.full(100, np.nan))),
    "zero_coolant": ("fault", lambda p: _fault(
        p, **{str(jax_loaders.FAULT_CORR_INDEX[1]): 0.0})),
    "missing_file": ("normal", lambda p: None),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_loaders_raise_what_the_jax_loaders_raise(tmp_path, case):
    kind, make = MALFORMED[case]
    path = str(tmp_path / f"{case}.mat")
    make(path)
    fn = "load_normal_mat" if kind == "normal" else "load_fault_mat"
    with pytest.raises(Exception) as want:
        getattr(jax_loaders, fn)(path)
    with pytest.raises(Exception) as got:
        getattr(port_loaders, fn)(path)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
    assert case + ".mat" in str(got.value)


@pytest.mark.parametrize("kind", ["normal", "fault"])
def test_loaders_keep_what_the_jax_loaders_keep(tmp_path, kind):
    """Finite current with NaN elsewhere, (1, N) channels, and the row
    filters: the same rows come through, bitwise."""
    path = str(tmp_path / "ok.mat")
    if kind == "normal":
        cur = np.random.RandomState(2).uniform(0, 900, (1, 100))
        _normal(path, I=cur, m_W=np.full(100, np.nan))
        fn = "load_normal_mat"
    else:
        col = np.where(np.arange(50) % 3 == 0, 0.0, 1.0)
        _fault(path, **{str(jax_loaders.FAULT_CORR_INDEX[1]): col})
        fn = "load_fault_mat"
    for a, b in zip(getattr(jax_loaders, fn)(path), getattr(port_loaders, fn)(path)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("skip_missing", [True, False])
@pytest.mark.parametrize("damage", ["missing", "unreadable"])
def test_missing_or_unreadable_fault_file(campaign, tmp_path, skip_missing, damage):  # noqa: F811
    d = tmp_path / "camp"
    port_campaign.write_campaign_mats(str(d), campaign.normal, campaign.faults)
    victim = d / "membrane_drying_270A.mat"
    if damage == "missing":
        victim.unlink()
    else:
        victim.write_bytes(b"\x00\x01not a mat file" * 10)
    kw = dict(skip_missing=skip_missing)
    jcfg = jax_campaign.CampaignConfig.from_dir(str(d / "Polar-1.mat"), str(d), **kw)
    cfg = port_campaign.CampaignConfig.from_dir(str(d / "Polar-1.mat"), str(d), **kw)
    if skip_missing:
        with pytest.warns(UserWarning, match="skipped") as wj:
            jds = jax_campaign.load_campaign_dataset(jcfg)
        with pytest.warns(UserWarning, match="skipped") as wp:
            ds = port_campaign.load_campaign_dataset(cfg, device="cpu")
        assert [str(w.message) for w in wp] == [str(w.message) for w in wj]
        assert len(ds.info.segment_labels) == 11
        _assert_datasets_equal(jds, ds)
    else:
        with pytest.raises(Exception) as want:
            jax_campaign.load_campaign(jcfg)
        with pytest.raises(Exception) as got:
            port_campaign.load_campaign(cfg)
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("argv", [
    ["train", "--normal-mat", "x.mat"],
    ["train", "--fault-dir", "d"],
    ["train", "--ckpt-every", "5"],
    ["score", "--ckpt", "ck", "--normal-mat", "x.mat"],
    ["score", "--ckpt", "ck", "--fault-dir", "d"],
])
def test_cli_return_codes_for_bad_flag_combinations(tmp_path, argv, capsys):
    """A lone --normal-mat or --fault-dir, and --ckpt-every without
    --resume-dir, return 2 before any work, as the JAX command line does."""
    argv = [a if a not in ("x.mat", "d", "ck") else str(tmp_path / a) for a in argv]
    assert cli.main([*argv, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "--resume-dir" in err or "BOTH --normal-mat and --fault-dir" in err


def test_cli_score_builds_the_campaign_with_the_training_seed(campaign, tmp_path,  # noqa: F811
                                                             monkeypatch):
    """The sidecar's seed reaches the campaign that ``score`` builds (and the
    MC settings its config), unless --ignore-ckpt-config."""
    ck = str(tmp_path / "ck")
    cfg = TrainConfig(seed=7, mc_times=5)
    save_checkpoint(ck, campaign.params(), campaign.ds.scaler_x, campaign.ds.scaler_y,
                    meta={"config": train_config_to_dict(cfg)})
    seen = {}

    def fake_score(ckpt_path, config=None, campaign=None, **kw):
        seen.update(seed=campaign.seed, config_seed=config.seed, mc_times=config.mc_times)
        raise ValueError("stop here")

    monkeypatch.setattr(score_mod, "run_scoring_pipeline", fake_score)
    flags = ["score", "--ckpt", ck, "--device", "cpu", "--normal-mat",
             campaign.config.normal_path, "--fault-dir", campaign.ascii_dir]
    assert cli.main(flags) == 1
    assert seen == {"seed": 7, "config_seed": 7, "mc_times": 5}
    assert cli.main([*flags, "--ignore-ckpt-config"]) == 1
    assert seen == {"seed": 42, "config_seed": 42, "mc_times": 2000}
    assert cli.main([*flags, "--seed", "3"]) == 1
    assert seen == {"seed": 3, "config_seed": 3, "mc_times": 5}


def test_campaign_reaches_the_pipelines(campaign, tmp_path):  # noqa: F811
    """``campaign=`` gives the pipelines the dataset load_campaign_dataset
    gives (through the checkpoint's scalers when scoring), and scoring the
    training campaign under its other file names reproduces the train-time
    artifact; ``dataset=`` wins over ``campaign=``."""
    cfg = dataclasses.replace(TrainConfig(), mc_times=2, smooth_window=20, schedule=tuple(
        dataclasses.replace(s, n_iter=2) for s in _small_schedule()))
    other = port_campaign.CampaignConfig.from_dir(f"{campaign.zh_dir}/Polar-1.mat",
                                                  campaign.zh_dir)
    ck = str(tmp_path / "ck")
    with one_thread():
        res = run_training_pipeline(cfg, campaign=campaign.config, device="cpu")
        save_checkpoint(ck, res.params, res.dataset.scaler_x, res.dataset.scaler_y,
                        meta={"config": train_config_to_dict(cfg)})
        scored = score_mod.run_scoring_pipeline(ck, campaign=other, device="cpu")
    _assert_datasets_equal(campaign.ds, res.dataset)
    _assert_datasets_equal(campaign.ds, scored.dataset)
    assert res.results.array.shape == (campaign.ds.x_test.shape[0], 22)
    assert np.array_equal(scored.results.array, res.results.array, equal_nan=True)
    normal_only = port_campaign.load_campaign_dataset(
        dataclasses.replace(campaign.config, fault_paths=campaign.config.fault_paths[:1]),
        scalers=(res.dataset.scaler_x, res.dataset.scaler_y), device="cpu")
    got = score_mod.run_scoring_pipeline(ck, dataset=normal_only, campaign=other, device="cpu")
    assert got.results.array.shape == (campaign.ds.info.normal_samples + N_FAULT, 22)


def test_cli_synth_train_score_round_trip_without_jax(tmp_path):
    """``synth`` → ``train --device cpu --small`` on the files (seed 7, mid-stage
    snapshots) → ``score --device cpu`` on them reproduces the train-time
    artifact, in a process that never imports JAX; the sidecar records the
    port's version and the campaign."""
    d = str(tmp_path)
    script = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        from pinnfc_tpu_torch.cli import main
        d = sys.argv[1]
        camp = ["--normal-mat", d + "/camp/Polar-1.mat", "--fault-dir", d + "/camp"]
        assert main(["synth", "--out-dir", d + "/camp", "--n-normal", "40",
                     "--n-fault", "4", "--zh-names"]) == 0
        assert main(["train", "--device", "cpu", "--small", "--steps-scale", "0.02",
                     "--seed", "7", *camp, "--ckpt", d + "/ck", "--mat-out", d + "/t.mat",
                     "--resume-dir", d + "/rd", "--ckpt-every", "4"]) == 0
        assert main(["score", "--device", "cpu", "--ckpt", d + "/ck", *camp,
                     "--mat-out", d + "/s.mat"]) == 0
        assert "jax" not in sys.modules, "the port imported jax"
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script, d], cwd=REPO, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert "config from checkpoint meta: mc_times=200 dropout=0.4 seed=7" in proc.stdout
    assert "checkpoint provenance: created=" in proc.stdout
    assert any(n.startswith("水淹") for n in os.listdir(f"{d}/camp"))
    a = load_comprehensive_results(f"{d}/t.mat").array
    b = load_comprehensive_results(f"{d}/s.mat").array
    assert a.shape == (40 + 12 * 4, 22)
    assert np.array_equal(a, b, equal_nan=True)
    with open(f"{d}/ck.meta.json") as f:
        meta = json.load(f)
    assert meta["framework_version"] == pinnfc_tpu_torch.__version__
    assert meta["campaign"] == {"normal_mat": f"{d}/camp/Polar-1.mat",
                                "fault_dir": f"{d}/camp"}
    assert meta["config"]["seed"] == 7


def test_cli_train_sidecar_without_a_campaign(tmp_path):
    ck = str(tmp_path / "ck")
    with warnings.catch_warnings(), one_thread():
        warnings.simplefilter("ignore")
        assert cli.main(["train", "--device", "cpu", "--small", "--steps-scale", "0.01",
                         "--n-normal", "40", "--n-fault", "4", "--ckpt", ck,
                         "--mat-out", str(tmp_path / "t.mat")]) == 0
    with open(ck + ".meta.json") as f:
        meta = json.load(f)
    assert meta["campaign"] is None and meta["framework_version"]


@pytest.mark.parametrize("command", ["train", "score"])
def test_cli_on_a_campaign_needs_the_card_unless_asked_for_the_cpu(campaign, tmp_path,  # noqa: F811
                                                                   command):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    mat = str(tmp_path / "x.mat")
    argv = [command, "--normal-mat", campaign.config.normal_path, "--fault-dir",
            campaign.ascii_dir, "--mat-out", mat]
    if command == "score":
        argv += ["--ckpt", str(tmp_path / "ck")]
    assert cli.main(argv) == 1
    assert not os.path.exists(mat)
