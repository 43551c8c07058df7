"""Port parity: the figures (pinnfc_tpu_torch.viz) and ``--plot-dir`` on the
port's ten commands that have it, against the JAX package's, on the CPU.

Figures are compared by the data in their artists, read just before each is
saved (``_finish`` wrapped in both packages): line and scatter data, images,
bars, texts, titles, axis labels and scales, tick and legend labels.
Tolerances:
- the plot functions on the same inputs: rtol 1e-6; a t-SNE view (its
  embedding computed by each package) by its KL divergence, within 10 %;
- the commands (train, score, auc, gmm with and without ``--tsne``, risk,
  compare; identify, explain and conformal in tests/test_torch_explain.py):
  exactly JAX's set of file names; the figures of risk (float64 backend) at
  rtol 1e-6; of auc, gmm and compare at 1e-6 with the JAX command drawing the
  port's pipeline result, since the fits' random draws differ; auc's t-SNE
  view by KL, gmm's as each package's own ``tsne_embed`` exactly.
- ``_rolling_mean_centered`` (numpy) against the JAX package's (pandas):
  rtol 1e-12.
"""

import argparse
import contextlib
import io
import os
import sys
import types

import numpy as np
import pytest
import torch

from pinnfc_tpu.cli import diagnose as jax_diagnose
from pinnfc_tpu.cli import train as jax_cli_train
from pinnfc_tpu.viz import plots as jax_plots
from pinnfc_tpu_torch import cli
from pinnfc_tpu_torch.cli import train as cli_train
from pinnfc_tpu_torch.data.combine import combine_and_normalize
from pinnfc_tpu_torch.data.contract import INDEX, INPUT_CHANNELS, save_comprehensive_results
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.diagnosis.tsne import _pairwise_sq_dists, conditional_p, joint_p, kl_and_grad
from pinnfc_tpu_torch.models.pinn import LAMBDA_NAMES, init_pinn
from pinnfc_tpu_torch.risk import run_risk_pipeline
from pinnfc_tpu_torch.uq import GroupIdentifiability, conformal_report
from pinnfc_tpu_torch.utils.checkpoint import save_checkpoint
from pinnfc_tpu_torch.utils.threads import one_thread
from pinnfc_tpu_torch.viz import plots

from _torch_figures import captured, same

GROUP_SPEC = "正常:0 | 故障:1,2,3,4,5,6,7,8,9,10,11,12"
GMM_CLASSES = ["水淹", "氧饥饿", "膜干", "氢饥饿"]


@pytest.fixture(autouse=True)
def _pinned():
    with one_thread():
        yield


def viz_artifact() -> np.ndarray:
    """80 normal rows and the 12 fault segments of script 04's conditions
    (4 fault classes × 108/270/405 A) of 15 rows each, the residuals ramping
    in the fault rows and each class shifting one physics residual."""
    rng = np.random.RandomState(1)
    n_normal, n_fault = 80, 15
    n = n_normal + 12 * n_fault
    arr = np.zeros((n, 22))
    arr[:, :8] = rng.rand(n, 8)
    arr[:n_normal, INDEX["x0"]] = rng.uniform(100, 400, n_normal)
    arr[:, INDEX["x5"]] = 60.0 + rng.randn(n)
    arr[:, INDEX["t_phys"]] = 60.0 + rng.randn(n)
    arr[:, INDEX["y_true"]] = 4.0 + 0.01 * rng.randn(n)
    for k in ("res", "pV", "pT", "pH", "pO"):
        arr[:, INDEX[k]] = 0.1 * rng.randn(n)
    arr[:, INDEX["ale"]] = 0.01 + 0.002 * rng.rand(n)
    arr[:, INDEX["epi"]] = 0.005 + 0.001 * rng.rand(n)
    pos, label = n_normal, 1
    for fault in range(4):
        for amps in (108.0, 270.0, 405.0):
            seg = slice(pos, pos + n_fault)
            ramp = np.linspace(0.0, 3.0, n_fault)
            arr[seg, INDEX["label"]] = label
            arr[seg, INDEX["x0"]] = amps
            arr[seg, INDEX["res"]] += 0.5 * ramp
            arr[seg, INDEX["pV"]] += 0.4 * ramp
            arr[seg, INDEX[("pV", "pT", "pH", "pO")[fault]]] += rng.uniform(0.5, 1.0, n_fault)
            arr[seg, INDEX["y_true"]] = 4.0 - np.linspace(0.0, 0.3, n_fault)
            arr[seg, INDEX["epi"]] += 0.004
            pos += n_fault
            label += 1
    arr[:, INDEX["y_pred"]] = arr[:, INDEX["y_true"]] - arr[:, INDEX["res"]]
    return arr


BOUNDS = [80 + 15 * k for k in range(13)]


@pytest.fixture(scope="module")
def arr():
    return viz_artifact()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A narrow port checkpoint with the scalers of a small campaign."""
    normal, faults = synthesize_stack_data(n_normal=100, n_fault=10, seed=42)
    ds = combine_and_normalize(normal, faults, device="cpu")
    path = str(tmp_path_factory.mktemp("viz_ckpt") / "ck")
    params = init_pinn((8, 32, 32, 1), generator=torch.Generator().manual_seed(1), device="cpu")
    save_checkpoint(path, params, ds.scaler_x, ds.scaler_y)
    return path


# ---- t-SNE views ----

def _kl(x, y2d, perplexity):
    p = joint_p(conditional_p(_pairwise_sq_dists(torch.as_tensor(x, dtype=torch.float32)),
                              perplexity))
    return float(kl_and_grad(torch.as_tensor(y2d, dtype=torch.float32), p)[0])


def _class_order(y):
    return np.concatenate([np.flatnonzero(y == c) for c in np.unique(y)])


def _same_tsne_view(got, want, x, y, perplexity):
    """A t-SNE scatter: everything but the points, limits and automatic
    ticks at rtol 1e-6; the points (per class, in class order) by the KL of
    the embedding they make, within 10 % of JAX's."""
    (g,), (w,) = got, want
    kls = [_kl(x[_class_order(y)], np.concatenate(fig["offsets"]), perplexity) for fig in (g, w)]
    assert abs(kls[0] - kls[1]) <= 0.1 * kls[1], kls
    strip = ("offsets", "lim", "ticks")
    same({k: v for k, v in g.items() if k not in strip},
          {k: v for k, v in w.items() if k not in strip}, 1e-6)


# ---- the plot functions ----

def _advances(arr):
    return run_risk_pipeline(arr, backend="numpy")


def _ident_report():
    rng = np.random.RandomState(2)
    report = {}
    for g, names in LAMBDA_NAMES.items():
        k = len(names)
        ident = np.ones(k, bool)
        ident[-1] = False
        at_bound = np.zeros(k, bool)
        at_bound[0] = g == "lam_h"
        stderr = np.where(ident, rng.rand(k), np.inf)
        values = rng.randn(k)
        report[g] = GroupIdentifiability(g, names, values, stderr, values - stderr,
                                         values + stderr, rng.rand(k), ident, at_bound, 100, 0,
                                         96, 0.5, np.eye(k))
    return report


def _cases(arr):
    rng = np.random.RandomState(4)
    labels = arr[:, INDEX["label"]].astype(int)
    auc = types.SimpleNamespace(
        groups=[types.SimpleNamespace(group_id=i, features=f, auc=0.5 + 0.1 * i,
                                      fpr=np.sort(rng.rand(30)), tpr=np.sort(rng.rand(30)))
                for i, f in enumerate(("epi,res", "res"))],
        iso_fpr=np.linspace(0, 1, 20), iso_tpr=np.sqrt(np.linspace(0, 1, 20)), iso_auc=0.8)
    y_true = rng.randint(0, 4, 60)
    gmm = types.SimpleNamespace(y_true=y_true, y_prob=rng.dirichlet(np.ones(4), 60),
                                class_names=GMM_CLASSES)
    summary = {m: {k: rng.rand() for k in ("accuracy", "precision_macro", "recall_macro",
                                            "f1_macro")} for m in ("GMM", "KMeans", "Spectral")}
    table = {n: rng.rand(8) for n in ("normal", "Flooding", "Membrane drying")}
    whatif = {"108A 水淹": rng.randn(8), "270A 膜干": np.zeros(8)}
    advances = _advances(arr)
    return {
        "uncertainty": lambda m: m.plot_uncertainty(arr, BOUNDS, "uncertainty.png"),
        "uncertainty_no_bounds": lambda m: m.plot_uncertainty(arr, [], "u.png", window_size=7),
        "detailed": lambda m: m.plot_detailed_results(arr, "detailed.png", BOUNDS),
        "temp_comparison": lambda m: m.plot_temp_comparison(arr, "temp.png", BOUNDS),
        "split_overview": lambda m: m.plot_split_overview(arr, BOUNDS, "split.png"),
        "roc": lambda m: m.plot_roc_curves(auc, "roc.png"),
        "scatter_2_features": lambda m: m.plot_scatter_by_features(arr, "res,epi", GROUP_SPEC,
                                                                   "s.png"),
        "feature_scatter": lambda m: m.plot_feature_scatter(
            arr[:, [INDEX["pV"], INDEX["pT"]]], labels % 4, "f.png", GMM_CLASSES, "a title"),
        "feature_scatter_unnamed": lambda m: m.plot_feature_scatter(arr[:, :2], labels, "g.png"),
        "temp_vs_voltage": lambda m: m.plot_temp_vs_voltage(arr, "tv.png"),
        "res_vs_epi": lambda m: m.plot_res_vs_epi(arr, "re.png"),
        "fault_probabilities": lambda m: [m.plot_fault_probabilities(gmm, k, f"p{k}.png")
                                          for k in range(4)],
        "rf": lambda m: [(m.plot_rf_condition(a, 0.3, 0.6, f"rf{i}.png"),
                          m.plot_rf_attribution(a, f"attr{i}.png"))
                         for i, a in enumerate(advances[:4])],
        "confusion": lambda m: m.plot_confusion_matrix(rng_cm, ["正常", "故障"], "cm.png", "LR"),
        "metrics_bars": lambda m: m.plot_metrics_bars(summary, "bars.png"),
        "identifiability": lambda m: m.plot_identifiability(_ident_report(), "ident.png"),
        "saliency": lambda m: m.plot_saliency(table, INPUT_CHANNELS, "sal.png", unit="V"),
        "whatif": lambda m: m.plot_whatif(whatif, INPUT_CHANNELS, "whatif.png"),
        "conformal": lambda m: m.plot_conformal(conformal_report(arr), "conf.png"),
    }


rng_cm = np.array([[50, 3], [7, 90]])
CASES = list(_cases(viz_artifact()))


@pytest.mark.parametrize("case", CASES)
def test_plot_function_matches_jax(arr, case, monkeypatch):
    draw = _cases(arr)[case]
    with captured(monkeypatch, jax_plots, save=False) as want:
        draw(jax_plots)
    with captured(monkeypatch, plots, save=False) as got:
        draw(plots)
    assert list(got) == list(want) and want
    same(got, want, 1e-6)


def test_tsne_embed_matches_jax(monkeypatch):
    """``tsne_embed`` at perplexity 20, as ``gmm --tsne`` calls it, on the
    160 rows of four blobs of tests/test_torch_tsne.py (the 4-feature scatter
    view of ``auc --plot-dir`` is held below)."""
    rng = np.random.RandomState(0)
    centers = np.array([[0, 0, 0, 0], [6, 0, 0, 0], [0, 6, 0, 0], [0, 0, 6, 6]], dtype=float)
    sub = np.vstack([c + rng.randn(40, 4) for c in centers])
    emb = plots.tsne_embed(sub, perplexity=20.0, device="cpu")
    jemb = jax_plots.tsne_embed(sub, perplexity=20.0)
    assert emb.dtype == np.float64 and emb.shape == (160, 2)
    kls = _kl(sub, emb, 20.0), _kl(sub, jemb, 20.0)
    assert abs(kls[0] - kls[1]) <= 0.1 * kls[1]
    np.testing.assert_array_equal(emb, plots.tsne_embed(sub, perplexity=20.0, device="cpu"))
    with pytest.raises(ValueError, match="backend"):
        plots.tsne_embed(sub, backend="gpu")
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        plots.tsne_embed(sub, backend="sklearn")


@pytest.mark.parametrize("window,n,nan_at", [(5, 40, None), (4, 40, None), (50, 20, None),
                                             (7, 40, [3, 4, 5, 6, 7, 8, 9, 20])])
def test_rolling_mean_matches_pandas(window, n, nan_at):
    data = np.random.RandomState(window).randn(n)
    if nan_at:
        data[nan_at] = np.nan
    got = plots._rolling_mean_centered(data, window)
    want = jax_plots._rolling_mean_centered(data, window)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)


def test_names_and_lazy_matplotlib():
    for name in GMM_CLASSES + ["other"]:
        assert plots.fault_prob_filename(name) == jax_plots.fault_prob_filename(name)
    for name in ("水淹故障(108A)", "正常", "膜干"):
        assert plots.display_name(name) == jax_plots.display_name(name)
    import pinnfc_tpu_torch.viz as viz
    import pinnfc_tpu.viz as jax_viz

    assert viz.__all__ == jax_viz.__all__ and len(viz.__all__) == 20


# ---- --plot-dir on the commands ----

def _run_jax(fn, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        assert fn(argparse.Namespace(**kw)) == 0


def _files(d):
    return sorted(os.listdir(d))


def test_emit_train_figures_matches_jax(arr, tmp_path, monkeypatch):
    res = types.SimpleNamespace(results=arr, dataset=types.SimpleNamespace(
        info=types.SimpleNamespace(boundary_lines=BOUNDS)))
    with captured(monkeypatch, jax_plots, save=False) as want, \
            contextlib.redirect_stdout(io.StringIO()):
        jax_cli_train._emit_train_figures(res, str(tmp_path / "jax"))
    with captured(monkeypatch, plots) as got, contextlib.redirect_stdout(io.StringIO()):
        assert cli_train._draw_figures("train", str(tmp_path / "port"), lambda: (
            cli_train._emit_train_figures(res, str(tmp_path / "port")))) == 0
    assert _files(tmp_path / "port") == sorted(want) == [
        "detailed.png", "split.png", "temp_comparison.png", "uncertainty_aleatoric.png",
        "uncertainty_epistemic.png"]
    same(got, want, 1e-6)


def test_cli_train_and_score_plot_dir(ckpt, tmp_path, capsys):
    """``train --plot-dir`` and ``score --plot-dir`` write the figure set of
    ``_emit_train_figures`` (above); a schedule of a few steps per stage."""
    flags = ["--n-normal", "100", "--n-fault", "10", "--device", "cpu"]
    assert cli.main(["train", "--small", "--steps-scale", "0.01", "--mat-out",
                     str(tmp_path / "t.mat"), "--plot-dir", str(tmp_path / "train"),
                     *flags]) == 0
    assert cli.main(["score", "--ckpt", ckpt, "--mc-times", "4", "--mat-out",
                     str(tmp_path / "s.mat"), "--plot-dir", str(tmp_path / "score"),
                     *flags]) == 0
    out = capsys.readouterr().out
    assert out.count("figures →") == 2
    want = ["detailed.png", "split.png", "temp_comparison.png", "uncertainty_aleatoric.png",
            "uncertainty_epistemic.png"]
    assert _files(tmp_path / "train") == _files(tmp_path / "score") == want


@pytest.fixture(scope="module")
def viz_mat(arr, tmp_path_factory):
    mat = str(tmp_path_factory.mktemp("viz") / "F01_output.mat")
    save_comprehensive_results(arr, mat)
    return mat


def _port_then_jax(monkeypatch, pipeline, argv, jax_fn, **jax_kw):
    """The port's command (its ``pipeline`` result recorded), then the JAX
    command drawing that result: (the port's figures, JAX's figures, the
    result).  The
    pipelines themselves are held to JAX's in
    tests/test_torch_diagnosis_pipelines.py and tests/test_torch_compare.py;
    their random draws differ, so the figures are compared on one result."""
    import pinnfc_tpu.diagnosis as jax_diagnosis
    import pinnfc_tpu_torch.diagnosis as diagnosis

    runs = []
    orig = getattr(diagnosis, pipeline)

    def recorded(*a, **k):
        runs.append(orig(*a, **k))
        return runs[-1]

    monkeypatch.setattr(diagnosis, pipeline, recorded)
    with captured(monkeypatch, plots) as got, contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(argv) == 0
    monkeypatch.setattr(jax_diagnosis, pipeline, lambda *a, **k: runs[0])
    with captured(monkeypatch, jax_plots, save=False) as want:
        _run_jax(jax_fn, **jax_kw)
    return got, want, runs[0]


def test_cli_auc_plot_dir(arr, viz_mat, tmp_path, monkeypatch):
    got, want, _ = _port_then_jax(
        monkeypatch, "run_auc_pipeline",
        ["auc", "--mat", viz_mat, "--device", "cpu", "--plot-dir", str(tmp_path / "p")],
        jax_diagnose.cmd_auc, mat=viz_mat, group_spec=None, test_size=None, balanced=None,
        show_coef=0, list_features=False, plot_dir=str(tmp_path / "j"))
    assert _files(tmp_path / "p") == sorted(want) == [
        "feature_scatter.png", "res_vs_epi.png", "roc.png", "temp_vs_v.png"]
    for name in ("res_vs_epi.png", "roc.png", "temp_vs_v.png"):
        same(got[name], want[name], 1e-6)
    x, y, _ = plots.scatter_features(arr, "x0,x3,x4,x5", GROUP_SPEC)
    _same_tsne_view(got["feature_scatter.png"], want["feature_scatter.png"], x, y, 30.0)


@pytest.mark.parametrize("tsne", [False, True])
def test_cli_gmm_plot_dir(arr, viz_mat, tmp_path, monkeypatch, tsne):
    argv = ["gmm", "--mat", viz_mat, "--device", "cpu", "--plot-dir", str(tmp_path / "p")]
    got, want, out = _port_then_jax(monkeypatch, "run_gmm_pipeline",
                               argv + (["--tsne"] if tsne else []), jax_diagnose.cmd_gmm,
                               mat=viz_mat, init=None, data_parallel=False, tsne=tsne,
                               plot_dir=str(tmp_path / "j"))
    assert _files(tmp_path / "p") == sorted(want)
    assert ("gmm_tsne.png" in want) == tsne and len(want) == 5 + tsne
    if tsne:
        # the view's points are each package's tsne_embed of the test rows at
        # perplexity 20, exactly (tsne_embed itself is held to JAX's above:
        # at 45 rows t-SNE's optimum moves with float rounding)
        x_te = arr[out.test_full_indices][:, [INDEX[k] for k in ("pV", "pT", "pH", "pO")]]
        order = _class_order(out.y_pred)
        for views, embed in ((got, lambda x: plots.tsne_embed(x, perplexity=20.0, device="cpu")),
                             (want, lambda x: jax_plots.tsne_embed(x, perplexity=20.0))):
            (view,) = views["gmm_tsne.png"]
            np.testing.assert_array_equal(np.concatenate(view["offsets"]), embed(x_te)[order])
        strip = ("offsets", "lim", "ticks")
        for views in (got, want):
            views["gmm_tsne.png"] = [{k: v for k, v in views["gmm_tsne.png"][0].items()
                                      if k not in strip}]
    same(got, want, 1e-6)
    # --tsne draws only with --plot-dir, as in JAX
    assert cli.main(["gmm", "--mat", viz_mat, "--device", "cpu", "--tsne"]) == 0


def test_cli_gmm_keeps_its_fit(viz_mat):
    args = cli.build_parser().parse_args(["gmm", "--mat", viz_mat, "--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()):
        assert args.fn(args) == 0
    assert args.gmm_result.y_prob.shape == (45, 4) and args.gmm_result.model.converged


def test_cli_risk_plot_dir_and_the_jax_backend_name(viz_mat, tmp_path, monkeypatch, capsys):
    """``risk --backend jax --device cpu`` runs the torch backend and prints
    JAX's table, line for line; ``--plot-dir`` (on the float64 backend of
    both packages) writes JAX's figures."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_diagnose.cmd_risk(argparse.Namespace(mat=viz_mat, backend="jax",
                                                        plot_dir=None)) == 0
    capsys.readouterr()
    assert cli.main(["risk", "--mat", viz_mat, "--backend", "jax", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == buf.getvalue()
    assert len(buf.getvalue().splitlines()) == 13
    with captured(monkeypatch, jax_plots, save=False) as want:
        _run_jax(jax_diagnose.cmd_risk, mat=viz_mat, backend="numpy",
                 plot_dir=str(tmp_path / "j"))
    with captured(monkeypatch, plots) as got, contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["risk", "--mat", viz_mat, "--backend", "numpy", "--plot-dir",
                         str(tmp_path / "p")]) == 0
    assert _files(tmp_path / "p") == sorted(want) and len(want) == 24
    same(got, want, 1e-6)


def test_cli_compare_plot_dir(viz_mat, tmp_path, monkeypatch):
    methods = "gmm,logreg,kmeans"
    got, want, _ = _port_then_jax(
        monkeypatch, "run_compare_pipeline",
        ["compare", "--mat", viz_mat, "--methods", methods, "--device", "cpu", "--plot-dir",
         str(tmp_path / "p")],
        jax_diagnose.cmd_compare, mat=viz_mat, methods=methods, plot_dir=str(tmp_path / "j"))
    assert _files(tmp_path / "p") == sorted(want) == [
        "confusion_GMM.png", "confusion_KMeans.png", "confusion_Supervised_LR.png",
        "method_metrics.png"]
    same(got, want, 1e-6)
