"""Port parity: the run report (pinnfc_tpu_torch.utils.report), ``cli
report`` and ``cli run-all``, against the JAX package's, on the CPU with the
miniature model and artifact of tests/_torch_explain_model.py (8→32→32→1 on
a 660-row synthetic campaign; a port checkpoint with scalers both packages
read).

Tolerances, those the pipelines are held to elsewhere:
- ``artifact_metrics``: the same keys; rows, the voltage and σ means and the
  conformal numbers to float64 rounding (rtol 1e-12, the same host
  arithmetic); the LR groups' AUC within 1e-4 and accuracy within 2/n_te
  (tests/test_torch_diagnosis_pipelines.py), the Isolation Forest's AUC
  within 0.03 and the k-means-initialised GMM's accuracy within 0.05 (other
  random draws); the risk counts equal and the mean advance within one
  sample (tests/test_torch_risk.py);
- ``build_report`` on the port's pipeline results: JAX's document line for
  line (JAX's section functions fed the port's results), the timestamp
  excepted; on each package's own pipelines: the same lines with the
  numbers replaced, and the numbers per section at the tolerances above
  (identifiability at rtol 2e-3 of its 4-6 printed digits, saliency at
  rtol 1e-2 of its 3; the GMM's confusion matrix by its row sums, the test
  rows per class);
- ``cli run-all --from-ckpt --device cpu``: the JAX command's files and
  figure names (tests/test_cli.py:190-228), no degraded section, and
  ``metrics.json`` equal to ``artifact_metrics`` of its ``F01_output.mat``.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import pinnfc_tpu.diagnosis.auc as jax_auc_mod
import pinnfc_tpu.diagnosis.compare as jax_compare_mod
import pinnfc_tpu.diagnosis.gmm_pipeline as jax_gmm_mod
import pinnfc_tpu.risk as jax_risk_pkg
import pinnfc_tpu.uq.identifiability as jax_ident_mod
import pinnfc_tpu.uq.saliency as jax_saliency_mod
from pinnfc_tpu.utils import report as jax_report
from pinnfc_tpu_torch import cli
from pinnfc_tpu_torch.config import TrainConfig, train_config_to_dict
from pinnfc_tpu_torch.data.contract import (
    INDEX, load_comprehensive_results, save_comprehensive_results)
from pinnfc_tpu_torch.diagnosis import run_auc_pipeline, run_compare_pipeline, run_gmm_pipeline
from pinnfc_tpu_torch.risk import run_risk_pipeline
from pinnfc_tpu_torch.uq import coarse_class_saliency, input_saliency, lambda_identifiability
from pinnfc_tpu_torch.utils import report
from pinnfc_tpu_torch.utils.checkpoint import save_checkpoint
from pinnfc_tpu_torch.utils.threads import one_thread

from _torch_explain_model import explain_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


@pytest.fixture(autouse=True)
def _pinned():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The miniature model and artifact, a baseline artifact (its voltage
    residuals halved: this run's MAE regressed against it), and a figures
    directory with two files."""
    root = tmp_path_factory.mktemp("report")
    m = explain_model(root)
    base = m.arr.copy()
    base[:, INDEX["res"]] *= 0.5
    m.baseline = str(root / "baseline.mat")
    save_comprehensive_results(base, m.baseline)
    m.figures = root / "figures"
    m.figures.mkdir()
    for name in ("roc.png", "gmm_tsne.png"):
        (m.figures / name).write_bytes(b"")
    # the model with a training config in its sidecar, as `cli train` writes
    # it: `score` (and run-all --from-ckpt) rebuild its 660-row campaign and
    # draw 16 MC passes
    m.run_ckpt = str(root / "run_ck")
    save_checkpoint(m.run_ckpt, m.tp, m.sx, m.sy, meta={
        "config": train_config_to_dict(TrainConfig(mc_times=16)), "n_normal": 300,
        "n_fault": 30})
    return m


@pytest.fixture(scope="module")
def metrics(model):
    with one_thread():
        return (report.artifact_metrics(model.arr, device="cpu"),
                jax_report.artifact_metrics(model.arr))


def test_artifact_metrics_match_jax(model, metrics):
    got, want = metrics
    assert list(got) == list(want)
    n_te = int(run_auc_pipeline(model.arr, device="cpu").groups[0].confusion.sum())
    for k, w in want.items():
        g = got[k]
        if k.startswith("auc_group"):
            tol = 1e-4
        elif k.startswith("accuracy_group"):
            tol = 2.0 / n_te + 1e-12
        else:
            tol = {"isoforest_auc": 0.03, "gmm_accuracy": 0.05, "mean_rf_advance": 1.0}.get(
                k, 1e-12 * max(1.0, abs(w)))
        assert np.isfinite(g) == np.isfinite(w) and (not np.isfinite(w) or abs(g - w) <= tol), \
            (k, g, w)
    assert got["risk_conditions"] == want["risk_conditions"] == 12


def _port_results(monkeypatch, ckpt_path):
    """Feed JAX's report sections the port's pipeline results (computed on
    the CPU for whatever artifact the section passes; the model-level ones
    from the port's load of ``ckpt_path``)."""
    from pinnfc_tpu_torch.utils.checkpoint import load_checkpoint

    ck = load_checkpoint(ckpt_path, device="cpu")
    monkeypatch.setattr(jax_auc_mod, "run_auc_pipeline",
                        lambda arr, *a, **k: run_auc_pipeline(arr, device="cpu"))
    monkeypatch.setattr(jax_gmm_mod, "run_gmm_pipeline",
                        lambda arr, *a, **k: run_gmm_pipeline(arr, device="cpu"))
    monkeypatch.setattr(jax_risk_pkg, "run_risk_pipeline",
                        lambda arr, *a, **k: run_risk_pipeline(arr, device="cpu"))
    monkeypatch.setattr(jax_compare_mod, "run_compare_pipeline",
                        lambda arr, *a, **k: run_compare_pipeline(arr, device="cpu"))

    def ident(params, x_norm, sx, sy):
        return lambda_identifiability(ck["params"], x_norm, ck["scaler_x"], ck["scaler_y"])

    def saliency(params, x_raw, sx, sy, labels=None):
        return input_saliency(ck["params"], x_raw, ck["scaler_x"], ck["scaler_y"],
                              labels=labels, device="cpu")

    monkeypatch.setattr(jax_ident_mod, "lambda_identifiability", ident)
    monkeypatch.setattr(jax_saliency_mod, "input_saliency", saliency)
    monkeypatch.setattr(jax_saliency_mod, "coarse_class_saliency", coarse_class_saliency)


def _not_degraded(text: str) -> str:
    """``text`` after checking that no report section degraded to a note."""
    assert "section unavailable" not in text, text
    return text


def _docs(model, **kw):
    common = dict(ckpt_path=model.ckpt, figures_dir=str(model.figures),
                  report_dir=str(model.root), mat_path=model.mat, **kw)
    got = _not_degraded(report.build_report(model.arr, device="cpu", **common))
    want = _not_degraded(jax_report.build_report(model.arr, **common))
    return got.splitlines(), want.splitlines()


def test_build_report_is_jax_line_for_line_on_the_same_results(model, monkeypatch):
    """Every section, the baseline and the gallery included: JAX's section
    functions fed the port's results write the port's document."""
    _port_results(monkeypatch, model.ckpt)
    base = load_comprehensive_results(model.baseline)
    got, want = _docs(model, baseline=base, baseline_path=model.baseline)
    assert got[2].startswith("- generated: ") and want[2].startswith("- generated: ")
    assert got[:2] + got[3:] == want[:2] + want[3:]
    titles = [ln[3:] for ln in got if ln.startswith("## ")]
    assert titles == [report._SECTION_TITLES[s] for s in report.ALL_SECTIONS]


# section → (rtol, atol) of its numbers against JAX's own pipelines
SECTION_TOL = {"Artifact overview": (1e-9, 0.0), "Supervised detection (script 02)": (0, 0.03),
               "RF(t) early warning (script 04)": (0, 1.0),
               "Conformal calibration audit": (1e-9, 0.0),
               "Physics-parameter identifiability": (2e-3, 1e-12),
               "Input-channel saliency": (1e-2, 1e-3)}


def _sections(lines):
    out, name = {}, None
    for ln in lines:
        if ln.startswith("## "):
            name = ln[3:]
            out[name] = []
        elif name:
            out[name].append(ln)
    return out


def test_build_report_matches_jax_on_its_own_pipelines(model, metrics):
    sections = ["overview", "auc", "gmm", "risk", "conformal", "identifiability", "saliency"]
    got, want = _docs(model, sections=sections)
    assert len(got) == len(want)
    g_sec, w_sec = _sections(got), _sections(want)
    assert list(g_sec) == list(w_sec) and len(g_sec) == len(sections)
    for name, w_lines in w_sec.items():
        g_lines = g_sec[name]
        assert [NUM.sub("#", ln) for ln in g_lines] == [NUM.sub("#", ln) for ln in w_lines], name
        if name.startswith("Unsupervised GMM"):
            acc = [float(NUM.findall(ln)[-1]) for lines in (g_lines, w_lines)
                   for ln in lines if "test accuracy" in ln]
            assert abs(acc[0] - acc[1]) <= 0.05
            rows = [[sum(int(v) for v in NUM.findall(ln.split("|", 2)[2])) for ln in lines
                     if ln.startswith("| ") and not ln.startswith("| true")]
                    for lines in (g_lines, w_lines)]
            assert rows[0] == rows[1]
            continue
        rtol, atol = SECTION_TOL[name]
        for g, w in zip(g_lines, w_lines):
            np.testing.assert_allclose([float(v) for v in NUM.findall(g)],
                                       [float(v) for v in NUM.findall(w)], rtol=rtol, atol=atol,
                                       err_msg=f"{name}: {g!r} against {w!r}")


def test_report_sections_baseline_and_unknown_names(model, metrics, tmp_path, capsys):
    doc = _not_degraded(report.build_report(
        model.arr, sections=["overview", "baseline"], device="cpu",
        baseline=load_comprehensive_results(model.baseline), baseline_path=model.baseline))
    assert [ln for ln in doc.splitlines() if ln.startswith("## ")] == [
        "## Artifact overview", "## Regression vs baseline"]
    assert f"Baseline: `{model.baseline}`" in doc and "⚠ regressed" in doc
    assert "## Regression vs baseline" not in report.build_report(model.arr, sections=[
        "overview"], device="cpu")
    default = _not_degraded(report.build_report(model.arr, device="cpu", sections=None))
    assert "## Regression vs baseline" not in default and "_no checkpoint given" in default
    with pytest.raises(ValueError, match="unknown report sections"):
        report.build_report(model.arr, sections=["overview", "nope"], device="cpu")
    out = str(tmp_path / "r.md")
    assert cli.main(["report", "--mat", model.mat, "--sections", "overview,nope", "--out", out,
                     "--device", "cpu"]) == 1
    assert "unknown report sections ['nope']" in capsys.readouterr().err


def test_cli_report_json_and_json_out(model, metrics, tmp_path, capsys):
    """``--json`` prints the metric vector (strict JSON); ``--json-out``
    writes it and goes on to write the report."""
    got, _ = metrics
    assert cli.main(["report", "--mat", model.mat, "--json", "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc == {k: (v if np.isfinite(v) else None) for k, v in got.items()}
    out, js = str(tmp_path / "r.md"), str(tmp_path / "m.json")
    assert cli.main(["report", "--mat", model.mat, "--ckpt", model.ckpt, "--out", out,
                     "--json-out", js, "--sections", "provenance,overview,figures",
                     "--plot-dir", str(model.figures), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed == [f"metrics → {js}", f"report → {out}"]
    assert json.load(open(js)) == doc
    text = _not_degraded(open(out).read())
    assert "- [gmm_tsne](" in text and "| n_normal | 300 |" in text


FIGURES = ("roc.png", "gmm_confusion.png", "gmm_tsne.png", "method_metrics.png",
           "conformal_coverage.png", "identifiability.png")


def test_cli_run_all_from_a_checkpoint(model, tmp_path, capsys):
    """``run-all --from-ckpt --device cpu`` scores the checkpoint's campaign
    and runs every stage: the JAX command's lines, files and figures."""
    out = str(tmp_path / "runall")
    assert cli.main(["run-all", "--from-ckpt", model.run_ckpt, "--out-dir", out,
                     "--device", "cpu"]) == 0
    stdout = capsys.readouterr().out
    for token in ("voltage_mae", "AUC=", "accuracy", "advance", "Supervised_LR", "streamed",
                  "identifiability over", "conformal anomaly rate", "held-out normal coverage",
                  f"run-all complete → {out}"):
        assert token in stdout, token
    with open(os.path.join(out, "report.md")) as f:
        text = f.read()
    assert "# pinnfc_tpu run report" in _not_degraded(text) and "Checkpoint provenance" in text
    figs = set(os.listdir(os.path.join(out, "figures")))
    assert set(FIGURES) <= figs, figs
    mat = os.path.join(out, "F01_output.mat")
    want = report.artifact_metrics(load_comprehensive_results(mat), device="cpu")
    assert json.load(open(os.path.join(out, "metrics.json"))) == {
        k: (v if np.isfinite(v) else None) for k, v in want.items()}


_BLOCKED = (
    "import json, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['matplotlib'] = None\n"
    "import torch\n"
    "torch.set_num_threads(1)\n"
    "from pinnfc_tpu_torch.cli import main\n"
    "from pinnfc_tpu_torch.cli.run_all import run_all\n"
    "argvs = json.loads(sys.argv[1])\n"
    "for argv in argvs[:-1]:\n"
    "    print(f'RC {main(argv)}', flush=True)\n"
    "from pinnfc_tpu_torch.cli import build_parser\n"
    "print(f'RC {run_all(build_parser().parse_args(argvs[-1]), None)}', flush=True)\n"
    "assert not [m for m in sys.modules if m == 'pinnfc_tpu' or m.startswith('pinnfc_tpu.')]\n"
)


def test_report_and_run_all_without_jax_and_matplotlib(model, tmp_path):
    """In a process where jax and matplotlib cannot be imported: ``cli
    report`` writes every section; ``cli run-all`` exits 1 naming matplotlib
    after writing F01_output.mat (its figures), and ``run_all(args, None)``,
    the chain without figures, runs to the end."""
    out, bare = str(tmp_path / "r.md"), str(tmp_path / "bare")
    argvs = [["report", "--mat", model.mat, "--ckpt", model.ckpt, "--out", out,
              "--device", "cpu"],
             ["run-all", "--from-ckpt", model.run_ckpt, "--out-dir", str(tmp_path / "figs"),
              "--device", "cpu"],
             ["run-all", "--from-ckpt", model.run_ckpt, "--out-dir", bare, "--device", "cpu"]]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, json.dumps(argvs)], cwd=REPO,
                          env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert re.findall(r"^RC (-?\d+)$", proc.stdout, flags=re.M) == ["0", "1", "0"]
    assert "matplotlib" in proc.stderr
    assert os.path.exists(tmp_path / "figs" / "F01_output.mat")
    assert not os.path.exists(tmp_path / "figs" / "report.md")
    for path in (out, os.path.join(bare, "report.md")):
        assert "## Input-channel saliency" in _not_degraded(open(path).read())
    assert "run-all complete" in proc.stdout and os.path.exists(os.path.join(bare,
                                                                             "metrics.json"))
