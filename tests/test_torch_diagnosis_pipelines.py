"""Port parity: the AUC pipeline of script 02 and the GMM pipeline of script
03 (pinnfc_tpu_torch.diagnosis), and the ``auc`` and ``gmm`` command lines,
against the JAX package's, on the CPU at a miniature artifact.

Every test runs under one pinned torch thread.  Tolerances:
- ``run_auc_pipeline``: each group's AUC within 1e-4 of JAX's and its
  accuracy within 2/n_te (float32 Newton in both, the same split); the
  Isolation Forest's AUC within 0.03 (other random draws);
- ``run_gmm_pipeline(init='sklearn', dtype='float64')`` against JAX under x64:
  the same accuracy, confusion matrix, ``y_pred`` and test rows, ``y_prob``
  within 1e-8; with the default k-means init (other draws): accuracy within
  0.05 of JAX's;
- ``cli auc`` and ``cli gmm --device cpu`` in a process where ``jax`` and
  ``sklearn`` cannot be imported: exit 0, the JAX commands' lines with the
  numbers at the tolerances above (printed to 4 decimals, so 1e-4 more);
  ``cli gmm --init sklearn`` there exits 1 and names scikit-learn.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import pinnfc_tpu.config as jax_config
from pinnfc_tpu.cli.diagnose import cmd_auc as jax_cmd_auc
from pinnfc_tpu.cli.diagnose import cmd_gmm as jax_cmd_gmm
from pinnfc_tpu.diagnosis import run_auc_pipeline as jax_run_auc
from pinnfc_tpu.diagnosis import run_gmm_pipeline as jax_run_gmm
from pinnfc_tpu_torch import cli, config
from pinnfc_tpu_torch.data.contract import INDEX, ComprehensiveResults, save_comprehensive_results
from pinnfc_tpu_torch.diagnosis import run_auc_pipeline, run_gmm_pipeline
from pinnfc_tpu_torch.utils.threads import one_thread

from _torch_artifact import miniature_artifact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _pinned():
    with one_thread():
        yield


@contextlib.contextmanager
def jax_x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def artifact():
    """The shared miniature artifact (tests/_torch_artifact.py)."""
    return miniature_artifact()


def test_auc_pipeline_matches_jax(artifact):
    got = run_auc_pipeline(artifact, config.AucConfig(), device="cpu")
    want = jax_run_auc(artifact, jax_config.AucConfig())
    assert got.class_names == want.class_names == ["正常", "故障"]
    assert len(got.groups) == len(want.groups) == 4
    for g, w in zip(got.groups, want.groups):
        n_te = int(w.confusion.sum())
        assert (g.group_id, g.features, int(g.confusion.sum())) == (w.group_id, w.features, n_te)
        assert g.auc == pytest.approx(w.auc, abs=1e-4)
        assert g.accuracy == pytest.approx(w.accuracy, abs=2.0 / n_te)
        assert g.report.keys() == w.report.keys()
    assert 0.5 < got.iso_auc <= 1.0
    assert got.iso_auc == pytest.approx(want.iso_auc, abs=0.03)
    assert got.iso_fpr[0] == got.iso_tpr[0] == 0.0 and got.iso_fpr[-1] == got.iso_tpr[-1] == 1.0


def test_auc_normal_class_resolved_by_name():
    """tests/test_diagnosis.py's case: a group spec listing 正常 second still
    scores the ROC against the normal column (02:546-552)."""
    rng = np.random.RandomState(0)
    n = 400
    arr = np.zeros((n, 22))
    arr[:, INDEX["res"]] = 0.02 * rng.randn(n)
    arr[n // 2:, INDEX["res"]] += np.linspace(0.5, 2.0, n - n // 2)
    arr[:, INDEX["epi"]] = np.abs(arr[:, INDEX["res"]]) * 0.1
    arr[n // 2:, INDEX["label"]] = 1
    aucs = [run_auc_pipeline(arr, config.AucConfig(group_spec=spec, feature_groups=("epi,res",),
                                                   test_size=0.5, iso_n_estimators=8),
                             device="cpu").groups[0].auc
            for spec in ("正常:0 | 故障:1", "故障:1 | 正常:0")]
    assert aucs[0] > 0.95
    assert aucs[1] == pytest.approx(aucs[0], abs=0.05)


def test_auc_forest_falls_back_to_all_training_rows(artifact):
    """With ≤ 10 normal training rows the forest fits on all of them, as the
    JAX pipeline does (02:577-583): its AUC is JAX's within the band."""
    keep = np.r_[np.arange(0, 400, 40), np.arange(400, len(artifact))]
    arr = artifact[keep]
    cfg = config.AucConfig(feature_groups=("epi,res",), test_size=0.5, iso_n_estimators=32)
    got = run_auc_pipeline(arr, cfg, device="cpu")
    want = jax_run_auc(arr, dataclasses.replace(jax_config.AucConfig(), feature_groups=(
        "epi,res",), test_size=0.5, iso_n_estimators=32))
    assert got.groups[0].auc == pytest.approx(want.groups[0].auc, abs=1e-4)
    assert got.iso_auc == pytest.approx(want.iso_auc, abs=0.03)


def test_auc_rejects_unknown_forest_backend(artifact):
    with pytest.raises(ValueError, match="iso_backend"):
        run_auc_pipeline(artifact, config.AucConfig(iso_backend="gpu"), device="cpu")


def test_gmm_pipeline_float64_sklearn_init_is_jax_x64(artifact):
    cfg = config.GmmConfig(init="sklearn", dtype="float64")
    got = run_gmm_pipeline(artifact, cfg, device="cpu")
    with jax_x64():
        want = jax_run_gmm(artifact, jax_config.GmmConfig(init="sklearn", dtype="float64"))
        want_model = jax.tree_util.tree_map(np.asarray, want.model)
    assert got.model.means.dtype == torch.float64
    assert (got.model.n_iter, got.model.converged) == (int(want_model.n_iter),
                                                       bool(want_model.converged))
    assert got.accuracy == want.accuracy
    np.testing.assert_array_equal(got.confusion, want.confusion)
    np.testing.assert_array_equal(got.y_pred, want.y_pred)
    np.testing.assert_array_equal(got.y_true, want.y_true)
    np.testing.assert_array_equal(got.test_full_indices, want.test_full_indices)
    np.testing.assert_allclose(got.y_prob, want.y_prob, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.comp_fault_prob, want.comp_fault_prob, rtol=0, atol=1e-8)
    assert got.report == want.report
    assert (got.class_names, got.features) == (want.class_names, want.features)


def test_gmm_pipeline_kmeans_init_close_to_jax(artifact):
    got = run_gmm_pipeline(ComprehensiveResults(artifact), device="cpu")
    want = jax_run_gmm(artifact)
    assert got.model.means.dtype == torch.float32 and got.model.means.shape == (20, 4)
    assert got.model.converged and got.model.n_iter <= 100
    assert got.y_prob.shape == want.y_prob.shape
    np.testing.assert_allclose(got.y_prob.sum(axis=1), 1.0, atol=1e-12)
    np.testing.assert_array_equal(got.y_true, want.y_true)
    assert got.accuracy == pytest.approx(want.accuracy, abs=0.05)
    again = run_gmm_pipeline(artifact, device="cpu")
    np.testing.assert_array_equal(again.y_prob, got.y_prob)  # the same CPU draws
    with pytest.raises(ValueError, match="GmmConfig.init"):
        run_gmm_pipeline(artifact, config.GmmConfig(init="random"), device="cpu")


def test_pipelines_need_the_card_unless_asked_for_the_cpu(artifact):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_gmm_pipeline(artifact)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_auc_pipeline(artifact)


# ---- the command lines ----

def _jax_out(fn, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argparse.Namespace(plot_dir=None, **kw)) == 0
    return buf.getvalue()


_BLOCKED = (
    "import json, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['sklearn'] = None\n"
    "import torch\n"
    "torch.set_num_threads(1)\n"
    "from pinnfc_tpu_torch.cli import main\n"
    "for argv in json.loads(sys.argv[1]):\n"
    "    rc = main(argv)\n"
    "    sys.stdout.flush()\n"
    "    print(f'RC {rc}', flush=True)\n"
    "assert not [m for m in sys.modules if m == 'pinnfc_tpu' or m.startswith('pinnfc_tpu.')]\n"
)


def _run_blocked(*argvs):
    """Each argv through the port's ``main`` in one process in which jax
    and sklearn cannot be imported: (outputs split at each exit code, the
    exit codes, stderr)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, json.dumps(list(argvs))], cwd=REPO,
                          env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    parts = re.split(r"^RC (-?\d+)\n", proc.stdout, flags=re.M)
    return parts[0:-1:2], [int(rc) for rc in parts[1::2]], proc.stderr


def _numbers(line):
    return [float(v) for v in re.findall(r"-?\d+\.\d+", line)]


def test_cli_auc_prints_the_jax_lines_without_jax(artifact, tmp_path, capsys):
    mat = str(tmp_path / "F01_output.mat")
    save_comprehensive_results(artifact, mat)
    (out,), rcs, _ = _run_blocked(["auc", "--mat", mat, "--device", "cpu"])
    assert rcs == [0]
    want = _jax_out(jax_cmd_auc, mat=mat, group_spec=None, test_size=None, balanced=None,
                    show_coef=0, list_features=False).splitlines()
    got = out.splitlines()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert re.sub(r"-?\d+\.\d+", "#", g) == re.sub(r"-?\d+\.\d+", "#", w)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(_numbers(g), _numbers(w), atol=1e-4 + 2.0 / 900 + 1e-12)
    assert _numbers(got[4])[0] == pytest.approx(_numbers(want[4])[0], abs=0.03 + 1e-4)

    # in-process: the flags, --show-coef and --list-features
    argv = ["auc", "--mat", mat, "--device", "cpu", "--no-balanced", "--test-size", "0.9",
            "--show-coef", "2"]
    capsys.readouterr()
    assert cli.main(argv) == 0
    got = capsys.readouterr().out.splitlines()
    want = _jax_out(jax_cmd_auc, mat=mat, group_spec=None, test_size=0.9, balanced=False,
                    show_coef=2, list_features=False).splitlines()
    assert [re.sub(r"-?\d+\.\d+", "#", ln) for ln in got] == \
        [re.sub(r"-?\d+\.\d+", "#", ln) for ln in want]
    for g, w in zip(got, want):
        if not g.startswith("unsupervised"):
            np.testing.assert_allclose(_numbers(g), _numbers(w), atol=2e-3)
    assert cli.main(["auc", "--list-features"]) == 0
    assert capsys.readouterr().out == _jax_out(jax_cmd_auc, list_features=True)


def test_cli_gmm_prints_the_jax_lines_without_jax(artifact, tmp_path):
    mat = str(tmp_path / "F01_output.mat")
    save_comprehensive_results(artifact, mat)
    outs, rcs, err = _run_blocked(["gmm", "--mat", mat, "--device", "cpu"],
                                  ["gmm", "--mat", mat, "--device", "cpu", "--init", "sklearn"])
    assert rcs == [0, 1]
    assert "scikit-learn" in err and outs[1] == ""
    want = _jax_out(jax_cmd_gmm, mat=mat, init=None, data_parallel=False, tsne=False)
    got, want = outs[0].splitlines(), want.splitlines()
    assert len(got) == len(want) == 6
    assert got[0].startswith("GMM 4-class accuracy: ") and got[1] == want[1] == "confusion:"
    assert _numbers(got[0])[0] == pytest.approx(_numbers(want[0])[0], abs=0.05 + 1e-4)
    confusion = np.array([[int(v) for v in re.findall(r"\d+", ln)] for ln in got[2:]])
    assert confusion.shape == (4, 4) and confusion.sum() == 150


def test_cli_needs_the_card_unless_asked_for_the_cpu(artifact, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    mat = str(tmp_path / "F01_output.mat")
    save_comprehensive_results(artifact, mat)
    for cmd in ("auc", "gmm"):
        assert cli.main([cmd, "--mat", mat]) == 1
        assert "CUDA" in capsys.readouterr().err
        assert cli.main([cmd, "--mat", str(tmp_path / "missing.mat"), "--device", "cpu"]) == 1
        assert "missing.mat" in capsys.readouterr().err
