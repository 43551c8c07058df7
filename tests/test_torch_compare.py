"""Port parity: the six-method comparison of script 05
(pinnfc_tpu_torch.diagnosis: lbfgs, svm, logreg's L-BFGS branch, ward,
spectral, compare) and ``cli compare``, against the JAX package's, on the CPU.

Every test runs under one pinned torch thread.  Tolerances:
- L-BFGS (the port's own, float32): the minimizer within 1e-4 of a float64
  scipy optimum, relative to its largest entry (float32 gradients floor the
  gradient norm near 1e-6 of its scale);
- SVM: coef and intercept within 1e-3 of JAX's (relative to max |coef|), and
  both within that of a float64 scipy optimum of the same objective;
  ``svm_predict`` on a JAX model carried by ``svm_params_from_numpy``: JAX's
  predictions exactly;
- logistic regression by L-BFGS: ``predict_proba`` within atol 1e-5 of JAX's
  ``solver="lbfgs"`` and of the port's Newton (float32 optima of one convex
  problem);
- Ward: labels identical to JAX's for each algorithm on continuous data,
  NN-chain equal to global in the port, centres the cluster means within
  1e-6;
- spectral: the kNN index sets identical to JAX's and the Laplacian within
  1e-6; the bottom-16 projector of ``eigh`` within 1e-3 of JAX's, the
  subspace path's within 1e-3 of eigh's; labels with ARI ≥ 0.9 against JAX's
  on separated blobs (other k-means draws);
- the pipeline on the miniature artifact: the same split, LR, SVM and
  Agglomerative predictions agreeing with JAX's on ≥ 99 % of rows, GMM,
  KMeans and Spectral macro F1 within 0.1 of JAX's (other draws: the port's
  CPU generators, JAX's key);
- ``cli compare --device cpu`` in a process where ``jax`` and ``sklearn``
  cannot be imported: the JAX command's six lines, LR/SVM/Agglomerative
  numbers within 0.02 and the others within 0.1 (printed to 4 decimals).
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
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch
from sklearn.metrics import adjusted_rand_score

import pinnfc_tpu.config as jax_config
from pinnfc_tpu.cli.diagnose import cmd_compare as jax_cmd_compare
from pinnfc_tpu.diagnosis import logreg as jax_logreg
from pinnfc_tpu.diagnosis import run_compare_pipeline as jax_run_compare
from pinnfc_tpu.diagnosis import spectral as jax_spectral
from pinnfc_tpu.diagnosis import svm as jax_svm
from pinnfc_tpu.diagnosis import ward as jax_ward
from pinnfc_tpu_torch import cli, config
from pinnfc_tpu_torch.data.contract import save_comprehensive_results
from pinnfc_tpu_torch.diagnosis import compare, lbfgs, logreg, spectral, svm, ward
from pinnfc_tpu_torch.utils.jax_params import svm_params_from_numpy
from pinnfc_tpu_torch.utils.threads import one_thread

from _torch_artifact import miniature_artifact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _pinned():
    with one_thread():
        yield


def _blobs(spread, per=75, seed=0):
    rng = np.random.RandomState(seed)
    centers = np.array([[0, 0, 0, 0], [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 1]]) * spread
    x = np.vstack([c + rng.randn(per, 4) for c in centers])
    y = np.repeat(np.arange(4), per)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


@pytest.fixture(scope="module")
def artifact():
    return miniature_artifact()


# ---- L-BFGS ----

def _quadratics(b, p, seed=0):
    rng = np.random.RandomState(seed)
    a = np.stack([m @ m.T + 0.5 * np.eye(p) for m in rng.randn(b, p, p)])
    return a, rng.randn(b, p)


@pytest.mark.parametrize("batch", [1, 3])
def test_lbfgs_quadratic_against_scipy(batch):
    a, c = _quadratics(batch, 8)
    at, ct = (torch.as_tensor(v, dtype=torch.float32) for v in (a, c))

    def fun(x):
        ax = torch.einsum("bij,bj->bi", at, x)
        return 0.5 * (x * ax).sum(-1) - (ct * x).sum(-1), ax - ct

    got = lbfgs.lbfgs_minimize(fun, torch.zeros(batch, 8), max_iter=200, tol=1e-5)
    for i in range(batch):
        want = scipy.optimize.minimize(
            lambda v: (0.5 * v @ a[i] @ v - c[i] @ v, a[i] @ v - c[i]), np.zeros(8),
            jac=True, method="L-BFGS-B", options={"gtol": 1e-12, "ftol": 1e-15}).x
        np.testing.assert_allclose(got.x[i].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
        assert float(got.grad_norm[i]) <= 1e-5
        assert 0 < int(got.n_iter[i]) < 200


@pytest.mark.parametrize("batch", [1, 2])
def test_lbfgs_logistic_against_scipy(batch):
    rng = np.random.RandomState(1)
    xs = rng.randn(batch, 300, 5)
    ys = np.stack([(x @ rng.randn(5) + 0.3 * rng.randn(300) > 0).astype(float) for x in xs])
    xt, yt = (torch.as_tensor(v, dtype=torch.float32) for v in (xs, ys))

    def fun(w):  # w (B, 6): weights, then bias; L2 on the weights
        z = torch.einsum("bnd,bd->bn", xt, w[:, :5]) + w[:, 5:]
        loss = (torch.nn.functional.softplus(z) - yt * z).sum(-1) + 0.5 * (w[:, :5] ** 2).sum(-1)
        r = torch.sigmoid(z) - yt
        return loss, torch.cat([torch.einsum("bnd,bn->bd", xt, r) + w[:, :5],
                                r.sum(-1, keepdim=True)], dim=1)

    got = lbfgs.lbfgs_minimize(fun, torch.zeros(batch, 6), max_iter=300, tol=1e-6)
    for i in range(batch):
        def f64(w, x=xs[i], y=ys[i]):
            z = x @ w[:5] + w[5]
            r = 1.0 / (1.0 + np.exp(-z)) - y
            return ((np.logaddexp(0.0, z) - y * z).sum() + 0.5 * w[:5] @ w[:5],
                    np.r_[x.T @ r + w[:5], r.sum()])
        want = scipy.optimize.minimize(f64, np.zeros(6), jac=True, method="L-BFGS-B",
                                       options={"gtol": 1e-12, "ftol": 1e-15}).x
        np.testing.assert_allclose(got.x[i].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_lbfgs_stops_each_problem_on_its_own():
    """A problem that starts at its optimum takes no step and stays put while
    the other iterates; ``max_iter`` caps every problem."""
    a, c = _quadratics(2, 6, seed=3)
    x_star0 = np.linalg.solve(a[0], c[0])
    c[0] = a[0] @ x_star0  # exactly representable optimum: zero gradient at x0
    at, ct = (torch.as_tensor(v, dtype=torch.float32) for v in (a, c))

    def fun(x):
        ax = torch.einsum("bij,bj->bi", at, x)
        return 0.5 * (x * ax).sum(-1) - (ct * x).sum(-1), ax - ct

    x0 = torch.stack([torch.as_tensor(x_star0, dtype=torch.float32), torch.zeros(6)])
    g0 = fun(x0)[1][0]
    got = lbfgs.lbfgs_minimize(fun, x0, max_iter=100, tol=float(g0.norm()) * 1.01 + 1e-7)
    assert int(got.n_iter[0]) == 0 and torch.equal(got.x[0], x0[0])
    assert int(got.n_iter[1]) > 0
    capped = lbfgs.lbfgs_minimize(fun, torch.zeros(2, 6), max_iter=3, tol=0.0)
    assert int(capped.n_iter.max()) <= 3


# ---- SVM ----

def _svm_objective_optimum(xs, y, pair, w_class, c_svm):
    """Float64 scipy optimum of one pair's squared-hinge problem."""
    ci, cj = pair
    rows = (y == ci) | (y == cj)
    x, s = xs[rows], np.where(y[rows] == cj, 1.0, -1.0)
    wr = w_class[y[rows]] * c_svm

    def f(theta):
        w, b = theta[:-1], theta[-1]
        h = np.maximum(0.0, 1.0 - s * (x @ w + b))
        coeff = -2.0 * wr * h * s
        return 0.5 * w @ w + (wr * h * h).sum(), np.r_[w + x.T @ coeff, coeff.sum()]

    return scipy.optimize.minimize(f, np.zeros(x.shape[1] + 1), jac=True, method="L-BFGS-B",
                                   options={"gtol": 1e-12, "ftol": 1e-15}).x


@pytest.fixture(scope="module")
def jax_svm_case():
    x, y = _blobs(2.0, per=100)
    return x, y, jax_svm.svm_fit(jnp.asarray(x, jnp.float32), jnp.asarray(y), 4)


def test_svm_matches_jax_and_the_float64_optimum(jax_svm_case):
    x, y, want = jax_svm_case
    got = svm.svm_fit(x, y, n_classes=4, device="cpu")
    coef_j, icpt_j = np.asarray(want.coef), np.asarray(want.intercept)
    scale = np.abs(coef_j).max()
    np.testing.assert_array_equal(got.pairs.numpy(), np.asarray(want.pairs))
    np.testing.assert_allclose(got.x_mean.numpy(), np.asarray(want.x_mean), rtol=1e-6)
    np.testing.assert_allclose(got.x_scale.numpy(), np.asarray(want.x_scale), rtol=1e-6)
    np.testing.assert_allclose(got.coef.numpy(), coef_j, rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(got.intercept.numpy(), icpt_j, rtol=0, atol=1e-3 * scale)
    xs = (x - x.mean(0)) / x.std(0)
    w_class = len(y) / (4 * np.bincount(y, minlength=4))
    pairs = got.pairs.numpy()
    assert len(pairs) == 6
    for p, pair in enumerate(pairs):
        ref = _svm_objective_optimum(xs, y, pair, w_class, 0.05)
        for theta in (np.r_[got.coef[p].numpy(), got.intercept[p].item()],
                      np.r_[coef_j[p], icpt_j[p]]):
            np.testing.assert_allclose(theta, ref, rtol=0, atol=1e-3 * scale)
    pred = svm.svm_predict(got, x).numpy()
    assert (pred == np.asarray(jax_svm.svm_predict(want, x))).mean() >= 0.99
    assert (pred == y).mean() > 0.6


def test_svm_predict_on_a_jax_model_is_jax(jax_svm_case):
    _, _, want = jax_svm_case
    model = svm_params_from_numpy(*(np.asarray(a) for a in want), device="cpu")
    x_new = np.random.RandomState(5).randn(500, 4) * 2.0
    np.testing.assert_array_equal(svm.svm_predict(model, x_new).numpy(),
                                  np.asarray(jax_svm.svm_predict(want, x_new)))
    with pytest.raises(ValueError, match="SVM shapes"):
        svm_params_from_numpy(np.zeros((6, 4)), np.zeros(5), np.zeros((6, 2)), np.zeros(4),
                              np.ones(4), device="cpu")


def test_svm_refuses_more_than_16_classes():
    rng = np.random.RandomState(0)
    with pytest.raises(ValueError, match="at most 16 classes"):
        svm.svm_fit(rng.randn(40, 3), np.arange(40) % 17, n_classes=17, device="cpu")


# ---- logistic regression by L-BFGS ----

@pytest.mark.parametrize("extra,solver", [(0, "lbfgs"), (60, "auto")])
def test_logreg_lbfgs_matches_jax_and_newton(extra, solver):
    """4 features by ``solver="lbfgs"``, and 64 (260 packed parameters > 256)
    by ``"auto"``, which takes L-BFGS there as JAX does."""
    x, y = _blobs(2.0, per=100)
    x = np.hstack([x, 0.3 * np.random.RandomState(1).randn(len(x), extra)])
    got = logreg.logreg_fit(x, y, n_classes=4, solver=solver, device="cpu")
    want = jax_logreg.logreg_fit(jnp.asarray(x, jnp.float32), jnp.asarray(y), 4, solver=solver)
    newton = logreg.logreg_fit(x, y, n_classes=4, solver="newton", device="cpu")
    p = logreg.logreg_predict_proba(got, x).numpy()
    np.testing.assert_allclose(p, np.asarray(jax_logreg.logreg_predict_proba(want, x)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(p, logreg.logreg_predict_proba(newton, x).numpy(),
                               rtol=0, atol=1e-5)
    assert 0 < got.n_iter <= 1000


# ---- Ward ----

def _ward_data(kind):
    if kind == "blobs":
        return _blobs(3.0)[0]
    return np.random.RandomState(0).randn(300, 4)  # unstructured


@pytest.mark.parametrize("algorithm", ["global", "nn-chain"])
@pytest.mark.parametrize("kind", ["blobs", "unstructured"])
def test_ward_labels_are_jax_labels(kind, algorithm):
    x = _ward_data(kind)
    got = ward.ward_fit(x, 16, algorithm=algorithm, device="cpu")
    want = jax_ward.ward_fit(jnp.asarray(x, jnp.float32), 16, algorithm)
    np.testing.assert_array_equal(got.assignments.numpy(), np.asarray(want.assignments))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers), rtol=0, atol=1e-6)
    labels = got.assignments.numpy()
    assert sorted(set(labels)) == list(range(16))
    means = np.stack([x[labels == c].mean(0) for c in range(16)])
    np.testing.assert_allclose(got.centers.numpy(), means, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["blobs", "unstructured"])
def test_ward_nn_chain_equals_global(kind):
    x = _ward_data(kind)
    a = ward.ward_fit(x, 12, algorithm="global", device="cpu").assignments
    b = ward.ward_fit(x, 12, algorithm="nn-chain", device="cpu").assignments
    assert torch.equal(a, b)
    # "auto" takes the global algorithm up to N = 2048
    assert torch.equal(ward.ward_fit(x, 12, device="cpu").assignments, a)


def test_ward_duplicate_rows_resolve_ties_as_jax():
    """Duplicate rows give exact cost ties (zero-cost merges of equal rows,
    then equal merges of equal pairs).  Each algorithm resolves them by its
    rule (global: the first minimum in row-major order; NN-chain: the
    previous chain element, then the stable height sort) the same way in the
    port and in JAX; the two algorithms may pick different but equally valid
    partitions, and here they give the same one up to cluster IDs."""
    base = np.random.RandomState(4).randn(60, 3)
    x = np.vstack([base, base, base[:30]])[np.random.RandomState(5).permutation(150)]
    for algorithm in ("global", "nn-chain"):
        got = ward.ward_fit(x, 8, algorithm=algorithm, device="cpu").assignments.numpy()
        want = np.asarray(jax_ward.ward_fit(jnp.asarray(x, jnp.float32), 8, algorithm)
                          .assignments)
        np.testing.assert_array_equal(got, want)
    g = ward.ward_fit(x, 8, algorithm="global", device="cpu").assignments.numpy()
    c = ward.ward_fit(x, 8, algorithm="nn-chain", device="cpu").assignments.numpy()
    assert adjusted_rand_score(g, c) == 1.0
    # equal rows always share a cluster
    _, inverse = np.unique(x, axis=0, return_inverse=True)
    for r in np.unique(inverse):
        assert len(set(g[inverse == r])) == 1


def test_ward_rejects_bad_arguments():
    x = np.random.RandomState(0).randn(10, 2)
    with pytest.raises(ValueError, match="must be < n"):
        ward.ward_fit(x, 10, device="cpu")
    with pytest.raises(ValueError, match="unknown algorithm"):
        ward.ward_fit(x, 3, algorithm="single", device="cpu")


# ---- spectral ----

def _projector(v):
    v = np.asarray(v, np.float64)
    return v @ v.T


@pytest.fixture(scope="module", params=["blobs", "unstructured"])
def spectral_case(request):
    x = (_blobs(6.0)[0] if request.param == "blobs"
         else np.random.RandomState(0).randn(300, 4)).astype(np.float32)
    xj = jnp.asarray(x)
    sq = jnp.sum(xj**2, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * jnp.matmul(xj, xj.T, precision="highest")
    _, idx = jax.lax.top_k(-d2, 10)
    n = len(x)
    a = jnp.zeros((n, n)).at[jnp.repeat(jnp.arange(n), 10), idx.reshape(-1)].set(1.0)
    a = 0.5 * (a + a.T)
    d_isqrt = 1.0 / jnp.sqrt(jnp.maximum(jnp.sum(a, axis=1), 1e-12))
    lap = jnp.eye(n) - (d_isqrt[:, None] * a) * d_isqrt[None, :]  # spectral.py:95-112
    vecs = np.asarray(jnp.linalg.eigh(lap)[1][:, :16])
    return x, np.asarray(idx), np.asarray(lap), vecs


def test_spectral_graph_and_eigenspace_match_jax(spectral_case):
    x, idx_j, lap_j, vecs_j = spectral_case
    idx, lap, _ = spectral.knn_laplacian(torch.as_tensor(x), 10)
    for row, row_j in zip(idx.numpy(), idx_j):
        assert set(row) == set(row_j)
    np.testing.assert_allclose(lap.numpy(), lap_j, rtol=0, atol=1e-6)
    vecs = torch.linalg.eigh(lap)[1][:, :16]
    p_eigh = _projector(vecs)
    assert np.abs(p_eigh - _projector(vecs_j)).max() <= 1e-3
    sub, steps = spectral._bottom_k_subspace(lap, 16, torch.Generator().manual_seed(0))
    assert 0 < steps < 3000
    assert np.abs(_projector(sub) - p_eigh).max() <= 1e-3


@pytest.mark.parametrize("solver", ["eigh", "subspace"])
def test_spectral_labels_agree_with_jax_on_blobs(solver):
    x, _ = _blobs(6.0)
    got = spectral.spectral_fit(x, torch.Generator().manual_seed(0), 4, solver=solver,
                                device="cpu")
    want = jax_spectral.spectral_fit(jnp.asarray(x, jnp.float32), jax.random.PRNGKey(0), 4,
                                     solver=solver)
    assert got.embedding.shape == (300, 4)
    assert adjusted_rand_score(got.assignments.numpy(), np.asarray(want.assignments)) >= 0.9
    again = spectral.spectral_fit(x, torch.Generator().manual_seed(0), 4, solver=solver,
                                  device="cpu")
    assert torch.equal(again.assignments, got.assignments)  # the same CPU draws
    with pytest.raises(ValueError, match="unknown solver"):
        spectral.spectral_fit(x, torch.Generator(), 4, solver="lobpcg", device="cpu")


# ---- the pipeline and the command line ----

@pytest.fixture(scope="module")
def jax_compare(artifact):
    return jax_run_compare(artifact)


_EXACT = ("Supervised_LR", "Supervised_SVM", "Agglomerative")


def test_compare_pipeline_matches_jax(artifact, jax_compare):
    got = compare.run_compare_pipeline(artifact, device="cpu")
    want = jax_compare
    assert [m.name for m in got.methods] == [m.name for m in want.methods] == [
        "GMM", "Supervised_LR", "Supervised_SVM", "KMeans", "Agglomerative", "Spectral"]
    np.testing.assert_array_equal(got.y_true, want.y_true)
    assert got.class_names == want.class_names
    for g, w in zip(got.methods, want.methods):
        assert g.metrics.keys() == w.metrics.keys() and g.report.keys() == w.report.keys()
        assert g.confusion.sum() == len(want.y_true)
        if g.name in _EXACT:
            assert (g.y_pred == w.y_pred).mean() >= 0.99, g.name
        else:
            assert abs(g.metrics["f1_macro"] - w.metrics["f1_macro"]) <= 0.1, g.name
    assert got.summary_table() == {m.name: m.metrics for m in got.methods}
    again = compare.run_compare_pipeline(artifact, methods=["gmm", "kmeans", "spectral"],
                                         device="cpu")
    for a, b in zip(again.methods, [got.methods[i] for i in (0, 3, 5)]):
        np.testing.assert_array_equal(a.y_pred, b.y_pred)  # the same CPU draws
    other = compare.run_compare_pipeline(artifact, methods=["kmeans"], device="cpu", seed=7)
    assert other.methods[0].name == "KMeans"
    with pytest.raises(ValueError, match="unknown methods"):
        compare.run_compare_pipeline(artifact, methods=["svm", "rbf"], device="cpu")


def test_compare_sklearn_options(artifact, jax_compare, monkeypatch):
    """``device_ward=False`` runs sklearn's estimator where it is installed,
    as the JAX pipeline does (Ward is deterministic: JAX's predictions), and
    raises ImportError naming scikit-learn where it is not."""
    got = compare.run_compare_pipeline(artifact, methods=["agglomerative"], device_ward=False,
                                       device="cpu")
    want = jax_run_compare(artifact, methods=["agglomerative"], device_ward=False)
    np.testing.assert_array_equal(got.methods[0].y_pred, want.methods[0].y_pred)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    for kw in ({"methods": ["agglomerative"], "device_ward": False},
               {"methods": ["spectral"], "device_spectral": False}):
        with pytest.raises(ImportError, match="scikit-learn"):
            compare.run_compare_pipeline(artifact, device="cpu", **kw)


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


def test_cli_compare_prints_the_jax_lines_without_jax(artifact, tmp_path):
    mat = str(tmp_path / "F01_output.mat")
    save_comprehensive_results(artifact, mat)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    argvs = [["compare", "--mat", mat, "--device", "cpu"],
             ["compare", "--mat", mat, "--device", "cpu", "--methods", "svm,kmenas"]]
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, json.dumps(argvs)], cwd=REPO,
                          env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    parts = re.split(r"^RC (-?\d+)\n", proc.stdout, flags=re.M)
    outs, rcs = parts[0:-1:2], [int(rc) for rc in parts[1::2]]
    assert rcs == [0, 1] and outs[1] == "" and "kmenas" in proc.stderr

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_cmd_compare(argparse.Namespace(mat=mat, methods=None, plot_dir=None)) == 0
    got, want = outs[0].splitlines(), buf.getvalue().splitlines()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert re.sub(r"-?\d+\.\d+", "#", g) == re.sub(r"-?\d+\.\d+", "#", w)
        nums_g = [float(v) for v in re.findall(r"-?\d+\.\d+", g)]
        nums_w = [float(v) for v in re.findall(r"-?\d+\.\d+", w)]
        band = 0.02 if g.split(":")[0].strip() in _EXACT else 0.1
        np.testing.assert_allclose(nums_g, nums_w, rtol=0, atol=band + 1e-4)


def test_cli_compare_user_errors(artifact, tmp_path, capsys):
    mat = str(tmp_path / "F01_output.mat")
    save_comprehensive_results(artifact, mat)
    assert cli.main(["compare", "--mat", str(tmp_path / "missing.mat"), "--device", "cpu"]) == 1
    assert "missing.mat" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert cli.main(["compare", "--mat", mat]) == 1
        assert "CUDA" in capsys.readouterr().err
    assert cli.main(["compare", "--mat", mat, "--device", "cpu", "--methods", "logreg"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("  Supervised_LR: accuracy=")
    assert dataclasses.asdict(config.CompareConfig()) == dataclasses.asdict(
        jax_config.CompareConfig())
