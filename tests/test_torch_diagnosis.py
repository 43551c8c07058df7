"""Port parity: the diagnosis modules of scripts 02 and 03
(pinnfc_tpu_torch.diagnosis) against the JAX package's, on the CPU.

Every test runs under one pinned torch thread.  Tolerances:
- the split: bitwise sklearn's ``train_test_split(stratify=y)`` and the JAX
  ``stratified_split`` (which calls it), the same rows in the same order, the
  same ValueError messages;
- features, metrics and posterior: equal to the JAX functions' (the same
  numpy operations);
- logistic regression: ``predict_proba`` within atol 1e-5 of JAX's (float32
  Newton in both; observed ≤ 3e-7) and the same ``n_iter``;
- Lloyd from the JAX ``_kmeans_plus_plus`` centres: the same assignments and
  ``n_iter``, centres within 1e-5; the port's own k-means++ (other draws):
  inertia within 5 % of JAX's;
- GMM from one ``sklearn_kmeans_init_resp``: float64 (JAX under x64)
  weights, means, covariances and ``lower_bound`` within 1e-9 with the same
  ``n_iter`` and ``converged``; float32: argmax of ``gmm_predict_proba`` equal
  on ≥ 99.9 % of rows and ``lower_bound`` within 1e-4 relative;
- the forest from the draws of the JAX key splits (isoforest.py:56-84 and
  :108): identical feature and size tables, thresholds within 1 ulp;
  ``isoforest_score`` within rtol 1e-6 of the JAX ``_score_jit`` on the same
  tables; with the port's own draws, AUC within 0.03 of JAX's;
- a JAX-fitted mixture carried over by ``gmm_params_from_numpy``:
  ``gmm_predict_proba`` within 1e-6.
"""

import contextlib
import dataclasses
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinnfc_tpu.config as jax_config
from pinnfc_tpu.diagnosis import features as jax_features
from pinnfc_tpu.diagnosis import gmm as jax_gmm
from pinnfc_tpu.diagnosis import isoforest as jax_iso
from pinnfc_tpu.diagnosis import kmeans as jax_kmeans
from pinnfc_tpu.diagnosis import logreg as jax_logreg
from pinnfc_tpu.diagnosis import metrics as jax_metrics
from pinnfc_tpu.diagnosis import posterior as jax_posterior
from pinnfc_tpu.diagnosis.splits import stratified_split as jax_stratified_split
from pinnfc_tpu_torch import config
from pinnfc_tpu_torch.diagnosis import (
    features, gmm, isoforest, kmeans, logreg, metrics, posterior, splits)
from pinnfc_tpu_torch.utils.jax_params import gmm_params_from_numpy
from pinnfc_tpu_torch.utils.threads import one_thread


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
def blobs():
    """tests/test_diagnosis.py's 4 well-separated Gaussian blobs in 4-D."""
    rng = np.random.RandomState(0)
    centers = np.array(
        [[0, 0, 0, 0], [6, 0, 0, 0], [0, 6, 0, 0], [0, 0, 6, 6]], dtype=float
    )
    x = np.vstack([c + rng.randn(150, 4) for c in centers])
    y = np.repeat(np.arange(4), 150)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


@pytest.fixture(scope="module")
def anomaly_data():
    """tests/test_diagnosis.py's anomaly_data pattern."""
    rng = np.random.RandomState(7)
    x_fit = rng.randn(1500, 2) * [0.4, 0.6]
    x_te = np.vstack(
        [rng.randn(400, 2) * [0.4, 0.6], rng.randn(200, 2) * 0.8 + [1.2, -1.0]]
    )
    y = np.r_[np.zeros(400), np.ones(200)]
    return x_fit, x_te, y


def test_configs_are_the_jax_ones():
    for name in ("AucConfig", "GmmConfig"):
        assert dataclasses.asdict(getattr(config, name)()) == \
            dataclasses.asdict(getattr(jax_config, name)())


# ---- the split ----

SPLIT_COUNTS = {
    "two": [50, 33],
    "ties": [12, 12, 12, 12, 6],  # equal remainders: _approximate_mode draws
    "thirteen": [40] + [12] * 12,
}


@pytest.mark.parametrize("seed", [42, 49])
@pytest.mark.parametrize("test_size", [0.25, 0.9])
@pytest.mark.parametrize("counts", sorted(SPLIT_COUNTS))
def test_split_is_sklearns(counts, test_size, seed):
    from sklearn.model_selection import train_test_split

    rs = np.random.RandomState(seed + 1)
    y = np.repeat(np.arange(len(SPLIT_COUNTS[counts])), SPLIT_COUNTS[counts])
    y = y[rs.permutation(len(y))].astype(np.int32)
    x = rs.randn(len(y), 3)
    idx = np.arange(len(y))
    got = splits.stratified_split(x, y, idx, y=y, test_size=test_size, random_state=seed)
    want = train_test_split(x, y, idx, test_size=test_size, random_state=seed, stratify=y)
    jax_got = jax_stratified_split(x, y, idx, y=y, test_size=test_size, random_state=seed)
    assert len(got) == len(want) == len(jax_got) == 6
    for a, b, c in zip(got, want, jax_got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("case", ["one_member", "train_below_classes", "test_below_classes"])
def test_split_errors_are_sklearns(case):
    from sklearn.model_selection import train_test_split

    y, test_size = {
        "one_member": (np.r_[np.zeros(10), [1]], 0.3),
        "train_below_classes": (np.repeat(np.arange(5), 4), 0.9),
        "test_below_classes": (np.repeat(np.arange(5), 4), 0.1),
    }[case]
    x = np.arange(len(y), dtype=float)[:, None]
    with pytest.raises(ValueError) as want:
        train_test_split(x, y, test_size=test_size, random_state=0, stratify=y)
    with pytest.raises(ValueError) as got:
        splits.stratified_split(x, y, y=y, test_size=test_size, random_state=0)
    assert str(got.value) == str(want.value)


# ---- features, metrics, posterior ----

@pytest.mark.parametrize("spec", ["epi,res", "x0 x3;x4|x5", "pV，pT、pH；pO", "13,14.15", "res,res"])
def test_parse_features_is_jax(spec):
    assert features.parse_features(spec) == jax_features.parse_features(spec)


@pytest.mark.parametrize("spec,err", [("label", ValueError), ("-5", ValueError),
                                      ("nope", KeyError)])
def test_parse_features_errors(spec, err):
    for mod in (features, jax_features):
        with pytest.raises(err):
            mod.parse_features(spec)


def test_y_true_warns_as_jax():
    with pytest.warns(UserWarning, match="leakage"):
        features.parse_features("y_true")


@pytest.mark.parametrize("spec", [config.AucConfig.group_spec, config.GmmConfig.group_spec,
                                  "a:1,2\nb:3", "故障:1 | 正常:0"])
def test_group_spec_and_extract_are_jax(spec):
    groups = features.parse_group_spec(spec)
    assert groups == jax_features.parse_group_spec(spec)
    label_map, names = features.build_label_mapper(groups)
    assert (label_map, names) == jax_features.build_label_mapper(groups)
    rng = np.random.RandomState(0)
    arr = rng.randn(300, 22)
    arr[:, 17] = rng.randint(0, 13, 300)
    arr[::37, 13] = np.nan
    for a, b in zip(features.extract_X_y(arr, [13, 14, 12], label_map, return_indices=True),
                    jax_features.extract_X_y(arr, [13, 14, 12], label_map,
                                             return_indices=True)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", ["a:1|a:2", "a:1|b:1", "a 1", "a:x", ""])
def test_group_spec_errors(spec):
    for mod in (features, jax_features):
        with pytest.raises(ValueError):
            mod.build_label_mapper(mod.parse_group_spec(spec))


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_are_jax(seed):
    rng = np.random.RandomState(seed)
    y_bin = rng.randint(0, 2, 500)
    score = np.round(rng.rand(500) + 0.3 * y_bin, 2)  # ties between thresholds
    for a, b in zip(metrics.roc_curve(y_bin, score), jax_metrics.roc_curve(y_bin, score)):
        np.testing.assert_array_equal(a, b)
    assert metrics.roc_auc_score(y_bin, score) == jax_metrics.roc_auc_score(y_bin, score)
    fpr, tpr, _ = metrics.roc_curve(y_bin, score)
    assert metrics.auc(fpr, tpr) == jax_metrics.auc(fpr, tpr)
    y_true, y_pred = rng.randint(0, 4, 300), rng.randint(0, 3, 300)
    np.testing.assert_array_equal(metrics.confusion_matrix(y_true, y_pred, 4),
                                  jax_metrics.confusion_matrix(y_true, y_pred, 4))
    assert metrics.accuracy_score(y_true, y_pred) == jax_metrics.accuracy_score(y_true, y_pred)
    for average in ("macro", "weighted"):
        got = metrics.precision_recall_f1(y_true, y_pred, 4, average=average)
        want = jax_metrics.precision_recall_f1(y_true, y_pred, 4, average=average)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    assert metrics.compute_macro_metrics(y_true, y_pred, 4) == \
        jax_metrics.compute_macro_metrics(y_true, y_pred, 4)
    names = ["a", "b", "c", "d"]
    assert metrics.classification_report_dict(y_true, y_pred, names) == \
        jax_metrics.classification_report_dict(y_true, y_pred, names)


def test_posterior_is_jax():
    rng = np.random.RandomState(3)
    resp = rng.dirichlet(np.ones(6), 200)
    resp[:, 5] = 0.0  # an empty component: the uniform fallback
    y = rng.randint(0, 4, 200)
    cal = posterior.calibrate_components(resp, y, 4)
    np.testing.assert_array_equal(cal, jax_posterior.calibrate_components(resp, y, 4))
    for a, b in zip(posterior.posterior_probabilities(resp[:50], cal),
                    jax_posterior.posterior_probabilities(resp[:50], cal)):
        np.testing.assert_array_equal(a, b)
    assign = rng.randint(0, 6, 40)
    np.testing.assert_array_equal(posterior.hard_responsibilities(assign, 6),
                                  jax_posterior.hard_responsibilities(assign, 6))


# ---- logistic regression ----

@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("balanced", [True, False])
def test_logreg_matches_jax(balanced, d, k):
    rng = np.random.RandomState(10 * d + k)
    n = 500
    y = rng.randint(0, k, n) if k > 2 else (rng.rand(n) < 0.2).astype(int)
    x = rng.randn(n, d) + 0.8 * y[:, None] + 3.0 * rng.randn(1, d)
    want = jax_logreg.logreg_fit(x, y, n_classes=k, balanced=balanced)
    got = logreg.logreg_fit(x, y, n_classes=k, balanced=balanced, device="cpu")
    assert got.n_iter == int(want.n_iter)
    np.testing.assert_allclose(logreg.logreg_predict_proba(got, x).numpy(),
                               np.asarray(jax_logreg.logreg_predict_proba(want, x)),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(logreg.logreg_predict(got, x).numpy(),
                                  np.asarray(jax_logreg.logreg_predict(want, x)))
    np.testing.assert_array_equal(
        logreg.balanced_class_weights(torch.as_tensor(y), k).numpy(),
        np.asarray(jax_logreg.balanced_class_weights(jnp.asarray(y), k)))
    names = [f"f{i}" for i in range(d)]
    cls = [f"c{i}" for i in range(k)]
    got_c = logreg.explain_coefficients(got, names, cls, topn=2)
    want_c = jax_logreg.explain_coefficients(want, names, cls, topn=2)
    for c in cls:
        for side in ("positive", "negative"):
            assert [n for n, _ in got_c[c][side]] == [n for n, _ in want_c[c][side]]
            np.testing.assert_allclose([w for _, w in got_c[c][side]],
                                       [w for _, w in want_c[c][side]], atol=1e-4)


def test_logreg_refuses_what_is_not_ported(blobs):
    """Only an unknown solver is refused: ``mask=`` is ported (with
    parallel/diagnosis.py), and a mask of ones fits as JAX's masked fit does
    (coef at tests/test_parallel.py's atol 5e-5)."""
    x, y = blobs
    got = logreg.logreg_fit(x, y, n_classes=4, mask=np.ones(len(y)), device="cpu")
    want = jax_logreg.logreg_fit(x, y, n_classes=4, mask=jnp.ones(len(y), jnp.float32))
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef), rtol=0, atol=5e-5)
    with pytest.raises(ValueError, match="unknown solver"):
        logreg.logreg_fit(x, y, n_classes=4, solver="sgd", device="cpu")


# ---- k-means ----

@pytest.mark.parametrize("n_clusters,key", [(4, 0), (8, 1)])
def test_lloyd_from_jax_centres(blobs, n_clusters, key):
    x, _ = blobs
    xj = jnp.asarray(x, jnp.float32)
    c0 = np.array(jax_kmeans._kmeans_plus_plus(xj, jax.random.PRNGKey(key), n_clusters))
    want = jax_kmeans._kmeans_single(xj, jax.random.PRNGKey(key), n_clusters)
    xt = torch.as_tensor(x, dtype=torch.float32)
    centers, n_iter = kmeans._lloyd(xt, torch.as_tensor(c0)[None], 300, 1e-4)
    assert int(n_iter[0]) == int(want.n_iter)
    np.testing.assert_allclose(centers[0].numpy(), np.asarray(want.centers), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(kmeans.kmeans_predict(centers[0], x).numpy(),
                                  np.asarray(want.assignments))


def test_kmeans_inertia_close_to_jax(blobs):
    x, _ = blobs
    got = kmeans.kmeans_fit(x, torch.Generator().manual_seed(0), n_clusters=4, device="cpu")
    want = jax_kmeans.kmeans_fit(x, jax.random.PRNGKey(0), n_clusters=4)
    assert float(got.inertia) <= 1.05 * float(want.inertia)
    assert float(got.inertia) >= 0.95 * float(want.inertia)
    d2 = ((x[:, None, :] - got.centers.numpy()[None].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_array_equal(got.assignments.numpy(), d2.argmin(1))


def test_kmeans_restarts_in_one_batch_pick_the_least_inertia(blobs):
    """The batched restarts equal the same draws run one restart at a time,
    and the winner is the restart of least inertia."""
    x, _ = blobs
    xt = torch.as_tensor(x, dtype=torch.float32)
    first, u = kmeans._draw(torch.Generator().manual_seed(5), len(x), 6, 4)
    both, n_both = kmeans._lloyd(xt, kmeans._kmeans_plus_plus(xt, first, u), 50, 1e-4)
    inertia = []
    for r in range(4):
        one, n_one = kmeans._lloyd(xt, kmeans._kmeans_plus_plus(xt, first[r:r + 1], u[r:r + 1]),
                                   50, 1e-4)
        torch.testing.assert_close(one[0], both[r], rtol=0, atol=1e-6)
        assert int(n_one[0]) == int(n_both[r])
        inertia.append(kmeans._pairwise_sq_dists(xt, one[0]).amin(dim=1).sum())
    got = kmeans.kmeans_fit(x, torch.Generator().manual_seed(5), 6, max_iter=50, device="cpu")
    torch.testing.assert_close(got.centers, both[int(np.argmin(inertia))], rtol=0, atol=1e-6)


def test_kmeans_plus_plus_picks_by_the_inverse_cdf():
    """A point is drawn with probability ∝ its min squared distance: the
    uniform 0.5 of min_d2 = (0, 1, 4, 9, 16)'s total 30 lands on the point
    whose cumulative mass first passes 15."""
    x = torch.arange(5, dtype=torch.float32)[:, None]
    centers = kmeans._kmeans_plus_plus(x, torch.tensor([0]),
                                       torch.tensor([[0.5]], dtype=torch.float64))
    assert centers[0, :, 0].tolist() == [0.0, 4.0]  # cumsum 0, 1, 5, 14, 30


# ---- Gaussian mixture ----

def test_gmm_float64_follows_jax_x64(blobs):
    x, _ = blobs
    init = gmm.sklearn_kmeans_init_resp(x, 6, 42)
    np.testing.assert_array_equal(init, jax_gmm.sklearn_kmeans_init_resp(x, 6, 42))
    with jax_x64():
        want = jax_gmm.gmm_fit(x, jax.random.PRNGKey(0), n_components=6, init_resp=init,
                               dtype=jnp.float64)
        want = jax.tree_util.tree_map(np.asarray, want)
    got = gmm.gmm_fit(x, None, 6, init_resp=init, dtype="float64", device="cpu")
    assert got.weights.dtype == torch.float64
    assert (got.n_iter, got.converged) == (int(want.n_iter), bool(want.converged))
    for name in ("weights", "means", "covariances"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name),
                                   rtol=0, atol=1e-9, err_msg=name)
    assert got.lower_bound == pytest.approx(float(want.lower_bound), abs=1e-9)


def test_gmm_float32_follows_jax(blobs):
    x, _ = blobs
    init = gmm.sklearn_kmeans_init_resp(x, 8, 0)
    want = jax_gmm.gmm_fit(x, jax.random.PRNGKey(0), n_components=8,
                           init_resp=init.astype(np.float32))
    got = gmm.gmm_fit(x, None, 8, init_resp=init, device="cpu")
    p_got = gmm.gmm_predict_proba(got, x).numpy()
    p_want = np.asarray(jax_gmm.gmm_predict_proba(want, x))
    assert (p_got.argmax(1) == p_want.argmax(1)).mean() >= 0.999
    assert got.lower_bound == pytest.approx(float(want.lower_bound), rel=1e-4)
    np.testing.assert_allclose(gmm.gmm_score_samples(got, x).numpy(),
                               np.asarray(jax_gmm.gmm_score_samples(want, x)), rtol=1e-4)


def test_gmm_kmeans_init_converges_like_jax(blobs):
    """The port's own k-means init (other draws than JAX's): the EM stops at
    sklearn's rule, and its likelihood is JAX's within 0.05 per sample."""
    x, _ = blobs
    got = gmm.gmm_fit(x, torch.Generator().manual_seed(0), 4, device="cpu")
    want = jax_gmm.gmm_fit(x, jax.random.PRNGKey(0), n_components=4)
    assert got.converged and got.n_iter < 100
    assert got.lower_bound == pytest.approx(float(want.lower_bound), abs=0.05)
    short = gmm.gmm_fit(x, torch.Generator().manual_seed(0), 4, max_iter=1, device="cpu")
    assert (short.converged, short.n_iter) == (False, 1)


def test_gmm_failed_cholesky_gives_nan_as_jax():
    means = np.zeros((2, 2), np.float32)
    covs = np.stack([np.eye(2), [[1.0, 2.0], [2.0, 1.0]]]).astype(np.float32)  # 2nd not PD
    x = np.random.RandomState(0).randn(5, 2).astype(np.float32)
    got = gmm._log_gaussian_prob(torch.as_tensor(x), torch.as_tensor(means),
                                 torch.as_tensor(covs)).numpy()
    want = np.asarray(jax_gmm._log_gaussian_prob(jnp.asarray(x), jnp.asarray(means),
                                                 jnp.asarray(covs)))
    assert np.isnan(got[:, 1]).all() and np.isnan(want[:, 1]).all()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6)


def test_sklearn_init_without_sklearn_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        gmm.sklearn_kmeans_init_resp(np.zeros((10, 2)), 2)


def test_gmm_params_from_numpy_scores_a_jax_mixture(blobs):
    x, _ = blobs
    want = jax_gmm.gmm_fit(x, jax.random.PRNGKey(3), n_components=5)
    port = gmm_params_from_numpy(np.asarray(want.weights), np.asarray(want.means),
                                 np.asarray(want.covariances), converged=bool(want.converged),
                                 n_iter=int(want.n_iter),
                                 lower_bound=float(want.lower_bound), device="cpu")
    assert port.means.dtype == torch.float32 and port.n_iter == int(want.n_iter)
    np.testing.assert_allclose(gmm.gmm_predict_proba(port, x).numpy(),
                               np.asarray(jax_gmm.gmm_predict_proba(want, x)), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="shapes"):
        gmm_params_from_numpy(np.ones(4), np.zeros((5, 4)), np.zeros((5, 4, 4)), device="cpu")


# ---- the forest ----

def _jax_forest_and_draws(x, key, n_estimators, psi, depth):
    """The JAX ``_fit_jit``'s trees (isoforest.py:106-109) and the draws that
    built them, replayed from the same key splits (:56-84), the draws in the
    port's (T, ψ), (T, M), (T, M) layout; one compiled program."""
    n, d = x.shape

    def one_tree(k):
        k_sub, k_feat, k_thr = jax.random.split(k, 3)
        fk, tk = jax.random.split(k_feat, depth), jax.random.split(k_thr, depth)
        draws = (jax.random.choice(k_sub, n, (psi,), replace=False),
                 jnp.concatenate([jax.random.randint(fk[lvl], (2**lvl,), 0, d)
                                  for lvl in range(depth)]),
                 jnp.concatenate([jax.random.uniform(tk[lvl], (2**lvl,))
                                  for lvl in range(depth)]))
        return jax_iso._build_tree(x, k, psi, depth), draws

    tables, draws = jax.jit(jax.vmap(one_tree))(jax.random.split(key, n_estimators))
    return [np.array(a) for a in tables], [torch.as_tensor(np.array(a)) for a in draws]


@pytest.mark.parametrize("n_fit,d,psi", [(1500, 2, 256), (60, 3, 60)])
def test_forest_from_jax_draws_is_jax(anomaly_data, n_fit, d, psi):
    rng = np.random.RandomState(d)
    x = np.hstack([anomaly_data[0][:n_fit], rng.randn(n_fit, max(0, d - 2))])[:, :d]
    x32 = x.astype(np.float32)
    depth = max(1, int(np.ceil(np.log2(psi))))
    (want_f, want_thr, want_size), (sub, feat, u) = _jax_forest_and_draws(
        jnp.asarray(x32), jax.random.PRNGKey(d), 16, psi, depth)
    f, thr, size = isoforest._build_trees_from_draws(
        torch.as_tensor(x32), sub.long(), feat.long(), u, depth)
    np.testing.assert_array_equal(f.numpy(), want_f)
    np.testing.assert_array_equal(size.numpy(), want_size)
    ulps = np.abs(thr.numpy().view(np.int32).astype(np.int64)
                  - want_thr.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    model = isoforest.IsoForest(f, thr, size, depth, psi)
    x_te = np.hstack([anomaly_data[1], rng.randn(len(anomaly_data[1]), max(0, d - 2))])[:, :d]
    got = isoforest.isoforest_score(model, x_te).numpy()
    ref = np.asarray(jax_iso._score_jit(want_f, want_thr, want_size,
                                        jnp.asarray(x_te, jnp.float32), depth, psi))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_forest_auc_close_to_jax(anomaly_data):
    x_fit, x_te, y = anomaly_data
    got = isoforest.isoforest_fit(x_fit, torch.Generator().manual_seed(0), n_estimators=32,
                                  device="cpu")
    want = jax_iso.isoforest_fit(x_fit, jax.random.PRNGKey(0), n_estimators=32)
    auc_got = metrics.roc_auc_score(y, isoforest.isoforest_score(got, x_te).numpy())
    auc_want = metrics.roc_auc_score(y, np.asarray(jax_iso.isoforest_score(want, x_te)))
    assert abs(auc_got - auc_want) < 0.03
    s = isoforest.isoforest_score(got, np.array([[0.0, 0.0], [5.0, -5.0]])).numpy()
    assert s[1] > s[0] and 0.0 < s[0] <= 1.0 and 0.0 < s[1] <= 1.0


def test_forest_and_kmeans_want_a_cpu_generator():
    class NotCpu:
        device = torch.device("meta")

    with pytest.raises(ValueError, match="CPU torch.Generator"):
        isoforest._draw(NotCpu(), 10, 2, 2, 4, 2)
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        kmeans._draw(NotCpu(), 10, 3, 2)


def test_avg_path_length_is_sklearns():
    n = np.array([0, 1, 2, 3, 10, 256, 1e4])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        from sklearn.ensemble._iforest import _average_path_length
    np.testing.assert_allclose(isoforest._avg_path_length(torch.as_tensor(n)).numpy(),
                               _average_path_length(n), rtol=1e-6)
    np.testing.assert_array_equal(isoforest._avg_path_length(torch.as_tensor(n)).numpy(),
                                  np.asarray(jax_iso._avg_path_length(jnp.asarray(n))))
