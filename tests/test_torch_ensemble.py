"""Port parity: many-seed ensembles and deep-ensemble UQ
(pinnfc_tpu_torch.parallel.ensemble, pinnfc_tpu_torch.uq.deep_ensemble and
``cli ensemble``) against the JAX package, from JAX's ``init_ensemble``
weights carried across (``utils/jax_params.py::ensemble_from_jax``), the JAX
side on its 8-virtual-device CPU mesh (tests/conftest.py), the port's meshes
listing the CPU k times.

Tolerances:
- ``train_dnn_ensemble`` and ``train_dnn_ensemble_2d`` at dropout 0 against
  JAX: those of tests/test_parallel.py:118-143 (losses rtol 2e-4 atol 1e-5,
  weights rtol 2e-3 atol 2e-5);
- ``train_pinn_ensemble`` at dropout 0 against JAX: losses rtol 2e-4 atol
  1e-6, λ rtol 2e-5 atol 1e-6 (tests/test_torch_training.py's λ-stage
  bands: float32 log/exp/pow on both sides), the MLPs as above; λ inside
  their bounds and the MLP-independent thermal λ identical across members,
  as TestFullPinnEnsemble holds them;
- ``ensemble_predict`` and ``ensemble_moments`` against JAX: rtol 1e-5 (atol
  1e-7);
- bitwise, under one pinned CPU thread: a member with dropout against a lone
  ``train_dnn_stage`` with its seed, an ensemble split over a mesh against
  the ensemble without one, ``ensemble_moments_sharded`` against
  ``ensemble_moments`` (rows split in pieces of 40; every statistic is per
  row), the JAX tree round trip;
- ``cli ensemble --device cpu --small`` against JAX's command: the same table
  headings, member rows and lines; a ``--mesh-shape`` that asks for more
  devices than are visible raises JAX's ``ValueError`` message.
"""

import re

import jax
import numpy as np
import pytest
import torch

from pinnfc_tpu.cli import main as jax_main
from pinnfc_tpu.config import StageConfig as JaxStageConfig
from pinnfc_tpu.data.scaling import AffineScaler as JaxScaler
from pinnfc_tpu.parallel import ensemble as jax_ens
from pinnfc_tpu.parallel import mesh as jax_mesh
from pinnfc_tpu.uq import deep_ensemble as jax_de
from pinnfc_tpu_torch import cli
from pinnfc_tpu_torch.config import StageConfig
from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.models.pinn import LAMBDA_BOUNDS, init_pinn
from pinnfc_tpu_torch.ops import train_dnn as td
from pinnfc_tpu_torch.parallel import ensemble as ens_mod
from pinnfc_tpu_torch.parallel.mesh import make_mesh
from pinnfc_tpu_torch.training.stages import train_dnn_stage
from pinnfc_tpu_torch.uq.deep_ensemble import ensemble_moments, ensemble_moments_sharded
from pinnfc_tpu_torch.utils.jax_params import ensemble_from_jax, ensemble_to_numpy
from pinnfc_tpu_torch.utils.threads import one_thread

SMALL = (8, 16, 1)
FLAGSHIP = (8, 256, 256, 256, 1)


@pytest.fixture(scope="module")
def data():
    """x, y (160 rows) and the scalers' fitting data, numpy."""
    rs = np.random.RandomState(0)
    return (rs.uniform(-1, 1, (160, 8)).astype(np.float32),
            rs.uniform(-1, 1, (160, 1)).astype(np.float32),
            rs.uniform(0, 1, (160, 8)), rs.uniform(3, 5, (160, 1)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_ensemble():
    return _np_tree(jax_ens.init_ensemble(jax.random.PRNGKey(0), 4, layers=SMALL))


def _mlp_leaves(ens):
    return jax.tree_util.tree_leaves(ensemble_to_numpy(ens)["mlp"])


def _assert_mlps_close(got, want_tree, rtol, atol):
    for a, b in zip(_mlp_leaves(got), jax.tree_util.tree_leaves(_np_tree(want_tree))):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_jax_tree_round_trip(jax_ensemble):
    ens = ensemble_from_jax(jax_ensemble, device="cpu")
    assert len(ens["mlp"]) == 4 and tuple(ens["lam_t"].shape) == (4, 5)
    back = ensemble_to_numpy(ens)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jax_ensemble)):
        np.testing.assert_array_equal(a, b)


def test_init_ensemble_members_are_lone_inits():
    ens = ens_mod.init_ensemble(7, 3, SMALL, device="cpu")
    for e in range(3):
        lone = init_pinn(SMALL, generator=torch.Generator().manual_seed(ens_mod.member_seed(7, e)),
                         device="cpu")
        assert all(torch.equal(u, v) for u, v in
                   zip(td.mlp_weights(ens["mlp"][e]), td.mlp_weights(lone["mlp"])))
        assert all(torch.equal(ens[g][e], lone[g]) for g in LAMBDA_BOUNDS)
    assert len({ens_mod.member_seed(7, e) for e in range(3)}) == 3


def test_train_dnn_ensemble_matches_jax(data, jax_ensemble):
    x, y = data[0], data[1]
    want, wlosses = jax_ens.train_dnn_ensemble(jax_ensemble, x, y, jax.random.PRNGKey(1),
                                               n_iter=25, dropout_p=0.0,
                                               mesh=jax_mesh.make_mesh(4))
    got, losses = ens_mod.train_dnn_ensemble(ensemble_from_jax(jax_ensemble, device="cpu"),
                                             torch.as_tensor(x), torch.as_tensor(y), 1, 25,
                                             dropout_p=0.0, mesh=make_mesh(devices=["cpu"] * 4))
    assert tuple(losses.shape) == tuple(wlosses.shape) == (4, 25)
    np.testing.assert_allclose(losses.numpy(), np.asarray(wlosses), rtol=2e-4, atol=1e-5)
    _assert_mlps_close(got, want["mlp"], 2e-3, 2e-5)
    assert float(np.std(losses[:, -1].numpy())) > 0


def test_train_dnn_ensemble_2d_matches_jax(data, jax_ensemble):
    """Members over 'model' (4), each member's 156 rows over 'data' (2)."""
    x, y = data[0][:156], data[1][:156]
    mesh2d = jax_mesh.make_mesh(8, axis_names=("model", "data"), shape=(4, 2))
    want, wlosses = jax_ens.train_dnn_ensemble_2d(jax_ensemble, x, y, jax.random.PRNGKey(1),
                                                  n_iter=25, mesh=mesh2d, dropout_p=0.0)
    mesh = make_mesh(8, axis_names=("model", "data"), shape=(4, 2), devices=["cpu"] * 8)
    got, losses = ens_mod.train_dnn_ensemble_2d(ensemble_from_jax(jax_ensemble, device="cpu"),
                                                torch.as_tensor(x), torch.as_tensor(y), 1, 25,
                                                mesh, dropout_p=0.0)
    np.testing.assert_allclose(losses.numpy(), np.asarray(wlosses), rtol=2e-4, atol=1e-5)
    _assert_mlps_close(got, want["mlp"], 2e-3, 2e-5)


@pytest.mark.parametrize("layers", [SMALL, FLAGSHIP])
def test_members_are_lone_stages_bitwise(data, layers):
    x, y = torch.as_tensor(data[0]), torch.as_tensor(data[1])
    ens = ens_mod.init_ensemble(3, 2, layers, device="cpu")
    with one_thread():
        trained, losses = ens_mod.train_dnn_ensemble(ens, x, y, 11, 6)
        on_mesh, mesh_losses = ens_mod.train_dnn_ensemble(ens, x, y, 11, 6,
                                                          mesh=make_mesh(devices=["cpu"] * 2))
        for e in range(2):
            lone = train_dnn_stage(ens["mlp"][e], x, y, ens_mod.member_seed(11, e), 6)
            assert torch.equal(lone.losses, losses[e]) and torch.equal(lone.losses,
                                                                       mesh_losses[e])
            for u, v, w in zip(td.mlp_weights(lone.params), td.mlp_weights(trained["mlp"][e]),
                               td.mlp_weights(on_mesh["mlp"][e])):
                assert torch.equal(u, v) and torch.equal(u, w)


def test_train_dnn_ensemble_2d_is_the_ensemble(data):
    """With dropout, on a (2, 2) mesh of the CPU: each member's sharded stage
    draws its lone stage's masks by global row (summation order only)."""
    x, y = torch.as_tensor(data[0][:150]), torch.as_tensor(data[1][:150])
    ens = ens_mod.init_ensemble(3, 2, SMALL, device="cpu")
    a, la = ens_mod.train_dnn_ensemble(ens, x, y, 11, 8)
    mesh = make_mesh(4, axis_names=("model", "data"), shape=(2, 2), devices=["cpu"] * 4)
    b, lb = ens_mod.train_dnn_ensemble_2d(ens, x, y, 11, 8, mesh)
    torch.testing.assert_close(lb, la, rtol=1e-4, atol=1e-6)
    for ma, mb in zip(a["mlp"], b["mlp"]):
        for u, v in zip(td.mlp_weights(ma), td.mlp_weights(mb)):
            torch.testing.assert_close(v, u, rtol=1e-3, atol=1e-5)


PINN_SCHED = (("dnn", 20, 0.01, 0.8, False), ("lambda_v", 15, 1e-3, 0.8, True),
              ("lambda_v", 10, 1e-3, 0.8, False), ("thermal", 15, 1.0, 0.8, False),
              ("hydrogen", 15, 0.1, 0.9, False), ("oxygen", 15, 0.01, 0.9, False))


def test_train_pinn_ensemble_matches_jax(data, jax_ensemble):
    x, y = data[0], data[1]
    jsched = tuple(JaxStageConfig(n, it, lr=lr, lr_gamma=g, dnn_para=dp)
                   for n, it, lr, g, dp in PINN_SCHED)
    sched = tuple(StageConfig(n, it, lr=lr, lr_gamma=g, dnn_para=dp)
                  for n, it, lr, g, dp in PINN_SCHED)
    want, wlosses = jax_ens.train_pinn_ensemble(jax_ensemble, x, y, jax.random.PRNGKey(1),
                                                JaxScaler.fit(data[2]), JaxScaler.fit(data[3]),
                                                schedule=jsched, dropout_p=0.0)
    got, losses = ens_mod.train_pinn_ensemble(
        ensemble_from_jax(jax_ensemble, device="cpu"), torch.as_tensor(x), torch.as_tensor(y),
        1, AffineScaler.fit(data[2], device="cpu"), AffineScaler.fit(data[3], device="cpu"),
        schedule=sched, dropout_p=0.0)
    assert set(losses) == set(wlosses) == {"0:dnn", "1:lambda_v", "2:lambda_v", "3:thermal",
                                           "4:hydrogen", "5:oxygen"}
    for k, stage in enumerate(PINN_SCHED):
        name = f"{k}:{stage[0]}"
        want_l = wlosses[name]
        assert tuple(losses[name].shape) == (4, stage[1])
        np.testing.assert_allclose(losses[name].numpy(), np.asarray(want_l), rtol=2e-4,
                                   atol=1e-6, err_msg=name)
    for g, (lo, hi) in LAMBDA_BOUNDS.items():
        lam = got[g].numpy()
        np.testing.assert_allclose(lam, np.asarray(want[g]), rtol=2e-5, atol=1e-6, err_msg=g)
        assert lam.shape[0] == 4 and (lam >= lo).all() and (lam <= hi).all()
    _assert_mlps_close(got, want["mlp"], 2e-3, 2e-5)
    # the thermal stage does not see the MLP: every member ends on the same λ_t
    assert all(torch.equal(got["lam_t"][0], got["lam_t"][e]) for e in range(4))
    assert float(np.std(losses["0:dnn"][:, -1].numpy())) > 0


def test_ensemble_predict_and_moments_match_jax(data, jax_ensemble):
    x = data[0]
    ens = ensemble_from_jax(jax_ensemble, device="cpu")
    want = np.asarray(jax_ens.ensemble_predict(jax_ensemble, x))
    got = ens_mod.ensemble_predict(ens, torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (4, 160, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    jm = jax_de.ensemble_moments(jax_ensemble, x)
    pm = ensemble_moments(ens, torch.as_tensor(x))
    for name in ("pred_mean", "aleatoric_std", "epistemic_std"):
        np.testing.assert_allclose(getattr(pm, name).numpy(), np.asarray(getattr(jm, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_ensemble_moments_sharded_equals_unsharded(data):
    ens = ens_mod.init_ensemble(5, 3, FLAGSHIP, device="cpu")
    x = torch.as_tensor(data[0])
    with one_thread():
        whole = ensemble_moments(ens, x)
        sharded = ensemble_moments_sharded(ens, x, make_mesh(devices=["cpu"] * 4))
    assert all(torch.equal(a, b) for a, b in zip(whole, sharded))
    assert float(whole.epistemic_std.min()) > 0


# ---- the command line ----

def _table_shape(out: str):
    """The ensemble command's output without its numbers: every line with its
    numbers blanked."""
    return [re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "#", ln) for ln in out.strip().splitlines()]


@pytest.mark.parametrize("uq", [False, True])
def test_cli_ensemble_matches_jax_tables(capsys, uq):
    argv = ["ensemble", "--small", "--members", "2", "--steps", "3", "--seed", "4"]
    if uq:
        argv += ["--uq", "--uq-mc-times", "6"]
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    with one_thread():
        assert cli.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _table_shape(got) == _table_shape(want)
    assert len(_table_shape(got)) == (9 if uq else 4) + (1 if "correlation" in want else 0)


def test_cli_ensemble_mesh_shape(capsys):
    argv = ["ensemble", "--small", "--members", "2", "--steps", "2", "--device", "cpu"]
    with one_thread():
        assert cli.main(argv) == 0
        plain = capsys.readouterr().out
        assert cli.main([*argv, "--mesh-shape", "1x1"]) == 0
        mesh = capsys.readouterr().out
    assert mesh.splitlines()[0] == "2-D mesh: 2 members over 1 × rows over 1"
    assert mesh.splitlines()[1:] == plain.splitlines()
    pattern = r"requested (\d+) devices, only (\d+) visible"
    with pytest.raises(ValueError) as got:
        cli.main([*argv, "--mesh-shape", "2x2"])
    assert re.fullmatch(pattern, str(got.value)).groups() == ("4", "1")
    with pytest.raises(ValueError) as want:
        jax_main(["ensemble", "--small", "--members", "2", "--steps", "2",
                  "--mesh-shape", "4x4"])
    assert re.fullmatch(pattern, str(want.value)).groups() == ("16", str(jax.device_count()))
