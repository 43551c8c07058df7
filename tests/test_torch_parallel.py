"""Port parity: the mesh helpers, data-parallel training and the row-sharded
MC export (pinnfc_tpu_torch.parallel.{mesh,data_parallel},
``run_schedule(mesh=)``, ``build_comprehensive_results(mesh=)``, ``train`` and
``score --data-parallel``) against the JAX package on its 8-virtual-device CPU
mesh (tests/conftest.py) and against the port's own unsharded paths.  The
port's meshes list the CPU k times.

Tolerances:
- ``run_schedule`` on a 4-way mesh against JAX's on 4 devices at dropout 0,
  divisible and ragged N (edge padding shifts the mean in both): those of
  tests/test_parallel.py's TestDataParallelSchedule: λ_t rtol 1e-5, the mean
  head's bias rtol 1e-4 atol 1e-7, loss traces rtol 1e-4 atol 1e-6;
- the port's sharded run against its unsharded run with dropout 0.2 (the same
  hash masks by global row): float32 summation order only, so JAX's own
  sharded-against-unsharded bands: losses rtol 1e-4 atol 1e-6, λ rtol 1e-5
  (atol 1e-7), weights rtol 1e-3 atol 1e-5 on (8, 16, 1) (Adam's normalised
  update magnifies rounding in near-zero gradient elements) and rtol = atol =
  5e-3 on the flagship, the hardware row of tests/test_pallas_train.py:47-49
  that tests/test_torch_cuda.py holds the training kernel to (9 steps at lr
  0.01 with loss spikes past 17 move 16 of 65,536 weights by up to 1.8e-4);
- per-shard plain gradients at row offsets summed against the whole-N plain
  gradient: loss rtol 1e-6, gradients rtol 1e-5 atol 1e-8;
- ``full_train_step`` against JAX's at dropout 0: losses and λ rtol 1e-5 (λ
  atol 1e-6), the MLP's weights rtol 1e-4 atol 1e-6;
- the sharded export's deterministic columns against JAX's mesh export at
  tests/test_torch_score.py's rtol 2e-5 atol 1e-5;
- bitwise, under one pinned CPU thread (``utils/threads.py``): the sharded
  MC statistics against the unsharded ones and the MC plain version with
  ``block0`` against one call over all rows (pieces of 256, 256 and 188
  rows, and of 512 and 188), the sharded export's columns that hold no MC
  statistic against the unsharded export's, chunks on a mesh and a killed
  and resumed run against the unchunked run on the mesh, a mesh of size 1
  against no mesh, one shard against the whole-N stage, and ``train``/``score
  --data-parallel --device cpu`` against the commands without the flag.  The
  CPU's float32 matmul may round a row of a piece otherwise than the same row
  of the whole matrix (it picks its code path by the row count: observed on
  the 9-row last piece of 777 rows, and on rows of a 256-row piece of 780), so
  the export's columns built on MC statistics (9-13) are held at rtol 1e-6
  (atol 1e-5 V on the prediction residual and f_v, a float32 ulp of a stack
  voltage); the kernels compute each row alike wherever it lies, and the
  card-only test and chip_smoke.py hold the sharded statistics bitwise.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from pinnfc_tpu.config import StageConfig as JaxStageConfig
from pinnfc_tpu.data.combine import combine_and_normalize as jax_combine
from pinnfc_tpu.data.scaling import AffineScaler as JaxScaler
from pinnfc_tpu.models.pinn import init_pinn as jax_init_pinn
from pinnfc_tpu.parallel import data_parallel as jax_dp
from pinnfc_tpu.parallel import mesh as jax_mesh
from pinnfc_tpu.pipeline import export as jax_export
from pinnfc_tpu.training import stages as jax_stages
from pinnfc_tpu_torch import cli
from pinnfc_tpu_torch.config import StageConfig
from pinnfc_tpu_torch.data.combine import combine_and_normalize
from pinnfc_tpu_torch.data.contract import load_comprehensive_results
from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.models.pinn import init_pinn
from pinnfc_tpu_torch.ops import train_dnn as td
from pinnfc_tpu_torch.ops.mc_dropout import dropout_constants, mc_dropout, mc_dropout_sums_plain
from pinnfc_tpu_torch.parallel import data_parallel as dp
from pinnfc_tpu_torch.parallel import mesh as pm
from pinnfc_tpu_torch.parallel.ensemble import mc_dropout_sharded
from pinnfc_tpu_torch.pipeline.export import build_comprehensive_results
from pinnfc_tpu_torch.training import stages
from pinnfc_tpu_torch.utils import checkpoint as ckpt_mod
from pinnfc_tpu_torch.utils.jax_params import params_from_jax, params_to_numpy
from pinnfc_tpu_torch.utils.threads import one_thread

SMALL = (8, 16, 1)
FLAGSHIP = (8, 256, 256, 256, 1)


def cpu_mesh(k: int) -> pm.Mesh:
    return pm.make_mesh(devices=["cpu"] * k)


@pytest.fixture(scope="module")
def rows():
    """x, y (160 rows) and the two scalers' fitting data, numpy."""
    rs = np.random.RandomState(0)
    return (rs.uniform(-1, 1, (160, 8)).astype(np.float32),
            rs.uniform(-1, 1, (160, 1)).astype(np.float32),
            rs.uniform(0, 1, (160, 8)), rs.uniform(3, 5, (160, 1)))


def _port_scalers(rows):
    return (AffineScaler.fit(rows[2], device="cpu"), AffineScaler.fit(rows[3], device="cpu"))


def _jax_params(seed, layers=SMALL):
    return jax.tree_util.tree_map(np.asarray, jax_init_pinn(jax.random.PRNGKey(seed), layers))


def _weights(params):
    return td.mlp_weights(params["mlp"])


def _assert_params_equal(a, b):
    for g in ("lam_v", "lam_t", "lam_h", "lam_o"):
        assert torch.equal(a[g], b[g]), g
    for u, v in zip(_weights(a), _weights(b)):
        assert torch.equal(u, v)


# ---- mesh helpers ----

def test_make_mesh_matches_jax():
    assert pm.make_mesh(devices=["cpu"] * 8).shape == dict(jax_mesh.make_mesh(8).shape)
    got = pm.make_mesh(8, axis_names=("model", "data"), shape=(4, 2), devices=["cpu"] * 8)
    want = jax_mesh.make_mesh(8, axis_names=("model", "data"), shape=(4, 2))
    assert got.shape == dict(want.shape) == {"model": 4, "data": 2}
    assert got.axis_devices("data", index=3) == [torch.device("cpu")] * 2


def test_make_mesh_errors_match_jax():
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(1000)
    with pytest.raises(ValueError) as got:
        pm.make_mesh(1000, devices=["cpu"])
    pattern = r"requested (\d+) devices, only (\d+) visible"
    assert re.fullmatch(pattern, str(want.value)).groups() == ("1000", str(jax.device_count()))
    assert re.fullmatch(pattern, str(got.value)).groups() == ("1000", "1")
    with pytest.raises(ValueError, match="multi-axis mesh needs an explicit shape"):
        jax_mesh.make_mesh(4, axis_names=("model", "data"))
    with pytest.raises(ValueError, match="multi-axis mesh needs an explicit shape"):
        pm.make_mesh(4, axis_names=("model", "data"), devices=["cpu"] * 4)


def test_default_mesh_is_every_visible_cuda_device():
    if torch.cuda.is_available():
        assert pm.make_mesh().size == torch.cuda.device_count()
    else:
        with pytest.raises(ValueError, match="a mesh needs at least one device"):
            pm.make_mesh()


@pytest.mark.parametrize("n, multiple", [(10, 8), (16, 8), (7, 3)])
def test_pad_to_multiple_matches_jax(n, multiple):
    a = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    want, n_want = jax_mesh.pad_to_multiple(a, multiple)
    got, n_got = pm.pad_to_multiple(a, multiple)
    got_t, n_t = pm.pad_to_multiple(torch.as_tensor(a), multiple)
    assert n_got == n_t == n_want == n
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))


def test_shard_gather_replicate_all_sum():
    mesh = cpu_mesh(4)
    x = torch.arange(24.0).reshape(12, 2)
    shards = pm.shard_batch(mesh, x)
    assert shards.offsets == (0, 3, 6, 9) and shards.n == 12
    assert torch.equal(pm.gather_rows(shards.array(0)), x)
    assert torch.equal(pm.gather_rows(shards.array(0), 10), x[:10])
    with pytest.raises(ValueError, match="do not divide"):
        pm.shard_batch(mesh, x[:11])
    params = init_pinn(SMALL, generator=torch.Generator().manual_seed(0), device="cpu")
    reps = pm.replicate(mesh, params)
    assert len(reps) == 4 and all(r["mlp"] is params["mlp"] for r in reps)
    parts = [torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8]), torch.tensor([1.0])]
    assert float(pm.all_sum(parts)) == 1.0  # in order, float32: 1e8 + 1 rounds to 1e8
    assert pm.block_sizes(15600, 4, 256) == [4096, 4096, 4096, 3312]
    assert pm.block_sizes(100, 4, 256) == [100, 0, 0, 0]


# ---- run_schedule on a mesh ----

JAX_DP_SCHED = (("dnn", 25, 0.01, 0.8), ("thermal", 25, 1.0, 0.8), ("hydrogen", 25, 0.1, 0.9))


@pytest.mark.parametrize("n", [160, 157])
def test_run_schedule_on_a_mesh_matches_jax(rows, n):
    x, y = rows[0][:n], rows[1][:n]
    jsched = tuple(JaxStageConfig(name, it, lr=lr, lr_gamma=g) for name, it, lr, g in JAX_DP_SCHED)
    sched = tuple(StageConfig(name, it, lr=lr, lr_gamma=g) for name, it, lr, g in JAX_DP_SCHED)
    jp = _jax_params(3)
    want, jlog = jax_stages.run_schedule(
        jp, x, y, JaxScaler.fit(rows[2]), JaxScaler.fit(rows[3]), schedule=jsched,
        rng=jax.random.PRNGKey(9), dropout_p=0.0, mesh=jax_mesh.make_mesh(4))
    sx, sy = _port_scalers(rows)
    got, log = stages.run_schedule(params_from_jax(jp, device="cpu"), torch.as_tensor(x),
                                   torch.as_tensor(y), sx, sy, schedule=sched, seed=9,
                                   dropout_p=0.0, mesh=cpu_mesh(4))
    np.testing.assert_allclose(got["lam_t"].numpy(), np.asarray(want["lam_t"]), rtol=1e-5)
    np.testing.assert_allclose(got["mlp"].mean.bias.detach().numpy(),
                               np.asarray(want["mlp"]["mean"]["b"]), rtol=1e-4, atol=1e-7)
    for (n1, l1), (n2, l2) in zip(jlog.stages, log.stages):
        assert n1 == n2
        np.testing.assert_allclose(l2, np.asarray(l1), rtol=1e-4, atol=1e-6, err_msg=n1)


SCHED = (StageConfig("dnn", 9, lr=0.01, lr_step=4), StageConfig("lambda_v", 6, lr=1e-3),
         StageConfig("lambda_v", 6, lr=1e-3, dnn_para=True), StageConfig("thermal", 7, lr=1.0),
         StageConfig("hydrogen", 5, lr=0.1, lr_gamma=0.9),
         StageConfig("oxygen", 5, lr=0.01, lr_gamma=0.9))


@pytest.mark.parametrize("layers, w_tol", [(SMALL, (1e-3, 1e-5)), (FLAGSHIP, (5e-3, 5e-3))])
def test_sharded_schedule_matches_unsharded_with_dropout(rows, layers, w_tol):
    x, y = torch.as_tensor(rows[0]), torch.as_tensor(rows[1])
    sx, sy = _port_scalers(rows)
    p0 = init_pinn(layers, generator=torch.Generator().manual_seed(1), device="cpu")
    a, la = stages.run_schedule(p0, x, y, sx, sy, schedule=SCHED, seed=3, dropout_p=0.2)
    b, lb = stages.run_schedule(p0, x, y, sx, sy, schedule=SCHED, seed=3, dropout_p=0.2,
                                mesh=cpu_mesh(4))
    for (n1, l1), (n2, l2) in zip(la.stages, lb.stages):
        np.testing.assert_allclose(l2, l1, rtol=1e-4, atol=1e-6, err_msg=n1)
    for g in ("lam_v", "lam_t", "lam_h", "lam_o"):
        torch.testing.assert_close(b[g], a[g], rtol=1e-5, atol=1e-7)
    for u, v in zip(_weights(a), _weights(b)):
        torch.testing.assert_close(v, u, rtol=w_tol[0], atol=w_tol[1])


def test_mesh_of_one_is_the_unsharded_run(rows):
    x, y = torch.as_tensor(rows[0]), torch.as_tensor(rows[1])
    sx, sy = _port_scalers(rows)
    p0 = init_pinn(SMALL, generator=torch.Generator().manual_seed(1), device="cpu")
    with one_thread():
        a, la = stages.run_schedule(p0, x, y, sx, sy, schedule=SCHED, seed=3)
        b, lb = stages.run_schedule(p0, x, y, sx, sy, schedule=SCHED, seed=3, mesh=cpu_mesh(1))
    _assert_params_equal(a, b)
    assert all(np.array_equal(l1, l2) for (_, l1), (_, l2) in zip(la.stages, lb.stages))


def test_chunks_and_resume_on_a_mesh_are_bitwise(rows, tmp_path, monkeypatch):
    """TestChunkedScheduleOnMesh's check, bitwise: chunks of 4 steps on a
    4-way mesh, a rerun that is a no-op, and a run killed after its 3rd
    snapshot and resumed."""
    x, y = torch.as_tensor(rows[0][:157]), torch.as_tensor(rows[1][:157])
    sx, sy = _port_scalers(rows)
    sched = (StageConfig("dnn", 9, lr=0.01), StageConfig("lambda_v", 7, lr=1e-3),
             StageConfig("thermal", 7, lr=1.0))
    p0 = init_pinn(SMALL, generator=torch.Generator().manual_seed(1), device="cpu")
    mesh = cpu_mesh(4)
    run = dict(schedule=sched, seed=2, dropout_p=0.2, mesh=mesh)
    with one_thread():
        mono, mlog = stages.run_schedule(p0, x, y, sx, sy, **run)
        ck = str(tmp_path / "meshck")
        chunked, clog = stages.run_schedule(p0, x, y, sx, sy, checkpoint_dir=ck, ckpt_every=4,
                                            **run)
        _assert_params_equal(mono, chunked)
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(mlog.stages, clog.stages))
        rerun, log = stages.run_schedule(p0, x, y, sx, sy, checkpoint_dir=ck, ckpt_every=4,
                                         **run)
        assert len(log.stages) == 0
        _assert_params_equal(chunked, rerun)

        save, calls = ckpt_mod.save_params_npz, []

        def killed(payload, path):
            save(payload, path)
            calls.append(1)
            if len(calls) == 3:
                raise KeyboardInterrupt

        ck2 = str(tmp_path / "killed")
        monkeypatch.setattr(ckpt_mod, "save_params_npz", killed)
        with pytest.raises(KeyboardInterrupt):
            stages.run_schedule(p0, x, y, sx, sy, checkpoint_dir=ck2, ckpt_every=4, **run)
        monkeypatch.setattr(ckpt_mod, "save_params_npz", save)
        resumed, _ = stages.run_schedule(p0, x, y, sx, sy, checkpoint_dir=ck2, ckpt_every=4,
                                         **run)
    _assert_params_equal(mono, resumed)


# ---- the DNN stage over row shards ----

def test_shard_masks_and_gradients_sum_to_the_whole(rows):
    """Rows cut at 300 and 800 (inside the 512-row mask blocks): each piece's
    masks at its global rows are the whole-N masks' rows, and the pieces'
    plain gradient terms sum to the whole-N plain gradient."""
    rs = np.random.RandomState(5)
    n = 1100
    x = torch.as_tensor(rs.uniform(-1, 1, (n, 8)).astype(np.float32))
    y = torch.as_tensor(rs.uniform(-1, 1, (n, 1)).astype(np.float32))
    mlp = init_pinn(FLAGSHIP, generator=torch.Generator().manual_seed(2), device="cpu")["mlp"]
    thresh, inv_keep = dropout_constants(0.2)
    widths = mlp.dropout_widths()
    ws = td.mlp_weights(mlp)
    whole = td.keep_masks(n, widths, 11, 4, thresh, "cpu")
    loss, grads = td.loss_and_grads(ws, x, y, whole, inv_keep, td._inv_n(n))
    cuts = [(0, 300), (300, 800), (800, n)]
    terms, parts = [], []
    for lo, hi in cuts:
        keep = td.keep_masks(hi - lo, widths, 11, 4, thresh, "cpu", row0=lo)
        assert all(torch.equal(k, w[lo:hi]) for k, w in zip(keep, whole))
        loss_k, g_k = td.loss_and_grads(ws, x[lo:hi], y[lo:hi], keep, inv_keep, td._inv_n(n))
        terms.append(loss_k)
        parts.append(g_k)
    torch.testing.assert_close(pm.all_sum(terms), loss, rtol=1e-6, atol=0)
    for i, g in enumerate(grads):
        torch.testing.assert_close(pm.all_sum([p[i] for p in parts]), g, rtol=1e-5, atol=1e-8)


def test_one_shard_is_the_whole_stage_bitwise(rows):
    x, y = torch.as_tensor(rows[0]), torch.as_tensor(rows[1])
    mlp = init_pinn(FLAGSHIP, generator=torch.Generator().manual_seed(2), device="cpu")["mlp"]
    shards = pm.RowShards(((x, y),), (0,), x.shape[0])
    with one_thread():
        a = td.train_dnn_stage_plain(mlp, x, y, 5, 6, lr_step=2, t0=3)
        b = td.train_dnn_sharded(mlp, shards, 5, 6, lr_step=2, t0=3)
    assert torch.equal(a.losses, b.losses) and torch.equal(a.state.m, b.state.m)
    assert all(torch.equal(u, v) for u, v in zip(td.mlp_weights(a.mlp), td.mlp_weights(b.mlp)))


def test_sharded_stage_checks_its_shards(rows):
    x, y = torch.as_tensor(rows[0]), torch.as_tensor(rows[1])
    mlp = init_pinn(SMALL, generator=torch.Generator().manual_seed(2), device="cpu")["mlp"]
    with pytest.raises(ValueError, match="y must be float32"):
        td.train_dnn_sharded(mlp, pm.RowShards(((x, y[:-1]),), (0,), 160), 1, 2)
    with pytest.raises(ValueError, match="no row shards"):
        td.train_dnn_sharded(mlp, pm.RowShards((), (), 0), 1, 2)


# ---- full_train_step ----

def _dp_setup(rows):
    jp = _jax_params(0)
    sx, sy = _port_scalers(rows)
    jsx, jsy = JaxScaler.fit(rows[2]), JaxScaler.fit(rows[3])
    return jp, sx, sy, jsx, jsy


def test_full_train_step_matches_jax(rows):
    x, y = rows[0], rows[1]
    jp, sx, sy, jsx, jsy = _dp_setup(rows)
    jopts = jax_dp.make_dp_optimizers()
    jstate, jlosses = jax_dp.full_train_step(jax_dp.init_dp_state(jp, jopts), x, y,
                                             jax.random.PRNGKey(42), jsx, jsy, jopts,
                                             dropout_p=0.0)
    opts = dp.make_dp_optimizers()
    state = dp.init_dp_state(params_from_jax(jp, device="cpu"), opts)
    for _ in range(2):  # the second step carries the Adam state
        state, losses = dp.full_train_step(state, torch.as_tensor(x), torch.as_tensor(y), 7, 0,
                                           sx, sy, opts, dropout_p=0.0, mesh=cpu_mesh(4))
        if _ == 0:
            for g in dp.GROUPS:
                np.testing.assert_allclose(float(losses[g]), float(jlosses[g]), rtol=1e-5,
                                           err_msg=g)
            got = params_to_numpy(state.params)
            want = jax.tree_util.tree_map(np.asarray, jstate.params)
            for g in ("lam_v", "lam_t", "lam_h", "lam_o"):
                np.testing.assert_allclose(got[g], want[g], rtol=1e-5, atol=1e-6, err_msg=g)
            for a, b in zip(jax.tree_util.tree_leaves(got["mlp"]),
                            jax.tree_util.tree_leaves(want["mlp"])):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert int(state.opt_states[0].count) == 2
    assert all(np.isfinite(float(v)) for v in losses.values())


def test_full_train_step_sharded_matches_unsharded(rows):
    from pinnfc_tpu_torch.models.pinn import LAMBDA_BOUNDS

    x, y = torch.as_tensor(rows[0]), torch.as_tensor(rows[1])
    jp, sx, sy, _, _ = _dp_setup(rows)
    opts = dp.make_dp_optimizers()
    outs = []
    for mesh in (None, cpu_mesh(4)):
        state = dp.init_dp_state(params_from_jax(jp, device="cpu"), opts)
        outs.append(dp.full_train_step(state, x, y, 7, 3, sx, sy, opts, dropout_p=0.2,
                                       mesh=mesh))
    (a, la), (b, lb) = outs
    for g in dp.GROUPS:
        torch.testing.assert_close(lb[g], la[g], rtol=1e-5, atol=1e-7)
    for g, (lo, hi) in LAMBDA_BOUNDS.items():
        torch.testing.assert_close(b.params[g], a.params[g], rtol=1e-5, atol=1e-7)
        lam = b.params[g].numpy()
        assert (lam >= lo).all() and (lam <= hi).all()
    for u, v in zip(_weights(a.params), _weights(b.params)):
        torch.testing.assert_close(v, u, rtol=1e-4, atol=1e-6)


# ---- MC dropout and the export over row shards ----

def test_mc_plain_block0_equals_one_call_bitwise():
    rs = np.random.RandomState(3)
    x = torch.as_tensor(rs.uniform(-1, 1, (700, 8)).astype(np.float32))
    mlp = init_pinn(FLAGSHIP, generator=torch.Generator().manual_seed(0), device="cpu")["mlp"]
    with one_thread():
        whole = mc_dropout_sums_plain(mlp, x, 99, mc_times=3)
        pieces = [mc_dropout_sums_plain(mlp, x[lo:hi], 99, mc_times=3, block0=lo // 256)
                  for lo, hi in ((0, 512), (512, 700))]
    assert torch.equal(torch.cat(pieces), whole)


@pytest.mark.parametrize("layers", [FLAGSHIP, SMALL])
def test_mc_dropout_sharded(layers):
    """The flagship's sharded statistics are the unsharded kernel path's bit
    for bit; another topology's pieces sample with their own generators (the
    eval pass, pred_mean, is still bitwise) and run the same passes."""
    rs = np.random.RandomState(4)
    x = torch.as_tensor(rs.uniform(-1, 1, (700, 8)).astype(np.float32))
    mlp = init_pinn(layers, generator=torch.Generator().manual_seed(0), device="cpu")["mlp"]
    mesh = cpu_mesh(4)
    with one_thread():
        got, passes = mc_dropout_sharded(mlp, x, 77, mesh, mc_times=6, chunk=4)
        if layers == FLAGSHIP:
            want = mc_dropout(mlp, x, 77, mc_times=6)
            assert passes == 6 and all(torch.equal(a, b) for a, b in zip(got, want))
        else:
            assert passes == 8 and torch.equal(got.pred_mean, mlp(x)[0][:, 0])
            assert all(bool(torch.isfinite(t).all()) for t in got)


@pytest.fixture(scope="module")
def export_setup():
    normal, faults = synthesize_stack_data(n_normal=300, n_fault=40, seed=42)
    jds = jax_combine(normal, faults)
    jds = dataclasses.replace(jds, x_test=jds.x_test[:-3], y_test=jds.y_test[:-3])
    ds = combine_and_normalize(normal, faults, device="cpu")
    ds = dataclasses.replace(ds, x_test=ds.x_test[:-3], y_test=ds.y_test[:-3])
    jp = jax_init_pinn(jax.random.PRNGKey(0))
    return jds, ds, jp


def test_sharded_export_is_the_unsharded_export_and_matches_jax(export_setup):
    """777 rows (ragged against the mesh and the 256-row blocks): the port's
    export on a 4-way mesh equals its unsharded export (the MC kernel's plain
    version per shard with ``block0``); its deterministic columns match JAX's
    mesh export (the ``vmap`` sampler)."""
    jds, ds, jp = export_setup
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    with one_thread():
        single, e1 = build_comprehensive_results(params, ds, mc_seed=5, mc_times=4,
                                                 smooth_window=50)
        sharded, e4 = build_comprehensive_results(params, ds, mc_seed=5, mc_times=4,
                                                  smooth_window=50, mesh=cpu_mesh(4))
    exact = [c for c in range(22) if c not in (9, 10, 11, 12, 13)]  # no MC statistic in them
    np.testing.assert_array_equal(sharded.array[:, exact], single.array[:, exact])
    for c in (9, 10, 11, 12, 13):
        np.testing.assert_allclose(sharded.array[:, c], single.array[:, c], rtol=1e-6,
                                   atol=1e-5 if c in (12, 13) else 0, err_msg=f"column {c}")
    assert e1 == e4 == {"sampler": "kernel", "mc_passes": 4}
    want = jax_export.build_comprehensive_results(jp, jds, rng=jax.random.PRNGKey(4),
                                                  mc_times=4, smooth_window=50,
                                                  mesh=jax_mesh.make_mesh(8)).array
    got = sharded.array
    assert got.shape == want.shape == (777, 22)
    for c in range(22):
        if c not in (10, 11):
            np.testing.assert_allclose(got[:, c], want[:, c], rtol=2e-5, atol=1e-5,
                                       equal_nan=True, err_msg=f"column {c}")


def test_export_mesh_of_one_is_the_unsharded_export(export_setup):
    _, ds, jp = export_setup
    params = init_pinn(SMALL, generator=torch.Generator().manual_seed(3), device="cpu")
    with one_thread():
        a, ea = build_comprehensive_results(params, ds, mc_seed=5, mc_times=4)
        b, eb = build_comprehensive_results(params, ds, mc_seed=5, mc_times=4,
                                            mesh=cpu_mesh(1))
    np.testing.assert_array_equal(a.array, b.array)
    assert ea == eb


# ---- the command line ----

def _run(argv, capsys):
    with one_thread():
        rc = cli.main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    return out


def test_cli_train_and_score_data_parallel_on_cpu_are_bitwise(tmp_path, capsys):
    base = ["--device", "cpu", "--small", "--n-normal", "300", "--n-fault", "40"]
    train = ["train", *base, "--steps-scale", "0.02"]
    paths = {k: str(tmp_path / k) for k in ("a", "b")}
    out_a = _run([*train, "--ckpt", paths["a"], "--mat-out", paths["a"] + ".mat"], capsys)
    out_b = _run([*train, "--ckpt", paths["b"], "--mat-out", paths["b"] + ".mat",
                  "--data-parallel"], capsys)
    assert "data-parallel over 1 devices" in out_b and "data-parallel" not in out_a
    arrays = {k: load_comprehensive_results(p + ".mat").array for k, p in paths.items()}
    np.testing.assert_array_equal(arrays["b"], arrays["a"])
    with open(paths["a"] + ".npz", "rb") as fa, open(paths["b"] + ".npz", "rb") as fb:
        assert fa.read() == fb.read()
    score = ["score", "--ckpt", paths["a"], "--device", "cpu"]
    _run([*score, "--mat-out", str(tmp_path / "sa.mat")], capsys)
    out = _run([*score, "--mat-out", str(tmp_path / "sb.mat"), "--data-parallel"], capsys)
    assert "MC export sharded over 1 devices" in out
    sa, sb = (load_comprehensive_results(str(tmp_path / f)).array for f in ("sa.mat", "sb.mat"))
    np.testing.assert_array_equal(sb, sa)
    np.testing.assert_array_equal(sa, arrays["a"])


def test_cli_data_parallel_needs_the_card_unless_asked_for_the_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = cli.main(["train", "--small", "--data-parallel", "--ckpt", str(tmp_path / "c")])
    assert rc == 1
    assert "no CUDA device" in capsys.readouterr().err
