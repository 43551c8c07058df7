"""λ_v of the training pipeline sharded against unsharded, in the port and in
the JAX package, on the CPU.

On ``[cuda:0] * 4`` the port's sharded and unsharded pipelines left λ_v
1.117e-2 apart (chip_smoke.py phase 19).  This holds that gap beside JAX's
own: JAX's ``run_training_pipeline`` with and without a 4-device CPU mesh
(tests/conftest.py forces the host devices), and the port's
``run_training_pipeline`` with and without a 4-way mesh of the CPU, from
JAX's initial weights carried across, at a cut head of the schedule (a DNN
stage and both λ_v stages, 60 steps each) on 300 normal rows, for three
seeds.  The two packages draw other dropout masks (``jax.random`` against
the TPU kernel's hash), so the runs compare as gaps, not as values.

What it shows: the gap lives in λ_v[1] (i0, the exchange current density),
whose box [2.36e-7, 4.956e-6] is far narrower than one Adam step at the
stage's lr of 1e-3.  Where its gradient is near zero, a float32 summation
order decides whether a step lands on a bound or inside the box, so i0 of
the two runs may part by a large share of the box in either package: JAX's
parts by 0.37 and 0.69 (relative) at seeds 2 and 3 here, the port's stays
put at these seeds, and r and i_l part by 1e-5 to 7e-3 in both.  One seed's
gap is a coin flip of where i0 lands, so the test takes the largest gap over
three seeds: the port's is asserted within 10x of JAX's, element by element
of λ_v.  About 40 s, 15 of them JAX's first compile of the pipeline.
"""

import jax
import numpy as np

from pinnfc_tpu.config import StageConfig as JaxStageConfig
from pinnfc_tpu.config import TrainConfig as JaxTrainConfig
from pinnfc_tpu.models.pinn import init_pinn as jax_init_pinn
from pinnfc_tpu.parallel import mesh as jax_mesh
from pinnfc_tpu.pipeline import train_pipeline as jax_pipeline
from pinnfc_tpu_torch.config import StageConfig, TrainConfig
from pinnfc_tpu_torch.parallel import mesh as pm
from pinnfc_tpu_torch.pipeline import train_pipeline as port_pipeline
from pinnfc_tpu_torch.utils.jax_params import params_from_jax
from pinnfc_tpu_torch.utils.threads import one_thread

SEEDS = (1, 2, 3)
STEPS, N_NORMAL, N_FAULT = 60, 300, 40
# (name, steps, lr, dnn_para): the schedule's head, the stages that set λ_v
HEAD = (("dnn", STEPS, 0.01, False), ("lambda_v", STEPS, 1e-3, False),
        ("lambda_v", STEPS, 1e-3, True))


def _rel(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def _jax_gap(seed: int) -> np.ndarray:
    cfg = JaxTrainConfig(schedule=tuple(JaxStageConfig(n, s, lr=lr, dnn_para=d)
                                        for n, s, lr, d in HEAD), mc_times=4, seed=seed)
    whole = jax_pipeline.run_training_pipeline(cfg, n_normal=N_NORMAL, n_fault=N_FAULT)
    sharded = jax_pipeline.run_training_pipeline(cfg, n_normal=N_NORMAL, n_fault=N_FAULT,
                                                 mesh=jax_mesh.make_mesh(4))
    return _rel(sharded.params["lam_v"], whole.params["lam_v"])


def _port_gap(seed: int, monkeypatch) -> np.ndarray:
    cfg = TrainConfig(schedule=tuple(StageConfig(n, s, lr=lr, dnn_para=d)
                                     for n, s, lr, d in HEAD), mc_times=4, seed=seed)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_pinn(jax.random.PRNGKey(seed), cfg.model.layers))
    monkeypatch.setattr(port_pipeline, "init_pinn",
                        lambda layers, generator=None, device="cpu":
                        params_from_jax(tree, device=device))
    with one_thread():
        whole = port_pipeline.run_training_pipeline(cfg, n_normal=N_NORMAL, n_fault=N_FAULT,
                                                    device="cpu")
        sharded = port_pipeline.run_training_pipeline(
            cfg, n_normal=N_NORMAL, n_fault=N_FAULT, device="cpu",
            mesh=pm.make_mesh(devices=["cpu"] * 4))
    return _rel(sharded.params["lam_v"].numpy(), whole.params["lam_v"].numpy())


def test_lambda_v_sharded_gap_is_jaxs_own(monkeypatch):
    jax_gaps = np.stack([_jax_gap(s) for s in SEEDS])
    port_gaps = np.stack([_port_gap(s, monkeypatch) for s in SEEDS])
    print(f"λ_v sharded vs unsharded, relative, by seed {SEEDS} (rows) and element "
          f"(columns r, i0, i_l, reserved): JAX\n{jax_gaps}\nport\n{port_gaps}")
    jax_max, port_max = jax_gaps.max(axis=0), port_gaps.max(axis=0)
    assert jax_max[1] > 0.1  # i0 flips inside its box in JAX as well
    assert np.all(port_max <= 10 * jax_max), (port_max, jax_max)
