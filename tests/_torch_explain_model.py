"""The miniature model, artifact and checkpoints that the port's
explainability and figure tests share (``tests/test_torch_explain.py``,
``tests/test_torch_viz.py``): a narrow MLP (8→32→32→1) from a JAX key on the
660-row synthetic campaign (300 normal rows before the 50 < I < 800 filter,
12 fault segments of 30, seed 42), with λ's set so that the voltage residual
is NaN past the limiting current (i_l = 1.2 A/cm²) and λH0 sits at its lower
bound."""

import argparse

import jax
import numpy as np

from pinnfc_tpu.data.combine import combine_and_normalize as jax_combine
from pinnfc_tpu.models.pinn import init_pinn as jax_init_pinn
from pinnfc_tpu_torch.data.contract import INDEX, save_comprehensive_results
from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.utils.checkpoint import save_checkpoint
from pinnfc_tpu_torch.utils.jax_params import params_from_jax

LAYERS = (8, 32, 32, 1)
# the λ's no residual reads: the voltage group's name-shadowed λ4, the
# thermal stage's λT2 and λT4, the gas groups' reserved λ4
DEAD = {"lam_v": [3], "lam_t": [1, 3], "lam_h": [3], "lam_o": [3]}


def explain_model(root):
    """Namespace of the JAX params (``jp``) and dataset (``jds``), the port's
    params and scalers (``tp``, ``sx``, ``sy``), the 22-column artifact
    (``arr``: the campaign's de-normalized inputs, random residual and σ
    columns, one NaN residual in a normal row) with its ``labels`` and
    ``x_norm``, and in directory ``root`` its .mat file (``mat``), a port
    checkpoint with scalers and sidecar (``ckpt``) and one without scalers
    (``bare``), which both packages read."""
    normal, faults = synthesize_stack_data(n_normal=300, n_fault=30, seed=42)
    jds = jax_combine(normal, faults)
    jp = jax.tree_util.tree_map(np.asarray, jax_init_pinn(jax.random.PRNGKey(5), LAYERS))
    jp["lam_v"] = np.array([0.2, 2.0e-6, 1.2, 1.0], np.float32)
    jp["lam_h"] = np.array([0.5, -1.559, 197.715, 1.2], np.float32)
    x_norm = np.asarray(jds.x_test)
    n = x_norm.shape[0]
    bounds = list(jds.info.boundary_lines)
    labels = np.zeros(n, int)
    for k, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]), start=1):
        labels[lo:hi] = k
    rng = np.random.RandomState(0)
    arr = np.zeros((n, 22))
    arr[:, :8] = np.asarray(jds.scaler_x.inverse(x_norm), np.float64)
    arr[:, INDEX["y_true"]] = np.asarray(jds.scaler_y.inverse(np.asarray(jds.y_test))).ravel()
    arr[:, INDEX["res"]] = 0.02 * rng.randn(n) + 0.1 * (labels > 0) * rng.rand(n)
    arr[:, INDEX["y_pred"]] = arr[:, INDEX["y_true"]] - arr[:, INDEX["res"]]
    arr[:, INDEX["ale"]] = 0.01 + 0.002 * rng.rand(n)
    arr[:, INDEX["epi"]] = 0.005 + 0.001 * rng.rand(n)
    arr[:, INDEX["label"]] = labels
    arr[7, INDEX["res"]] = np.nan  # a glitched normal row
    mat, ckpt, bare = str(root / "F01_output.mat"), str(root / "ck"), str(root / "bare")
    save_comprehensive_results(arr, mat)
    tp = params_from_jax(jp, device="cpu")
    sx = AffineScaler.from_numpy(jds.scaler_x.to_numpy(), device="cpu")
    sy = AffineScaler.from_numpy(jds.scaler_y.to_numpy(), device="cpu")
    save_checkpoint(ckpt, tp, sx, sy, step=3, meta={"n_normal": 300, "n_fault": 30})
    save_checkpoint(bare, tp)
    return argparse.Namespace(jp=jp, jds=jds, tp=tp, sx=sx, sy=sy, arr=arr, labels=labels,
                              x_norm=x_norm, mat=mat, ckpt=ckpt, bare=bare, root=root)
