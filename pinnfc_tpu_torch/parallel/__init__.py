"""Device meshes, data-parallel training and many-seed ensembles
(counterpart of ``pinnfc_tpu/parallel/``).

``mesh`` is imported at once (it depends on nothing else of the port); the
other names load their module at first use, so the training stages can use
the mesh helpers without importing the ensembles.
"""

from importlib import import_module

from pinnfc_tpu_torch.parallel.mesh import (
    Mesh,
    RowShards,
    all_sum,
    gather_rows,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)

_LAZY = {
    "DPTrainState": "data_parallel",
    "full_train_step": "data_parallel",
    "init_dp_state": "data_parallel",
    "gmm_fit_dp": "diagnosis",
    "logreg_fit_dp": "diagnosis",
    "make_dp_optimizers": "data_parallel",
    "ensemble_predict": "ensemble",
    "init_ensemble": "ensemble",
    "mc_dropout_sharded": "ensemble",
    "train_dnn_ensemble": "ensemble",
    "train_dnn_ensemble_2d": "ensemble",
    "train_pinn_ensemble": "ensemble",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Mesh",
    "RowShards",
    "all_sum",
    "gather_rows",
    "make_mesh",
    "pad_to_multiple",
    "replicate",
    "shard_batch",
    *_LAZY,
]
