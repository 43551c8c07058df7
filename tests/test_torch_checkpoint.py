"""Port parity: checkpoints written by the JAX package's ``save_checkpoint``
in its default Orbax format load in the port (pinnfc_tpu_torch.utils.checkpoint)
without JAX, and the ``score`` command line runs on them.

The JAX ``load_checkpoint`` is the oracle: params, scalers and ``step`` come
back bitwise equal (no arithmetic touches them).  Scoring the Orbax checkpoint
and the same params re-saved through the port's npz path gives bitwise equal
artifacts: one process, one pinned CPU thread, the same inputs."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

import pinnfc_tpu.config as jax_config
from pinnfc_tpu.data.combine import combine_and_normalize as jax_combine
from pinnfc_tpu.models.pinn import init_pinn as jax_init_pinn
from pinnfc_tpu.utils import checkpoint as jax_ckpt
from pinnfc_tpu_torch.data.contract import load_comprehensive_results
from pinnfc_tpu_torch.data.scaling import AffineScaler
from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data
from pinnfc_tpu_torch.utils import checkpoint
from pinnfc_tpu_torch.utils.jax_params import params_from_jax, params_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = (8, 32, 32, 1)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def orbax_ckpt(tmp_path_factory):
    """A small PINN with scalers, ``step`` and the sidecar ``cmd_train``
    writes, saved through the JAX ``save_checkpoint``: (path, params, meta)."""
    params = jax.tree_util.tree_map(np.asarray, jax_init_pinn(jax.random.PRNGKey(3), LAYERS))
    normal, faults = synthesize_stack_data(n_normal=300, n_fault=40, seed=42)
    jds = jax_combine(normal, faults)
    cfg = jax_config.TrainConfig(model=jax_config.ModelConfig(layers=LAYERS), mc_times=8,
                                 smooth_window=50)
    meta = {"config": jax_config.train_config_to_dict(cfg), "n_normal": 300, "n_fault": 40}
    path = str(tmp_path_factory.mktemp("orbax") / "ck")
    jax_ckpt.save_checkpoint(path, params, jds.scaler_x, jds.scaler_y, step=11, meta=meta)
    assert os.path.isfile(os.path.join(path, "_METADATA")), "the Orbax path was not taken"
    assert not os.path.exists(path + ".npz")
    return path, params, meta


def test_jax_orbax_checkpoint_loads_bitwise(orbax_ckpt):
    path, params, meta = orbax_ckpt
    got = checkpoint.load_checkpoint(path, device="cpu")
    want = jax_ckpt.load_checkpoint(path)
    flat_got = checkpoint._flatten(params_to_numpy(got["params"]))
    flat_want = checkpoint._flatten(want["params"])
    assert flat_got.keys() == flat_want.keys() == checkpoint._flatten(params).keys()
    for k, v in flat_want.items():
        assert flat_got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(flat_got[k], v, err_msg=k)
    for name in ("scaler_x", "scaler_y"):
        s, js = got[name], want[name]
        for k in ("scale", "min", "data_min", "data_max"):
            np.testing.assert_array_equal(_np(getattr(s, k)), np.asarray(getattr(js, k)),
                                          err_msg=f"{name}.{k}")
        assert s.feature_range == tuple(float(v) for v in js.feature_range)
    assert got["step"].dtype == np.asarray(want["step"]).dtype
    np.testing.assert_array_equal(got["step"], want["step"])
    assert int(got["step"]) == 11
    assert got["meta"] == want["meta"] == json.loads(json.dumps(meta))


def _assert_trees_equal(got, want):
    """The port's loaded checkpoint against the JAX loader's, bitwise."""
    flat_got = checkpoint._flatten(params_to_numpy(got["params"]))
    flat_want = checkpoint._flatten(want["params"])
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], np.asarray(v), err_msg=k)
    for name in ("scaler_x", "scaler_y"):
        np.testing.assert_array_equal(_np(got[name].scale), np.asarray(want[name].scale))
    np.testing.assert_array_equal(got["step"], want["step"])


def test_both_formats_present_load_as_the_jax_loader_does(tmp_path):
    """A JAX save over a path the port wrote leaves both ``<path>.npz`` and
    ``<path>/``: both loaders read the Orbax tree.  A port save over a JAX
    Orbax checkpoint replaces the directory, so both then read the npz."""
    normal, faults = synthesize_stack_data(n_normal=300, n_fault=40, seed=42)
    jds = jax_combine(normal, faults)
    first, second = (jax.tree_util.tree_map(np.asarray, jax_init_pinn(jax.random.PRNGKey(k),
                                                                      LAYERS))
                     for k in (4, 5))
    path = str(tmp_path / "ck")
    port_x, port_y = (AffineScaler.from_numpy(s.to_numpy(), device="cpu")
                      for s in (jds.scaler_x, jds.scaler_y))
    checkpoint.save_checkpoint(path, params_from_jax(first, device="cpu"),
                               port_x, port_y, step=1)
    jax_ckpt.save_checkpoint(path, second, jds.scaler_x, jds.scaler_y, step=2)
    assert os.path.isfile(path + ".npz") and os.path.isfile(os.path.join(path, "_METADATA"))
    want = jax_ckpt.load_checkpoint(path)
    assert int(want["step"]) == 2
    _assert_trees_equal(checkpoint.load_checkpoint(path, device="cpu"), want)

    checkpoint.save_checkpoint(path, params_from_jax(first, device="cpu"),
                               port_x, port_y, step=3)
    assert not os.path.exists(path) and os.path.isfile(path + ".npz")
    want = jax_ckpt.load_checkpoint(path)
    assert int(want["step"]) == 3
    np.testing.assert_array_equal(want["params"]["lam_v"], first["lam_v"])
    _assert_trees_equal(checkpoint.load_checkpoint(path, device="cpu"), want)


def test_cli_score_on_a_jax_orbax_checkpoint(orbax_ckpt, tmp_path):
    """``cli score`` returns 0 on the Orbax checkpoint, without importing JAX,
    and its artifact equals, bitwise, the one scored from the same params
    re-saved through the port's npz path."""
    path, _, meta = orbax_ckpt
    loaded = checkpoint.load_checkpoint(path, device="cpu")
    npz = str(tmp_path / "port_ck")
    checkpoint.save_checkpoint(npz, loaded["params"], loaded["scaler_x"], loaded["scaler_y"],
                               step=int(loaded["step"]), meta=meta)
    mats = [str(tmp_path / "orbax.mat"), str(tmp_path / "npz.mat")]
    script = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        from pinnfc_tpu_torch.cli import main
        for ckpt, mat in zip(sys.argv[1:3], sys.argv[3:5]):
            rc = main(["score", "--ckpt", ckpt, "--device", "cpu", "--small",
                       "--mc-times", "8", "--mat-out", mat])
            assert rc == 0, f"score on {ckpt} returned {rc}"
        assert "jax" not in sys.modules, "the port imported jax"
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script, path, npz, *mats], cwd=REPO, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:]
    a, b = (load_comprehensive_results(m).array for m in mats)
    assert a.shape == (1500 + 12 * 200, 22)
    assert np.array_equal(a, b, equal_nan=True)


def _fake_orbax(tmp_path, **fields):
    path = tmp_path / "ck"
    path.mkdir()
    metadata = {"tree_metadata": {}, "use_ocdbt": True, "use_zarr3": False, **fields}
    (path / "_METADATA").write_text(json.dumps(metadata))
    return str(path)


@pytest.mark.parametrize("fields,match", [
    ({"use_zarr3": True}, "zarr3"),
    ({"use_ocdbt": False}, "OCDBT"),
])
def test_unsupported_orbax_metadata_raises(tmp_path, fields, match):
    with pytest.raises(ValueError, match=match):
        checkpoint.load_checkpoint(_fake_orbax(tmp_path, **fields), device="cpu")


def test_orbax_checkpoint_without_tensorstore_raises(orbax_ckpt, monkeypatch):
    path, _, _ = orbax_ckpt
    monkeypatch.setitem(sys.modules, "tensorstore", None)  # import raises ImportError
    with pytest.raises(ValueError, match="tensorstore"):
        checkpoint.load_checkpoint(path, device="cpu")


def test_missing_checkpoint_still_names_the_npz(tmp_path):
    with pytest.raises(FileNotFoundError, match="ck.npz"):
        checkpoint.load_checkpoint(str(tmp_path / "ck"), device="cpu")
