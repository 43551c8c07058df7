"""Deployment self-check, ``cli doctor`` (counterpart of
``pinnfc_tpu/utils/doctor.py``).

The checks and their order are the JAX package's; their contents are the
card's.  Every check returns ``{"name", "ok", "detail", ...}``.  Nothing here
initialises CUDA in the calling process: the card probe and the smoke run
happen in bounded subprocesses (the JAX ``_MARKER`` protocol), so a wedged
driver gives a readable diagnosis instead of a hung doctor.

* ``versions``: python, the port, torch and its CUDA, numpy, scipy;
* ``environment``: ``CUDA_VISIBLE_DEVICES``, ``CUDA_HOME``, ``CUDA_PATH``;
* ``compilation_cache``: the build directory is writable, ``nvcc`` is found
  (``ops/build.py::_nvcc``), the kernel library for the current sources is
  built or not; no ``nvcc`` and no built library fails, since the first
  kernel launch could not build it;
* ``warmup_coverage``: ``utils/warmup.py::warmup_coverage``;
* ``checkpoint`` (``--ckpt``), ``artifact`` (``--artifact``);
* ``backend_probe``: the card's name, its compute capability (the kernels are
  built for sm_90a: (9, 0)), the seconds to a ready context and to one
  256 × 256 product;
* ``smoke_train`` (``--smoke``): 101 Adam steps through the training kernel.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

_MARKER = "PINNFC_DOCTOR_JSON "

# environment variables that change which card runs and where nvcc is found
_ENV_OF_INTEREST = ("CUDA_VISIBLE_DEVICES", "CUDA_HOME", "CUDA_PATH")

# the compute capability the kernels are built for (sm_90a)
KERNEL_CAPABILITY = (9, 0)


def check_versions() -> Dict:
    """Interpreter and library versions (informational; always ok)."""
    import numpy
    import scipy
    import torch

    import pinnfc_tpu_torch

    vers = {"python": sys.version.split()[0], "pinnfc_tpu_torch": pinnfc_tpu_torch.__version__,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "numpy": numpy.__version__, "scipy": scipy.__version__}
    detail = "  ".join(f"{k} {v}" for k, v in vers.items() if v is not None)
    return {"name": "versions", "ok": True, "detail": detail, "versions": vers}


def check_environment() -> Dict:
    """The environment variables that pick the card and the CUDA toolkit
    (informational)."""
    env = {key: os.environ.get(key) for key in _ENV_OF_INTEREST}
    detail = "  ".join(f"{k}={v}" for k, v in env.items() if v is not None)
    return {"name": "environment", "ok": True,
            "detail": detail or "(no card or toolkit overrides set)", "env": env}


def check_compilation_cache() -> Dict:
    """Is the kernel library's build directory writable, is ``nvcc`` there,
    and is the library for the current sources built?"""
    from pinnfc_tpu_torch.ops import build
    from pinnfc_tpu_torch.utils.compilation_cache import resolve_compilation_cache

    cache = resolve_compilation_cache()
    out = {"name": "compilation_cache", **cache}
    try:
        os.makedirs(cache["dir"], exist_ok=True)
        probe = os.path.join(cache["dir"], f".doctor_probe_{os.getpid()}")
        with open(probe, "w") as f:
            f.write("ok")
        os.remove(probe)
    except OSError as e:
        return {**out, "ok": False, "detail": f"{cache['dir']} not writable ({e}): the kernel "
                                              "library cannot be built or cached"}
    try:
        out["nvcc"] = build._nvcc()
    except RuntimeError:
        out["nvcc"] = None
    state = "built" if cache["built"] else "not built (the first kernel launch builds it)"
    out["ok"] = bool(cache["built"] or out["nvcc"])
    out["detail"] = (f"{cache['dir']} writable, nvcc {out['nvcc'] or 'NOT FOUND'}, library "
                     f"{os.path.basename(cache['library'])} {state}")
    if not out["ok"]:
        out["detail"] += ": no kernel can run on the card"
    return out


def check_warmup_coverage() -> Dict:
    """Which warmed programs would load the built kernel library
    (``utils/warmup.py``'s manifest): a filesystem check only."""
    from pinnfc_tpu_torch.utils.warmup import warmup_coverage

    res = warmup_coverage()
    res["name"] = "warmup_coverage"
    return res


def _bounded_python(code: str, timeout: float, env: Optional[dict] = None) -> Dict:
    """Run ``code`` in a fresh interpreter with the port importable and parse
    its last ``_MARKER`` line as JSON.  A timeout, a non-zero exit or a
    missing marker comes back as ``{"ok": False, "error": ...}``."""
    import pinnfc_tpu_torch

    run_env = dict(os.environ if env is None else env)
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(pinnfc_tpu_torch.__file__)))
    run_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_parent, run_env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-c", code], env=run_env, capture_output=True,
                              text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"timed out after {timeout:.0f}s: the CUDA driver or the "
                                      "card did not answer",
                "elapsed_s": round(time.perf_counter() - t0, 1)}
    if proc.returncode != 0:
        tail = (proc.stdout + proc.stderr)[-2000:]
        return {"ok": False, "error": f"rc={proc.returncode}: {tail}"}
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith(_MARKER):
            out = json.loads(line[len(_MARKER):])
            out.setdefault("ok", True)
            return out
    return {"ok": False, "error": f"no doctor marker in output: {proc.stdout[-500:]}"}


_PROBE_CODE = f"""
import json, time
t0 = time.time()
import torch
from pinnfc_tpu_torch.device import resolve_device
dev = resolve_device(PLATFORM)
out = {{"platform": dev.type}}
if dev.type == "cuda":
    torch.cuda.init()
    torch.empty(1, device=dev)
    out["devices"] = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    out["capability"] = list(torch.cuda.get_device_capability(dev))
else:
    out["devices"] = ["cpu"]
    out["capability"] = None
out["init_s"] = round(time.time() - t0, 3)
t1 = time.time()
a = torch.ones(256, 256, device=dev)
float((a @ a).sum())
out["first_op_s"] = round(time.time() - t1, 3)
print({_MARKER!r} + json.dumps(out))
"""


def probe_backend(timeout: float = 600.0, platform: Optional[str] = None) -> Dict:
    """Bring up ``platform`` (``cuda``, the default, or ``cpu``) in a bounded
    subprocess and time the context and one 256 × 256 product.  On the card
    a capability other than (9, 0) fails: the kernels are built for sm_90a.
    ``cuda`` on a box without a card fails; it never reports the CPU."""
    platform = platform or "cuda"
    res = _bounded_python(f"PLATFORM = {platform!r}\n" + _PROBE_CODE, timeout)
    res["name"] = "backend_probe"
    if not res["ok"]:
        res["detail"] = res.get("error", "probe failed")
        return res
    cap = res["capability"]
    where = f"{res['platform']}: {len(res['devices'])}x {res['devices'][0]}"
    if cap is not None:
        where += f" (sm_{cap[0]}{cap[1]})"
        if tuple(cap) != KERNEL_CAPABILITY:
            res["ok"] = False
            where += (f": the kernels need capability {KERNEL_CAPABILITY} "
                      "(built for sm_90a)")
    res["detail"] = f"{where}, init {res['init_s']}s, first op {res['first_op_s']}s"
    return res


_SMOKE_CODE = f"""
import json, time
import numpy as np
import torch
from pinnfc_tpu_torch.device import resolve_device
from pinnfc_tpu_torch.models.mlp import MLP
from pinnfc_tpu_torch.ops import build
from pinnfc_tpu_torch.training.stages import train_dnn_stage
dev = resolve_device(PLATFORM)
rng = np.random.RandomState(0)
x = torch.as_tensor(rng.uniform(-1, 1, (256, 8)).astype(np.float32), device=dev)
y = torch.as_tensor(rng.uniform(-1, 1, (256, 1)).astype(np.float32), device=dev)
mlp = MLP(generator=torch.Generator().manual_seed(0), device=dev)
build.reset_launches()
t0 = time.time()
res = train_dnn_stage(mlp, x, y, 0, n_iter=101)
loss = float(res.losses[-1])
first_call_s = time.time() - t0
t1 = time.time()
res = train_dnn_stage(mlp, x, y, 1, n_iter=101)
float(res.losses[-1])
steady_s = time.time() - t1
print({_MARKER!r} + json.dumps({{
    "ok": bool(np.isfinite(loss)),
    "platform": dev.type,
    "steps_per_sec": round(101 / steady_s, 1),
    "first_call_s": round(first_call_s, 3),
    "final_loss": loss,
    "train_dnn_launches": build.LAUNCHES["train_dnn"],
}}))
"""


def smoke_train(timeout: float = 900.0, platform: Optional[str] = None) -> Dict:
    """101 Adam steps of a DNN stage on 256 rows, twice, in a bounded
    subprocess: on the card through the training kernel (the flagship
    width, the one the kernel covers), the first call with the library's
    build or load.  Proves build, launch and readback; not a benchmark."""
    platform = platform or "cuda"
    res = _bounded_python(f"PLATFORM = {platform!r}\n" + _SMOKE_CODE, timeout)
    res["name"] = "smoke_train"
    if res["ok"]:
        via = (f"{res['train_dnn_launches']} training-kernel launches"
               if res["platform"] == "cuda" else "the plain version")
        res["detail"] = (f"{res['platform']}: 101 flagship Adam steps on 256 rows ({via}), "
                         f"{res['steps_per_sec']} steps/s steady (first call "
                         f"{res['first_call_s']}s with the library's build or load)")
    else:
        res["detail"] = res.get("error", "smoke run failed")
    return res


def check_checkpoint(path: str) -> Dict:
    """Can this host read the checkpoint it is about to serve: the arrays (a
    port npz, a JAX npz or an Orbax directory, read on the host) and the
    provenance sidecar."""
    from pinnfc_tpu_torch.utils.checkpoint import _flatten, load_checkpoint_raw

    try:
        ckpt = load_checkpoint_raw(path)
        flat = _flatten(ckpt["params"])
        total = int(sum(a.size for a in flat.values()))
        scalers = [k for k in ("scaler_x", "scaler_y") if ckpt.get(k) is not None]
    except Exception as e:  # any unreadable checkpoint is this check's finding
        return {"name": "checkpoint", "ok": False, "detail": f"{path}: {e}"}
    meta = ckpt.get("meta")
    prov = ""
    if isinstance(meta, dict):
        bits = [str(meta.get("created", ""))]
        cfg = meta.get("config")
        if isinstance(cfg, dict) and "seed" in cfg:
            bits.append(f"seed {cfg['seed']}")
        prov = ", " + ", ".join(b for b in bits if b)
    return {"name": "checkpoint", "ok": True,
            "detail": f"{path}: {total:,} params, scalers {'+'.join(scalers) or 'absent'}{prov}",
            "total_parameters": total, "meta": meta}


def check_artifact(path: str) -> Dict:
    """Deserialize a ``serving/exported.py`` artifact without running it and
    report the device types it was exported for (``--platforms``)."""
    from pinnfc_tpu_torch.serving.exported import _read

    try:
        with open(path, "rb") as f:
            blob = f.read()
        ep, meta = _read(blob)
        platforms = list(meta.get("platforms", []))
        in_shapes = [str(tuple(s.size())) for s in ep.example_inputs[0]
                     if hasattr(s, "size")] if ep.example_inputs else []
    except Exception as e:  # any unreadable artifact is this check's finding
        return {"name": "artifact", "ok": False, "detail": f"{path}: {e}"}
    sidecar = None
    if os.path.exists(path + ".meta.json"):
        try:
            with open(path + ".meta.json") as f:
                sidecar = json.load(f)
        except (OSError, ValueError):
            sidecar = None
    return {"name": "artifact", "ok": True,
            "detail": f"{path}: platforms {','.join(platforms)}, {len(blob) / 2**20:.2f} MiB, "
                      f"inputs {in_shapes[:3]}" + ("…" if len(in_shapes) > 3 else "")
                      + (", sidecar ok" if sidecar else ""),
            "platforms": platforms, "sidecar": sidecar}


def run_doctor(probe_timeout: float = 600.0, platform: Optional[str] = None,
               skip_probe: bool = False, smoke: bool = False, ckpt: Optional[str] = None,
               artifact: Optional[str] = None) -> List[Dict]:
    """Every requested check, from the cheapest to the heaviest."""
    checks = [check_versions(), check_environment(), check_compilation_cache(),
              check_warmup_coverage()]
    if ckpt:
        checks.append(check_checkpoint(ckpt))
    if artifact:
        checks.append(check_artifact(artifact))
    if not skip_probe:
        checks.append(probe_backend(probe_timeout, platform))
    if smoke:
        checks.append(smoke_train(max(probe_timeout, 900.0), platform))
    return checks
