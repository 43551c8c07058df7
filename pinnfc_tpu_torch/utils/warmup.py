"""Warming a box before its first real run (counterpart of
``pinnfc_tpu/utils/warmup.py``).

The JAX package compiles its production programs ahead of time into XLA's
persistent cache.  The port has no XLA compile; what a first ``cli train``,
``score`` or ``monitor`` pays on a cold card is the kernel library's
``nvcc`` build (``ops/build.py``, once per source hash), the CUDA context,
cuBLAS's handle and the caching allocator's first blocks.  ``cli warmup``
pays them at a moment of the operator's choosing: it builds the library, then
runs each production step once at the configured row counts, on the device
the run will use:

* each distinct DNN stage: one launch of a 1-step chunk of the training
  kernel, in the form ``--precision`` names (the autograd stage for another
  topology);
* each distinct λ stage (``lambda_v`` in both loss modes, thermal, hydrogen,
  oxygen): one autograd Adam step, and the eval forward that feeds
  ``lambda_v``;
* the MC export: one pass of the MC kernel (``mc_kernel[...]``, the flagship
  on the card) or of the ``torch.Generator`` sampler (``mc_vmap[...]``);
* ``device_columns``: the residual kernel on the test rows;
* ``printed_stats``: the metric block's eval forward and residuals;
* with ``--ckpt``: one monitor step at ``--block`` rows.

The programs keep the JAX package's names.  Each record carries the hash of
the kernel library it ran against, and the manifest
(``pinnfc_warmup_manifest.json`` in the build directory) maps
``"<device type>:<program>"`` to it, so ``cli doctor`` can tell from the
filesystem alone whether a warmed box would load its library or build it
again.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from pinnfc_tpu_torch.utils.compilation_cache import resolve_compilation_cache

MANIFEST_NAME = "pinnfc_warmup_manifest.json"

Program = Tuple[str, Callable[[], object]]


def resolve_cache_dir() -> str:
    """The directory that holds the kernel library and the manifest."""
    return resolve_compilation_cache()["dir"]


def _dataset_for(config, n_normal: int, n_fault: int, campaign=None, device="cuda"):
    """The data source of ``run_training_pipeline`` (the row counts decide
    every step's shapes)."""
    if campaign is not None:
        from pinnfc_tpu_torch.data.campaign import load_campaign_dataset

        return load_campaign_dataset(campaign, device=device)
    from pinnfc_tpu_torch.data.combine import combine_and_normalize
    from pinnfc_tpu_torch.data.synthetic import synthesize_stack_data

    normal, faults = synthesize_stack_data(n_normal=n_normal, n_fault=n_fault, seed=config.seed)
    return combine_and_normalize(normal, faults, training_rate=config.training_rate,
                                 seed=config.seed, device=device)


def _stage_sig(stage) -> str:
    return f"@lr{stage.lr:g}/s{stage.lr_step}/g{stage.lr_gamma:g}"


def production_lowerings(config, dataset, ckpt_path: Optional[str] = None, block: int = 64,
                         mc_passes: int = 1) -> List[Program]:
    """(name, run) pairs, one per production step, where ``run()`` runs that
    step once on the dataset's device with fresh weights from
    ``config.seed``.  The names are those of the JAX ``production_lowerings``;
    the MC step runs ``mc_passes`` passes (``config.mc_times`` for a memory
    reading; its name keeps ``config.mc_times``)."""
    from pinnfc_tpu_torch.models.pinn import init_pinn
    from pinnfc_tpu_torch.training import stages as st

    dev = dataset.x_train.device
    params = init_pinn(config.model.layers, generator=torch.Generator().manual_seed(config.seed),
                       device=dev)
    mlp = params["mlp"]
    x_tr, y_tr, x_te = dataset.x_train, dataset.y_train, dataset.x_test
    sx, sy = dataset.scaler_x, dataset.scaler_y
    skip = config.skip_nonfinite

    def eval_forward(x):
        with torch.no_grad():
            return mlp(x)[0]

    progs: List[Program] = []
    seen = set()

    def add(name, run):
        if name not in seen:
            seen.add(name)
            progs.append((name, run))

    group_of = {"thermal": "lam_t", "hydrogen": "lam_h", "oxygen": "lam_o"}
    needs_eval_forward = False
    for stage in config.schedule:
        if stage.name == "dnn":
            add(f"dnn[{stage.n_iter}]{_stage_sig(stage)}", lambda s=stage: st.train_dnn_chunk(
                mlp, None, x_tr, y_tr, config.seed, 0, 1, s.lr, s.lr_step, s.lr_gamma,
                config.model.dropout_p, config.model.precision, skip))
        elif stage.name == "lambda_v":
            needs_eval_forward = True
            mode = "res" if stage.dnn_para else "norm"
            add(f"lambda_v[{stage.n_iter}]@{mode}/{_stage_sig(stage)[1:]}",
                lambda s=stage: st.train_lambda_v_chunk(
                    params["lam_v"], None, x_tr, y_tr, eval_forward(x_tr), sx, sy, 1, s.lr,
                    s.lr_step, s.lr_gamma, s.dnn_para, skip))
        elif stage.name in group_of:
            add(f"{stage.name}[{stage.n_iter}]{_stage_sig(stage)}",
                lambda s=stage, g=group_of[stage.name]: st.train_residual_chunk(
                    params[g], None, x_tr, sx, g, 1, s.lr, s.lr_step, s.lr_gamma, skip))
    if needs_eval_forward:
        add("eval_forward", lambda: eval_forward(x_tr))

    # the MC export: the sampler build_comprehensive_results takes
    if mlp.is_flagship():
        from pinnfc_tpu_torch.ops.mc_dropout import mc_dropout

        name = "mc_kernel" if dev.type == "cuda" else "mc_vmap"
        add(f"{name}[{config.mc_times}]", lambda: mc_dropout(
            mlp, x_te, config.seed, mc_times=mc_passes, dropout=config.mc_dropout))
    else:
        from pinnfc_tpu_torch.uq.mc_dropout import mc_dropout_samples

        add(f"mc_vmap[{config.mc_times}]", lambda: mc_dropout_samples(
            mlp, x_te, torch.Generator(dev).manual_seed(config.seed), mc_times=mc_passes,
            dropout=config.mc_dropout))

    from pinnfc_tpu_torch.ops.residuals import all_residuals_kernel

    add("device_columns", lambda: all_residuals_kernel(params, x_te, eval_forward(x_te), sx, sy))

    from pinnfc_tpu_torch.pipeline.train_pipeline import _printed_extras

    add("printed_stats", lambda: _printed_extras(params, x_te, eval_forward(x_te), sx, sy))

    if ckpt_path:
        import numpy as np

        from pinnfc_tpu_torch.config import RiskConfig
        from pinnfc_tpu_torch.serving.monitor import OnlineMonitor

        def monitor_step():
            monitor = OnlineMonitor.from_checkpoint(
                ckpt_path, np.zeros(5, np.float32), np.ones(5, np.float32), RiskConfig(),
                device=dev)
            rows = x_te[:block]
            return monitor.observe(sx.inverse(rows).cpu().numpy(),
                                   sy.inverse(dataset.y_test[:block])[:, 0].cpu().numpy())

        add(f"monitor_step[b{block}]", monitor_step)
    return progs


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def warm_cache(progs: List[Program], device="cuda", verbose: bool = True) -> List[Dict]:
    """Build the kernel library (on the card), then run each program once.
    One record per program: ``program``, ``key`` (the library's hash),
    ``compile_s`` (the step's seconds; the first one's include the build) and
    ``was_cached`` (the library existed before; None on the CPU, which loads
    none).  Writes the manifest, also after a failure part of the way."""
    from pinnfc_tpu_torch.ops import build

    cache = resolve_compilation_cache()
    key = cache["hash"]
    on_card = torch.device(device).type == "cuda"
    was_cached = cache["built"] if on_card else None
    records: List[Dict] = []
    try:
        t0 = time.perf_counter()
        if on_card:
            build.build()
            build.load()
        for name, run in progs:
            run()
            _sync(device)
            dt = time.perf_counter() - t0
            records.append({"program": name, "key": key, "compile_s": round(dt, 3),
                            "was_cached": was_cached})
            if verbose:
                state = "ran" if not on_card else "library loaded" if was_cached else "built"
                print(f"  {name:<42} {state:>14}  {dt:7.2f}s")
            t0 = time.perf_counter()
    finally:
        _write_manifest(records, device)
    return records


def warm_downstream(results, device="cuda", verbose: bool = True) -> List[Dict]:
    """Run the four cheap downstream pipelines (AUC, GMM, risk, the
    six-method comparison) once on an artifact: running them is their warmup.
    One record per stage, named ``downstream:<stage>:0`` as the JAX records'
    first program; none uses the kernel library (``key`` None), so none
    enters the manifest."""
    from pinnfc_tpu_torch.diagnosis import run_auc_pipeline, run_compare_pipeline
    from pinnfc_tpu_torch.diagnosis import run_gmm_pipeline
    from pinnfc_tpu_torch.risk import run_risk_pipeline

    stages = (("auc", run_auc_pipeline), ("gmm", run_gmm_pipeline),
              ("risk", run_risk_pipeline), ("compare", run_compare_pipeline))
    records: List[Dict] = []
    for stage, fn in stages:
        t0 = time.perf_counter()
        fn(results, device=device)
        _sync(device)
        dt = time.perf_counter() - t0
        records.append({"program": f"downstream:{stage}:0", "key": None,
                        "compile_s": round(dt, 3), "was_cached": None})
        if verbose:
            print(f"  downstream:{stage:<35} {'ran':>14}  {dt:7.2f}s")
    return records


def warm_eager_ops(config, device="cuda") -> int:
    """The eager work outside the steps: one float32 product (cuBLAS's handle
    on the card) and, per distinct stage length, a loss trace's allocation and
    its first and last readbacks (the caching allocator's blocks).  Returns
    the number of ops run."""
    a = torch.ones(256, 256, device=device)
    float((a @ a).sum())
    n = 1
    for n_iter in sorted({s.n_iter for s in config.schedule}):
        z = torch.zeros(n_iter, device=device)
        float(z[0])
        float(z[-1])
        n += 2
    return n


def _write_manifest(records: List[Dict], device="cuda") -> Optional[str]:
    """Merge the records' program → key map into the manifest (atomic;
    best-effort: a read-only build directory does not fail the warmup)."""
    path = os.path.join(resolve_cache_dir(), MANIFEST_NAME)
    try:
        os.makedirs(resolve_cache_dir(), exist_ok=True)
        programs = {}
        try:
            with open(path) as f:
                old = json.load(f).get("programs")
            programs = old if isinstance(old, dict) else {}
        except (OSError, ValueError, AttributeError):
            pass
        kind = torch.device(device).type
        for rec in records:
            if rec["key"]:
                programs[f"{kind}:{rec['program']}"] = rec["key"]
        manifest = {"programs": programs,
                    "updated": datetime.datetime.now(datetime.timezone.utc)
                    .isoformat(timespec="seconds"),
                    "torch": torch.__version__}
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2)
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def warmup_coverage() -> Dict:
    """Which warmed programs would load the built library: a program is
    present when its manifest key is the current library's hash and that
    library exists.  A filesystem check only (no CUDA, no build).  Stale
    programs (edited sources, a cleared build directory) leave ``ok`` True
    and set ``stale``, as in the JAX package: a cold library costs a build,
    not a failure.  Returns {ok, detail, present, missing, updated}."""
    path = os.path.join(resolve_cache_dir(), MANIFEST_NAME)
    try:
        with open(path) as f:
            manifest = json.load(f)
        programs = manifest.get("programs") or {}
        if not isinstance(programs, dict):
            raise ValueError("the manifest's programs are not a mapping")
    except (OSError, ValueError, AttributeError):
        return {"ok": True, "detail": "no warmup manifest: run `cli warmup` once to build the "
                                      "kernel library and warm the card before the first run",
                "present": [], "missing": [], "updated": None}
    cache = resolve_compilation_cache()
    present, missing = [], []
    for name, k in sorted(programs.items()):
        (present if cache["built"] and k == cache["hash"] else missing).append(name)
    detail = (f"{len(present)}/{len(programs)} warmed programs load the built library "
              f"{os.path.basename(cache['library'])} (manifest {manifest.get('updated', '?')}, torch "
              f"{manifest.get('torch', '?')})")
    if missing:
        detail += ("; STALE: re-run `cli warmup` (edited kernel sources or a cleared build "
                   "directory): " + ", ".join(missing[:6]) + ("…" if len(missing) > 6 else ""))
    return {"ok": True, "stale": bool(missing), "detail": detail, "present": present,
            "missing": missing, "updated": manifest.get("updated")}
