"""Operational subcommands (counterpart of ``pinnfc_tpu/cli/admin.py``):
``doctor`` (the deployment self-check), ``warmup`` (the kernel library's
build and one run of each production step) and ``bench`` (the training
throughput line)."""

from __future__ import annotations

import json
import sys
import time

from pinnfc_tpu_torch.cli._common import _USER_ERRORS


def cmd_warmup(args) -> int:
    """Build the kernel library and run each production step once at the
    configured row counts on ``--device`` (``utils/warmup.py``): every
    distinct stage, the MC export, the exporter's and the metric block's
    residuals and (with ``--ckpt``) the monitor step; with ``--mat`` the
    downstream pipelines; then cuBLAS and the allocator.  Writes the
    manifest that ``cli doctor`` reads.  A failed build is an error (exit
    1); a bad campaign exits 2, as in the JAX command."""
    from pinnfc_tpu_torch.cli._common import _campaign_from_args, _train_config
    from pinnfc_tpu_torch.device import resolve_device
    from pinnfc_tpu_torch.utils.warmup import (
        _dataset_for, production_lowerings, resolve_cache_dir, warm_cache, warm_downstream,
        warm_eager_ops)

    cfg = _train_config(args)
    n_normal = args.n_normal or (1500 if args.small else 6000)
    n_fault = args.n_fault or (200 if args.small else 800)
    try:
        campaign = _campaign_from_args(args)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"warmup: {e}", file=sys.stderr)
        return 1
    print(f"warming {dev.type} programs with the kernel library in {resolve_cache_dir()} "
          f"(schedule: {len(cfg.schedule)} stages, mc_times={cfg.mc_times})")
    try:
        t0 = time.perf_counter()
        dataset = _dataset_for(cfg, n_normal, n_fault, campaign=campaign, device=dev)
        print(f"  dataset built in {time.perf_counter() - t0:.1f}s "
              f"(x_train {tuple(dataset.x_train.shape)}, x_test {tuple(dataset.x_test.shape)})")
        progs = production_lowerings(cfg, dataset, ckpt_path=args.ckpt, block=args.block)
        records = warm_cache(progs, device=dev, verbose=not args.json)
        if args.mat:
            from pinnfc_tpu_torch.data.contract import load_comprehensive_results

            records += warm_downstream(load_comprehensive_results(args.mat), device=dev,
                                       verbose=not args.json)
        n_eager = warm_eager_ops(cfg, device=dev)
    except _USER_ERRORS as e:
        print(f"warmup: {e}", file=sys.stderr)
        return 1
    if not args.json:
        print(f"  + {n_eager} eager ops (cuBLAS, the allocator, the loss readbacks)")
    total = sum(r["compile_s"] or 0 for r in records)
    hits = sum(1 for r in records if r["was_cached"])
    if args.json:
        print(json.dumps({"programs": records, "total_compile_s": round(total, 1),
                          "already_cached": hits}))
    else:
        n_down = sum(r["program"].startswith("downstream:") for r in records)
        tail = f" + {n_down} downstream programs" if n_down else ""
        print(f"warmed {len(records) - n_down} programs in {total:.1f}s "
              f"({hits} found the library built){tail}")
    return 0


def cmd_doctor(args) -> int:
    """Deployment self-check (``utils/doctor.py``): versions, environment,
    the kernel library, warmup coverage, optional checkpoint and artifact
    pre-flight, the card probe and ``--smoke``.  Exit 1 when any check
    fails."""
    from pinnfc_tpu_torch.utils.doctor import run_doctor

    checks = run_doctor(probe_timeout=args.probe_timeout, platform=args.platform,
                        skip_probe=args.skip_probe, smoke=args.smoke, ckpt=args.ckpt,
                        artifact=args.artifact)
    if args.json:
        print(json.dumps(checks))
    else:
        for c in checks:
            print(f"[{'ok' if c['ok'] else 'FAIL':>4}] {c['name']:<18} {c['detail']}")
    return 0 if all(c["ok"] for c in checks) else 1


def cmd_bench(args) -> int:
    """The training-throughput line of ``pinnfc_tpu_torch/bench.py``."""
    from pinnfc_tpu_torch import bench

    try:
        return bench.main(args.device)
    except _USER_ERRORS as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
