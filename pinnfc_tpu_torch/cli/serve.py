"""``monitor`` and ``serve`` subcommands (counterpart of ``pinnfc_tpu/cli/serve.py``):
``monitor`` replays a ``comprehensive_results`` artifact through
``OnlineMonitor`` on ``--device``, block by block as a deployed scorer
consumes live measurements, or with ``--fleet`` the 12 risk conditions as
concurrent streams; ``serve`` puts the monitor (from a checkpoint or an
exported artifact) behind the HTTP endpoint.  The JAX commands' lines and
argument errors (exit 2).  ``--data-parallel`` splits the fleet's streams
(``monitor --fleet``, ``serve``'s /observe_many) over every visible device of
``--device``: one card gives a mesh of one device, the unsharded step."""

from __future__ import annotations

import sys

from pinnfc_tpu_torch.cli._common import (
    _USER_ERRORS,
    _data_parallel_mesh,
    _glitch_default,
    _print_ckpt_provenance,
    _streaming_conformal_calib,
)


def _monitor_fleet(monitor, results, block: int) -> int:
    """Streaming fleet replay: every (current, fault) risk condition of
    04:145-161 as a concurrent stream, one ``observe_many`` step per
    lockstep block."""
    import numpy as np

    from pinnfc_tpu_torch.serving import fleet_replay

    table = fleet_replay(monitor, results, block=block)
    if not table:
        print("no risk conditions present in this artifact")
        return 1
    print(f"fleet replay: {len(table)} conditions as concurrent streams (block {block})")
    fmt = "none"
    print(f"{'fault':<14}{'I[A]':>6}{'n':>7}{'warn':>7}{'danger':>8}"
          f"{'v_alarm':>9}{'advance':>9}  driver")
    for r in table:
        driver = ""
        if r.layer_shares:
            name = max(r.layer_shares, key=r.layer_shares.get)
            driver = f"{name} {r.layer_shares[name]:.0%}"
        print(
            f"{r.fault_name:<14}{r.current_target:>6g}{r.n_samples:>7}"
            f"{fmt if r.first_warn is None else r.first_warn:>7}"
            f"{fmt if r.first_danger is None else r.first_danger:>8}"
            f"{fmt if r.first_v_alarm is None else r.first_v_alarm:>9}"
            f"{fmt if r.advance is None else r.advance:>9}  {driver}"
        )
    warned = [r for r in table if r.advance is not None]
    if warned:
        mean_adv = np.mean([r.advance for r in warned])
        print(f"mean RF lead over the voltage alarm: {mean_adv:.0f} samples "
              f"({len(warned)}/{len(table)} conditions with both alarms)")
    return 0


def _build_monitor(args, arr, results):
    """The command's ``OnlineMonitor`` from ``--ckpt`` on ``--device`` with
    its optional diagnosis head and conformal calibration, printing the
    JAX command's set-up lines."""
    from pinnfc_tpu_torch.config import RiskConfig
    from pinnfc_tpu_torch.risk import estimate_mu_sigma_normal
    from pinnfc_tpu_torch.serving import DiagnosisHead, OnlineMonitor

    mu, sigma = estimate_mu_sigma_normal(arr)
    head = None
    if args.diagnose or args.head or args.save_head:  # --head/--save-head imply diagnosis
        # classify the stream's fault type online with script 03's calibrated
        # GMM; reuse a fit handed in by an earlier gmm stage on this artifact
        if args.head:
            head = DiagnosisHead.load(args.head, device=args.device)
        else:
            gmm_result = getattr(args, "gmm_result", None)
            if gmm_result is None:
                from pinnfc_tpu_torch.diagnosis import run_gmm_pipeline

                gmm_result = run_gmm_pipeline(results, device=args.device)
            head = DiagnosisHead.from_gmm_result(gmm_result)
        if args.save_head:
            print(f"diagnosis head → {head.save(args.save_head)}")
    mesh = _fleet_mesh(args)
    conformal_calib = None
    if args.conformal:
        conformal_calib = _streaming_conformal_calib(arr, args.conformal_alpha)
    _print_ckpt_provenance(args.ckpt)
    return OnlineMonitor.from_checkpoint(
        args.ckpt, mu, sigma, RiskConfig(), head,
        glitch_alarm_n=(args.glitch_alarm_n if args.glitch_alarm_n is not None
                        else _glitch_default()),
        conformal_calib=conformal_calib, conformal_alpha=args.conformal_alpha,
        conformal_gamma=args.conformal_gamma or 0.0, device=args.device, mesh=mesh,
    )


def _fleet_mesh(args):
    """The mesh of ``--data-parallel`` for the monitor's streams, with the
    JAX command's line when it spans more than one device."""
    mesh = _data_parallel_mesh(args)
    if mesh is not None and mesh.size > 1:
        print(f"fleet sharding: streams over {mesh.size} devices")
    return mesh


def cmd_monitor(args) -> int:
    """Streaming replay: feed a ``comprehensive_results`` artifact through the
    ``OnlineMonitor`` block by block, as a deployed scorer would consume live
    measurements; print the first warn/danger/voltage alarms, the risk
    attribution at the first warn, and with the options the online diagnosis,
    the conformal anomaly rates and the suggested actuation."""
    import numpy as np

    if args.fleet and args.conformal:
        # the fleet table has no p-value column; validated before any loading
        print("--conformal applies to a single-stream replay (the fleet "
              "table has no p-value column); drop --fleet, or stream "
              "conformal_p per sample via `cli serve --conformal`", file=sys.stderr)
        return 2
    conformal_gamma = args.conformal_gamma or 0.0
    if conformal_gamma and not args.conformal:
        print("--conformal-gamma needs --conformal (there is no p-value "
              "to adapt the level against)", file=sys.stderr)
        return 2

    from pinnfc_tpu_torch.config import RiskConfig
    from pinnfc_tpu_torch.data.contract import INDEX, channel_names, load_comprehensive_results

    cfg = RiskConfig()
    try:
        results = load_comprehensive_results(args.mat)
        arr = results.array
        monitor = _build_monitor(args, arr, results)
    except _USER_ERRORS as e:
        print(f"monitor: {e}", file=sys.stderr)
        return 1

    if args.fleet:
        if args.whatif:
            print("--whatif applies to a single-stream replay; for the "
                  "per-condition analysis over the whole fleet use "
                  "`cli whatif`", file=sys.stderr)
            return 2
        return _monitor_fleet(monitor, results, args.block)

    rows = arr
    if args.fault_label is not None:
        # one fault segment preceded by its lead-in normal rows
        mask = arr[:, INDEX["label"]] == args.fault_label
        lead = arr[arr[:, INDEX["label"]] == 0][-args.lead:]
        rows = np.vstack([lead, arr[mask]])

    head = monitor.diagnosis
    x_raw = rows[:, 0:8]
    v_meas = rows[:, INDEX["y_true"]]
    first = {"warn": None, "danger": None, "v_alarm": None}
    diag_counts = None
    warn_shares = None  # the attribution at the first warn (layer_c)
    # [normal, fault] × [finite-p samples, p ≤ α samples] over the replay
    conf_counts = np.zeros((2, 2), np.int64)
    pos = 0
    while pos < len(rows):
        out = monitor.observe(x_raw[pos: pos + args.block], v_meas[pos: pos + args.block])
        if out.conformal_p is not None:
            p_blk = out.conformal_p
            is_fault = rows[pos: pos + args.block, INDEX["label"]] > 0
            for grp in (0, 1):
                sel = np.isfinite(p_blk) & (is_fault == bool(grp))
                # tie-inclusive, like the monitor's own counter
                conf_counts[grp] += (int(sel.sum()),
                                     int((p_blk[sel] <= monitor.conformal_alpha).sum()))
        for name, flags in (("warn", out.warn), ("danger", out.danger),
                            ("v_alarm", out.v_alarm)):
            if first[name] is None and flags.any():
                first[name] = pos + int(np.argmax(flags))
        if head is not None and out.warn.any():
            # fault-type votes while the RF warns; glitched samples carry
            # fault_pred = -1 and do not vote
            valid = out.warn & (out.fault_pred >= 0)
            votes = np.bincount(out.fault_pred[valid], minlength=len(head.class_names))
            diag_counts = votes if diag_counts is None else diag_counts + votes
        if warn_shares is None and out.warn.any():
            i = int(np.argmax(out.warn))
            row = out.layer_c[i]
            if np.isfinite(row).all() and row.sum() > 0:
                warn_shares = row / row.sum()
        pos += args.block
    print(f"streamed {len(rows)} samples in blocks of {args.block}: "
          f"first warn={first['warn']}  danger={first['danger']}  "
          f"voltage alarm={first['v_alarm']}")
    if first["warn"] is not None and first["v_alarm"] is not None:
        print(f"RF lead over voltage alarm: {first['v_alarm'] - first['warn']} samples")
    if warn_shares is not None:
        breakdown = "  ".join(f"{n} {s:.0%}" for n, s in zip(monitor.layer_names, warn_shares))
        print(f"risk attribution at first warn: {breakdown}")
    if diag_counts is not None:
        name = head.class_names[int(np.argmax(diag_counts))]
        share = diag_counts.max() / max(diag_counts.sum(), 1)
        print(f"online diagnosis while warned: {name} ({share:.0%} of votes)")
    if conf_counts.sum():
        parts = []
        for grp, tag in ((0, "normal"), (1, "fault")):
            n, low = conf_counts[grp]
            if n:
                parts.append(f"{tag} {low / n:.1%} (n={n})")
        print(f"conformal anomaly rate (p≤{monitor.conformal_alpha:g}): " + "  ".join(parts))
        if conformal_gamma:
            a_t = monitor.stream_aci_alpha()
            print(f"adaptive conformal level after replay: α_t={a_t:.4f} "
                  f"(target α*={monitor.conformal_alpha:g}, γ="
                  f"{conformal_gamma:g}; α_t well below α* = the score "
                  f"distribution has shifted)")
    oob = monitor.stream_oob_counts()
    if oob.sum() > 0:
        # the replayed campaign left the checkpoint's training box on these
        # channels (the model extrapolated there)
        n = monitor.stream_n_seen()
        names = channel_names(len(oob))
        top = "  ".join(f"{nm} {c / n:.1%}"
                        for nm, c in sorted(zip(names, oob), key=lambda t: -t[1]) if c > 0)
        print(f"input-range drift (outside training box): {top}")
    if args.whatif and first["v_alarm"] is not None:
        # the minimal actuation whose predicted voltage gain covers the
        # measured shortfall below the stream's own dynamic alarm line
        # (uq/counterfactual gain mode; per condition: cli whatif)
        from pinnfc_tpu_torch.uq import counterfactual_recovery, summarize_recovery

        v_thr = float(monitor.state.v_first) - cfg.voltage_drop
        tail = np.arange(first["v_alarm"], len(rows))
        if len(tail) > 64:
            tail = tail[np.unique(np.linspace(0, len(tail) - 1, 64).round().astype(int))]
        try:
            rep = counterfactual_recovery(monitor.params, x_raw[tail].astype(np.float32), v_thr,
                                          monitor.scaler_x, monitor.scaler_y,
                                          v_meas=v_meas[tail], device=args.device)
        except _USER_ERRORS as e:
            print(f"monitor: {e}", file=sys.stderr)
            return 1
        s = summarize_recovery(rep)
        if s["dominant"] is None:
            print("suggested actuation: none (measured voltage already "
                  "recoverable at the line)")
        else:
            d_phys = float(s["mean_delta_phys"][s["dominant_index"]])
            print(f"suggested actuation (model-gain counterfactual over "
                  f"{len(tail)} alarmed rows): {s['dominant']} {d_phys:+.3g} "
                  f"→ {s['recovered_frac']:.0%} recover the alarm line")
    return 0


def _artifact_monitor(args, mu, sigma):
    """The monitor of ``serve --artifact``: the artifact's program moved to
    ``--device``, with the risk config, glitch threshold, class names, α*
    and γ its ``.meta.json`` sidecar recorded.  Returns (monitor, provenance)
    or an exit code."""
    import json

    from pinnfc_tpu_torch.config import RiskConfig, risk_config_from_dict
    from pinnfc_tpu_torch.serving import monitor_from_artifact

    artifact = args.artifact
    sidecar = None
    try:
        with open(artifact + ".meta.json") as f:
            sidecar = json.load(f)
    except (OSError, ValueError):
        print(f"note: no readable sidecar at {artifact}.meta.json — "
              "serving with default display config", file=sys.stderr)
    cfg = RiskConfig()
    side_glitch = class_names = provenance = side_conf_alpha = None
    side_gamma = 0.0
    if sidecar:
        kind = sidecar.get("kind")
        if kind == "pinnfc_monitor_step_stablehlo":
            print(f"{artifact} is a 'pinnfc_monitor_step_stablehlo' artifact of the JAX "
                  "package (StableHLO), which this package cannot run — export the "
                  "checkpoint again with this package's `export-model --monitor-step`",
                  file=sys.stderr)
            return 2
        if kind != "pinnfc_torch_monitor_step":
            print(f"{artifact} is a {kind!r} artifact — "
                  "serve needs an `export-model --monitor-step` one", file=sys.stderr)
            return 2
        if isinstance(sidecar.get("risk_config"), dict):
            cfg = risk_config_from_dict(sidecar["risk_config"])
        side_glitch = sidecar.get("glitch_alarm_n")
        class_names = sidecar.get("class_names")
        side_conf_alpha = sidecar.get("conformal_alpha")
        side_gamma = sidecar.get("conformal_gamma") or 0.0
        provenance = sidecar.get("checkpoint_meta") or None
        if provenance:
            provenance = {k: provenance[k] for k in ("created", "framework_version")
                          if k in provenance} or None
    with open(artifact, "rb") as f:
        blob = f.read()
    monitor = monitor_from_artifact(
        blob, mu, sigma, config=cfg,
        glitch_alarm_n=side_glitch if side_glitch is not None else _glitch_default(),
        class_names=class_names,
        conformal_alpha=(args.conformal_alpha if args.conformal_alpha is not None
                         else side_conf_alpha if side_conf_alpha is not None else 0.1),
        conformal_gamma=side_gamma, device=args.device,
    )
    print(f"serving from torch.export artifact {artifact}"
          + (" (conformal p-values baked in)" if monitor.conformal_baked else "")
          + (" (fleet step: /observe_many is one call)" if monitor.fleet_baked else ""))
    return monitor, provenance


def cmd_serve(args) -> int:
    """HTTP scoring endpoint: ``OnlineMonitor`` behind POST /observe
    (``serving/server.py``) on ``--device``.  The normal statistics come from
    the artifact ``--mat``, the model from a checkpoint (``--ckpt``, with an
    optional ``--head``) or from an ``export-model --monitor-step`` artifact
    (``--artifact``: no checkpoint and no model code; the baked risk config,
    glitch threshold, class names, α* and γ come from its sidecar).  The JAX
    command's argument errors (exit 2); an unreadable file exits 1."""
    from pinnfc_tpu_torch.config import RiskConfig
    from pinnfc_tpu_torch.data.contract import load_comprehensive_results
    from pinnfc_tpu_torch.risk import estimate_mu_sigma_normal
    from pinnfc_tpu_torch.serving import DiagnosisHead, OnlineMonitor, serve

    artifact = args.artifact
    if bool(artifact) == bool(args.ckpt):
        print("serve needs exactly one of --ckpt or --artifact", file=sys.stderr)
        return 2
    if artifact and args.head:
        print("--head is baked into a --monitor-step artifact at export "
              "time; it cannot be attached at serve time", file=sys.stderr)
        return 2
    if artifact and args.glitch_alarm_n is not None:
        print("--glitch-alarm-n is baked into the artifact's device "
              "recurrence at export time (`export-model --glitch-alarm-n`); "
              "passing it at serve time would silently have no effect", file=sys.stderr)
        return 2
    if artifact and args.conformal:
        print("--conformal calibration is baked into a --monitor-step "
              "artifact at export time (`export-model --conformal-mat`); "
              "it cannot be attached at serve time", file=sys.stderr)
        return 2
    if artifact and args.conformal_gamma is not None:
        print("--conformal-gamma is baked into the artifact's device "
              "recurrence at export time (`export-model --conformal-gamma`);"
              " passing it at serve time would silently have no effect", file=sys.stderr)
        return 2
    if not artifact and args.conformal_gamma and not args.conformal:
        print("--conformal-gamma needs --conformal (there is no p-value "
              "to adapt the level against)", file=sys.stderr)
        return 2
    if artifact and getattr(args, "data_parallel", False):
        print("--data-parallel needs the checkpoint path (an exported "
              "call cannot be vmapped across streams)", file=sys.stderr)
        return 2

    try:
        arr = load_comprehensive_results(args.mat).array
        mu, sigma = estimate_mu_sigma_normal(arr)
        if artifact:
            built = _artifact_monitor(args, mu, sigma)
            if isinstance(built, int):
                return built
            monitor, provenance = built
        else:
            head = DiagnosisHead.load(args.head, device=args.device) if args.head else None
            mesh = _fleet_mesh(args)
            provenance = _print_ckpt_provenance(args.ckpt)
            conformal_alpha = 0.1 if args.conformal_alpha is None else args.conformal_alpha
            conformal_calib = None
            if args.conformal:
                # normal-row |res| scores of the artifact the μ/σ come from
                conformal_calib = _streaming_conformal_calib(arr, conformal_alpha)
            monitor = OnlineMonitor.from_checkpoint(
                args.ckpt, mu, sigma, RiskConfig(), head,
                glitch_alarm_n=(args.glitch_alarm_n if args.glitch_alarm_n is not None
                                else _glitch_default()),
                conformal_calib=conformal_calib, conformal_alpha=conformal_alpha,
                conformal_gamma=args.conformal_gamma or 0.0, device=args.device, mesh=mesh,
            )
    except _USER_ERRORS as e:
        print(f"serve: {e}", file=sys.stderr)
        return 1
    serve(monitor, host=args.host, port=args.port, max_requests=args.max_requests,
          state_path=args.state_path, provenance=provenance)
    return 0
