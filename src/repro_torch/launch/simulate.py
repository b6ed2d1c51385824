"""The simulate command line — the paper's tool over repro_torch.api;
port of `repro/launch/simulate.py`, with every flag of the reference's
and `--device`.

  PYTHONPATH=src python -m repro_torch.launch.simulate --model ecoli \
      --instances 100 --t-end 50 --windows 100 --schema iii \
      --out ecoli_stats.csv

Parameter sweeps ride the same entry point:

  ... --model lv2 --sweep die=0.3,0.6,1.2 --replicas 32 --per-point

It runs on the CUDA device unless `--device` names another (`cpu`,
`cuda`, `cuda:k`), as `simulate(device=)` does. `--devices N` runs N
shards, on cuda:0..N-1 (refused with fewer cards), or all on
`--device`. `--workers N --recover-dir DIR` runs the multi-process farm;
its workers run on `--device`, or on the cards in turn.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.api import (
    CsvSink,
    Ensemble,
    Experiment,
    Method,
    Partitioning,
    Policy,
    Reduction,
    Schedule,
    Schema,
    SketchSpec,
    Steering,
    simulate,
)
from repro_torch.core.cwc.models import MODELS


def _parse_sweep(specs: list[str]) -> dict:
    """["die=0.3,0.6", "grow=1,2"] -> {"die": [...], "grow": [...]}."""
    out = {}
    for s in specs:
        name, _, vals = s.partition("=")
        if not vals:
            raise SystemExit(f"--sweep expects name=v1,v2,... got {s!r}")
        out[name] = [float(v) for v in vals.split(",")]
    return out


def _parse_depth(s: str):
    """--pipeline-depth operand: 'auto' or a positive int."""
    if s == "auto":
        return s
    try:
        return int(s)
    except ValueError:
        raise SystemExit(
            f"--pipeline-depth expects a positive int or 'auto', got {s!r}"
        ) from None


def straggler_line(rows, rate: float) -> str:
    """The run's straggler summary: the first five of `rows`, each a
    window's (window, wall s, rolling median s) or a farm worker's
    ("frontier", worker, frontier window, median frontier), as the
    coordinator adds them. The reference's line unpacks three values
    from every row and so raises on a frontier row; a window row prints
    as its does."""
    def row(r):
        if r[0] == "frontier":
            return f"worker {r[1]} at window {r[2]} vs median {r[3]:g}"
        return f"w{r[0]} {r[1] * 1e3:.0f}ms vs median {r[2] * 1e3:.0f}ms"

    return (f"stragglers: {len(rows)} window(s) flagged (rate {rate:.2f}): "
            + ", ".join(row(r) for r in rows[:5]))


def main(argv=None) -> None:
    """Parse `argv` (default: the process's arguments) and run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=list(MODELS), default="lv2")
    ap.add_argument("--instances", type=int, default=100,
                    help="ensemble size (replicas per point with --sweep)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="alias for --instances (sweep wording)")
    ap.add_argument("--sweep", action="append", default=[],
                    metavar="NAME=V1,V2,...",
                    help="full-factorial rate sweep; repeatable")
    ap.add_argument("--per-point", action="store_true",
                    help="grouped per-sweep-point reduction")
    ap.add_argument("--t-end", type=float, default=10.0)
    ap.add_argument("--windows", type=int, default=50)
    ap.add_argument("--lanes", type=int, default=128)
    ap.add_argument("--schema", choices=["i", "ii", "iii"], default="iii")
    ap.add_argument("--policy", choices=["static_rr", "on_demand",
                                         "predictive"], default="on_demand")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--method", choices=["exact", "tau_leap"],
                    default="exact",
                    help="per-lane algorithm: exact Gillespie SSA or "
                    "adaptive tau-leaping (Poisson bundles of events "
                    "per Cao-bounded leap, per-lane exact fallback)")
    ap.add_argument("--tau-eps", type=float, default=0.03,
                    help="tau-leap Cao drift bound (bigger = longer "
                    "leaps, coarser approximation)")
    ap.add_argument("--tau-fallback", type=float, default=10.0,
                    help="leap only when it covers at least this many "
                    "expected SSA events; below it the lane takes an "
                    "exact step")
    ap.add_argument("--kernel", action="store_true",
                    help="use the hand-written CUDA window kernel (one "
                    "launch per window; its plain twin on the CPU)")
    ap.add_argument("--window-block", type=int, default=1,
                    help="superstep width: fuse this many windows into "
                    "one device dispatch with an async pipelined "
                    "record pull (amortises dispatches and host syncs "
                    "to 1/N per window; records are bit-identical for "
                    "any value; incompatible with --host-loop)")
    ap.add_argument("--pipeline-depth", default="1", metavar="K",
                    help="superstep pipeline depth: keep K dispatched "
                    "window blocks in flight before the collector "
                    "blocks on the oldest record ring (default 1, the "
                    "double-buffer), or 'auto' to profile the first "
                    "collected block's pull-vs-host-reduce walls and "
                    "pick a depth; records are bit-identical for any "
                    "value (only WHEN rings are pulled changes)")
    ap.add_argument("--sparse", action="store_true",
                    help="sparse large-network engine: CSR reactant "
                    "tables + reaction dependency graph, O(out-degree) "
                    "propensity updates per event instead of O(R); "
                    "bitwise identical to the dense encoding and "
                    "required for stoichiometric coefficients > 4")
    ap.add_argument("--host-loop", action="store_true",
                    help="legacy per-group dispatch (benchmark baseline)")
    ap.add_argument("--device", default=None,
                    help="where to run: cpu, cuda or cuda:k (default: "
                    "the CUDA device; refused without one)")
    ap.add_argument("--devices", type=int, default=None,
                    help="shard the instance pool over N shards, shard k "
                    "on cuda:k (or every shard on --device); N must "
                    "divide the ensemble size")
    ap.add_argument("--stat-blocks", type=int, default=None,
                    help="virtual blocks the per-window statistics "
                    "reduce over (default: --devices); pin it to keep "
                    "records bit-identical across device counts")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint file: written per window, resumed "
                    "from when it already exists (mutually exclusive "
                    "with --recover-dir)")
    ap.add_argument("--recover-dir", default=None, metavar="DIR",
                    help="supervised self-healing run (RunSupervisor): "
                    "cadenced atomic checkpoints under DIR, bounded-"
                    "backoff restart from the newest valid snapshot on "
                    "any recoverable fault, elastic shard-loss "
                    "degradation; mutually exclusive with --ckpt")
    ap.add_argument("--ckpt-every", type=int, default=1, metavar="N",
                    help="supervised checkpoint cadence in windows "
                    "(rounded up to a multiple of --window-block)")
    ap.add_argument("--keep-last", type=int, default=3, metavar="K",
                    help="supervised checkpoint retention depth; >= 2 "
                    "keeps a fallback behind a corrupt newest file")
    ap.add_argument("--max-restarts", type=int, default=8,
                    help="recoveries before the run is declared dead")
    ap.add_argument("--workers", type=int, default=1, metavar="N",
                    help="multi-process elastic farm (needs "
                    "--recover-dir): shard the ensemble over N worker "
                    "processes under a coordinator that heartbeat-"
                    "supervises, restarts, and — past the restart "
                    "budget — reassigns dead workers' shards; results "
                    "merge bitwise vs the single-process run")
    ap.add_argument("--heartbeat-s", type=float, default=2.0,
                    help="farm worker heartbeat interval; stale for "
                    "3x this = stalled worker (killed + restarted)")
    ap.add_argument("--max-worker-restarts", type=int, default=2,
                    help="per-worker restart budget; past it the "
                    "worker is retired and its shard reassigned to a "
                    "survivor")
    ap.add_argument("--redispatch-stragglers", action="store_true",
                    help="escalate watchdog breaches into a supervised "
                    "re-dispatch of the offending block (one retry per "
                    "window; replay is bitwise)")
    ap.add_argument("--inject", action="append", default=[],
                    metavar="W:KIND",
                    help="fault drill: inject KIND (crash|device_lost|"
                    "ckpt_corrupt|stall|nan_pool) before window W; "
                    "repeatable (needs --recover-dir)")
    ap.add_argument("--inject-rate", type=float, default=0.0,
                    help="fault drill: seeded per-window crash "
                    "probability on top of --inject")
    ap.add_argument("--inject-seed", type=int, default=0,
                    help="seed for --inject-rate draws (same seed = "
                    "same fault schedule)")
    ap.add_argument("--sketch-bins", type=int, default=0,
                    help="stream per-window fixed-bin histograms with "
                    "this many bins per (point, observable); p10/p50/"
                    "p90 estimates print at the end (0 = off)")
    ap.add_argument("--sketch-threshold", action="append", default=[],
                    type=float, metavar="LEVEL",
                    help="rare-event counter: instances with obs >= "
                    "LEVEL per window; repeatable (needs --sketch-bins)")
    ap.add_argument("--early-stop", type=float, default=0.0,
                    metavar="REL_CI",
                    help="steering: stop a sweep point once every "
                    "observable's ci90/|mean| falls below REL_CI "
                    "(0 = off)")
    ap.add_argument("--steer-min-windows", type=int, default=4,
                    help="never early-stop a point before this many "
                    "windows")
    ap.add_argument("--reallocate", action="store_true",
                    help="steering: move a stopped point's freed lanes "
                    "to the live point with the worst relative CI "
                    "(needs --early-stop)")
    ap.add_argument("--tau-switch", action="store_true",
                    help="steering: pin lanes whose EMA leap share "
                    "stays low to exact SSA (tau_leap runs only)")
    ap.add_argument("--flag-bimodal", action="store_true",
                    help="steering: flag bimodal (point, observable) "
                    "histograms (needs --sketch-bins)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    replicas = args.replicas if args.replicas is not None else args.instances
    model = MODELS[args.model]()
    experiment = Experiment(
        model=model,
        ensemble=Ensemble.make(replicas=replicas,
                               sweep=_parse_sweep(args.sweep) or None),
        schedule=Schedule(t_end=args.t_end, n_windows=args.windows,
                          schema=Schema.coerce(args.schema),
                          policy=Policy.coerce(args.policy)),
        reduction=(Reduction.PER_POINT if args.per_point
                   else Reduction.ENSEMBLE),
        seed=args.seed,
        n_lanes=args.lanes,
        method=Method.coerce(args.method),
        tau_eps=args.tau_eps,
        tau_fallback=args.tau_fallback,
        use_kernel=args.kernel,
        host_loop=args.host_loop,
        window_block=args.window_block,
        pipeline_depth=_parse_depth(args.pipeline_depth),
        sparse=args.sparse,
        partitioning=(Partitioning(n_shards=args.devices,
                                   stat_blocks=args.stat_blocks)
                      if args.devices else None),
        sketch=(SketchSpec(n_bins=args.sketch_bins,
                           thresholds=tuple(args.sketch_threshold))
                if args.sketch_bins else None),
        steering=(Steering(ci_rel_tol=args.early_stop,
                           min_windows=args.steer_min_windows,
                           reallocate=args.reallocate,
                           tau_switch=args.tau_switch,
                           bimodality=args.flag_bimodal)
                  if (args.early_stop or args.tau_switch
                      or args.flag_bimodal) else None))

    if args.recover_dir:
        if args.ckpt:
            raise SystemExit("--recover-dir owns checkpointing; drop "
                             "--ckpt")
        from repro_torch.api import Recovery
        from repro_torch.runtime.fault import FAULT_KINDS, FailurePlan

        schedule = {}
        for spec in args.inject:
            w, _, kind = spec.partition(":")
            if not w.isdigit() or kind not in FAULT_KINDS:
                raise SystemExit(
                    f"--inject expects W:KIND with KIND in "
                    f"{FAULT_KINDS}, got {spec!r}")
            schedule[int(w)] = kind
        plan = (FailurePlan(schedule=schedule, seed=args.inject_seed,
                            random_rate=args.inject_rate)
                if (schedule or args.inject_rate) else None)
        experiment = experiment.with_(recovery=Recovery(
            ckpt_dir=args.recover_dir, cadence=args.ckpt_every,
            keep_last=args.keep_last, max_restarts=args.max_restarts,
            redispatch_stragglers=args.redispatch_stragglers,
            workers=args.workers, heartbeat_s=args.heartbeat_s,
            max_worker_restarts=args.max_worker_restarts,
            inject=plan))
    elif args.workers > 1:
        raise SystemExit("--workers needs --recover-dir (the farm's "
                         "shared checkpoint directory)")

    if args.out:
        from repro_torch.api.run import observable_names

        experiment = experiment.with_(
            sinks=(CsvSink(args.out, observable_names(model)),))

    resume = bool(args.ckpt) and os.path.exists(
        args.ckpt if args.ckpt.endswith(".npz") else args.ckpt + ".npz")
    if resume:
        print(f"resuming from {args.ckpt}")
    result = simulate(experiment, device=args.device,
                      checkpoint_path=args.ckpt, resume=resume)

    tele = result.telemetry
    print(f"model={model.name} schema={args.schema} "
          f"method={args.method} "
          f"instances={experiment.ensemble.n_instances} "
          f"windows={len(result.records)} "
          f"wall={tele.wall_time_s:.2f}s "
          f"dispatches={tele.dispatches} host_syncs={tele.host_syncs} "
          f"peak_buffered={tele.peak_buffered_bytes}B")
    if args.method == "tau_leap":
        steps = sum(tele.steps_per_window)
        leaps = sum(tele.leaps_per_window)
        print(f"  tau-leap: {steps} solver steps = {leaps} leaps + "
              f"{steps - leaps} exact-fallback events")
    last = result.records[-1]
    for name, m, v, ci in zip(result.obs_names, last.mean, last.var,
                              last.ci90):
        print(f"  {name:24s} mean={m:10.2f} var={v:12.2f} ci90=±{ci:.3f}")
    pp = result.per_point()
    if pp is not None and len(pp["points"]) > 1:
        print("per-sweep-point final means:")
        for p, point in enumerate(pp["points"]):
            vals = " ".join(f"{name}={m:.1f}" for name, m in
                            zip(result.obs_names, pp["mean"][-1, p]))
            print(f"  {point}: {vals}")
    if tele.straggler_windows:
        print(straggler_line(tele.straggler_windows, tele.straggler_rate))
    sks = result.sketches()
    if sks:
        from repro_torch.stats import quantiles_from_hist

        sk_params = result._engine._sketch
        q = quantiles_from_hist(sks[-1].hist, sk_params.lo,
                                sk_params.width)
        print("final-window quantile estimates (p10/p50/p90):")
        for g in range(q.shape[0]):
            for o, name in enumerate(result.obs_names):
                tag = f"point {g} " if q.shape[0] > 1 else ""
                print(f"  {tag}{name:20s} "
                      f"{q[g, o, 0]:8.1f} {q[g, o, 1]:8.1f} "
                      f"{q[g, o, 2]:8.1f}")
    rep = result.steering_report()
    if rep is not None:
        print(f"steering: {len(rep['stopped_points'])}/{rep['n_points']}"
              f" points early-stopped, "
              f"{rep['point_windows_simulated']}/"
              f"{rep['point_windows_total']} point-windows simulated "
              f"({rep['windows_saved_ratio']:.2f}x saved), "
              f"{rep['lanes_pinned_exact']} lanes pinned exact, "
              f"{len(rep['bimodal_flags'])} bimodal flags")
        for d in rep["decisions"]:
            print(f"  w{d['window']}: {d}")
    rec = result.recovery_report()
    if rec is not None and "workers" in rec:  # farm coordinator report
        print(f"farm: {rec['workers']} workers, {rec['restarts']} "
              f"worker restart(s), {rec['reassignments']} shard "
              f"reassignment(s), faults={rec['faults_by_kind'] or '{}'}")
        for w, pw in rec["per_worker"].items():
            tag = " RETIRED" if pw["retired"] else ""
            print(f"  worker {w}: {pw['restarts']} restart(s), shards "
                  f"{pw['shards_run']}{tag}")
        for ev in rec["events"]:
            if ev["event"] in ("fault_injected", "fault",
                               "worker_retired", "shard_reassigned"):
                print(f"  {ev}")
    elif rec is not None:
        print(f"recovery: {rec['restarts']} restart(s), faults="
              f"{rec['faults_by_kind'] or '{}'}"
              + (f", degraded to {rec['final_n_shards']} shard(s)"
                 if rec["final_n_shards"] is not None else ""))
        for ev in rec["events"]:
            if ev["event"] in ("fault_injected", "fault", "degraded",
                               "corrupt_checkpoint_skipped"):
                print(f"  {ev}")


if __name__ == "__main__":
    main()
