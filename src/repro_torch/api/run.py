"""simulate() — validate, compile, run, return a result handle; port of
`repro/api/run.py`.

Resolves the typed spec onto `SimulationEngine` (schema/policy enums ->
engine strings, sweep -> per-instance rate matrix, PER_POINT ->
instance group ids), attaches sinks, and drives the window loop through
the returned `SimulationResult`, so checkpoint/resume and partial runs
share one code path. Runs on the CUDA device unless the caller passes
`device="cpu"`; with no device and no GPU it raises. A multi-shard
`Partitioning` takes one device for every shard, or one per shard; a
`recovery` run is handed to `runtime.supervisor.RunSupervisor`, or,
with `Recovery(workers > 1)`, to the multi-process farm
(`runtime.coordinator.FarmCoordinator`).
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.api.result import SimulationResult
from repro_torch.api.spec import (
    Experiment,
    ExperimentError,
    Partitioning,
    Reduction,
)
from repro_torch.core.engine import (
    SimConfig,
    SimulationEngine,
    resolve_observables,
)
from repro_torch.core.stream import lane_keys
from repro_torch.core.sweep import sweep_rates


def observable_names(model) -> list[str]:
    """The observable column names an Experiment on `model` reports
    (what a CsvSink wants), without building an engine."""
    return resolve_observables(model)[1]


def build_engine(experiment: Experiment, device=None,
                 shard=None) -> SimulationEngine:
    """Compile an Experiment down to a ready-to-run engine (no windows
    are run). Exposed for benchmarks; prefer simulate().

    device: one device (it holds every shard), a sequence of n_shards
    devices (shard k on entry k; entries may repeat), or None: the CUDA
    device, and under a multi-shard Partitioning shard k on cuda:k,
    refused when fewer cards are visible.

    shard=(lo, hi, stat_blocks) is the farm worker's seam
    (runtime/worker.py): the engine covers only the instance rows
    [lo, hi) of the GLOBAL ensemble, with the same seed, the rates and
    group ids sliced to the range and the lanes' key rows taken from
    the GLOBAL key table, so each lane's counter-based stream is the
    one the single-process run gives it. stat_blocks is the worker's
    share of the global Welford blocks (contiguous, so the worker's
    blocks ARE global blocks)."""
    experiment.validate()
    ens = experiment.ensemble
    sched = experiment.schedule
    part = experiment.partitioning
    lo, hi = (0, ens.n_instances) if shard is None else shard[:2]
    if shard is not None:
        part = Partitioning(n_shards=1, stat_blocks=shard[2])
    try:
        cfg = SimConfig(
            n_instances=hi - lo,
            t_end=float(sched.t_end),
            n_windows=sched.n_windows,
            n_lanes=min(experiment.n_lanes, hi - lo),
            schema=sched.schema.value,
            policy=sched.policy.value,
            seed=experiment.seed,
            max_steps_per_window=sched.max_steps_per_window,
            use_kernel=experiment.use_kernel,
            host_loop=experiment.host_loop,
            sparse=experiment.sparse,
            kernel_chunk_steps=experiment.kernel_chunk_steps,
            kernel_max_chunks=experiment.kernel_max_chunks,
            stat_blocks=part.blocks if part is not None else 1,
            n_shards=part.n_shards if part is not None else 1,
            method=experiment.method.value,
            tau_eps=float(experiment.tau_eps),
            tau_fallback=float(experiment.tau_fallback),
            window_block=experiment.window_block,
            pipeline_depth=experiment.pipeline_depth)
        group_ids = (ens.group_ids()
                     if experiment.reduction is Reduction.PER_POINT
                     else None)
        if group_ids is not None and shard is not None:
            # points are contiguous runs of replicas, so the slice holds
            # whole points; rebased to 0, the worker's grouped rows are
            # its local points (global index = local + base)
            group_ids = group_ids[lo:hi] - group_ids[lo]
        engine = SimulationEngine(
            experiment.model, cfg, group_ids=group_ids,
            record_trajectories=experiment.record_trajectories,
            device=device, sketch=experiment.sketch,
            steering=experiment.steering)
    except ValueError as e:
        # engine-side config/table errors and device placement surface
        # in the API's vocabulary
        raise ExperimentError(str(e)) from e
    if shard is not None:
        # the rows of the global table `init_lanes` builds for the whole
        # ensemble
        keys = lane_keys(experiment.seed, ens.n_instances,
                         device=engine.device)[lo:hi].clone()
        engine._pool = engine._pool._replace(key=keys)
        if group_ids is not None:
            # this shard's place in the GLOBAL (V, G) stats layout: shards
            # are contiguous and blocks uniform, so the worker's blocks
            # and points ARE global ones at an offset
            bs = (hi - lo) // shard[2]
            engine.set_global_stats_layout(
                v_total=ens.n_instances // bs, v0=lo // bs,
                g_total=ens.n_points, g0=lo // ens.replicas)
    if ens.sweep is not None:
        try:
            rates = sweep_rates(engine.system, ens.sweep)
        except KeyError as e:
            raise ExperimentError(
                f"sweep names a rate the model does not define: {e}; "
                f"reactions are {list(engine.system.reaction_names)}"
            ) from e
        engine.set_rates(rates[lo:hi])
    return engine


def simulate(experiment: Experiment, *, device=None,
             max_windows: Optional[int] = None,
             checkpoint_path: Optional[str] = None,
             resume: bool = False) -> SimulationResult:
    """Run an Experiment end to end on `device` (default: the CUDA
    device; raises when there is none).

    checkpoint_path: checkpoint after every window (every collected
    block under supersteps), and the restore source when resume=True.
    resume: restore pool/records from checkpoint_path before running —
    the file must exist, and may come from either package; records
    emitted before the checkpoint are replayed into the result buffer
    AND into this run's sinks (a fresh CsvSink starts from an empty
    file, so the replay keeps it complete).
    max_windows: stop after this many windows; the returned handle's
    `.resume()` continues the same run in-process.
    device: as for build_engine.

    With `experiment.recovery` set, the run is handed to
    `runtime.supervisor.RunSupervisor` (cadenced checkpoints, restart on
    a fault, elastic shard loss), which owns checkpointing and drives
    the run to its end, so checkpoint_path, resume and max_windows are
    refused alongside it. With `Recovery(workers=K > 1)` it is handed to
    `runtime.coordinator.FarmCoordinator`: K worker processes, each a
    RunSupervisor over a contiguous shard, merged bit for bit; `device`
    then places the workers (None: worker k on cuda:(k mod cards)).
    """
    if experiment.recovery is not None:
        if checkpoint_path or resume or max_windows is not None:
            raise ExperimentError(
                "Experiment.recovery owns checkpointing and drives the "
                "run to completion; drop checkpoint_path/resume/"
                "max_windows (set Recovery.ckpt_dir and cadence "
                "instead)")
        # the spec's own checks first: a bad Recovery (or a farm the
        # bitwise merge cannot serve) is an ExperimentError
        experiment.validate()
        if experiment.recovery.workers > 1:
            # the multi-process farm: a coordinator shards the ensemble
            # over worker processes and merges their results bitwise
            from repro_torch.runtime.coordinator import FarmCoordinator

            return FarmCoordinator(experiment, experiment.recovery,
                                   device=device).run()
        from repro_torch.runtime.supervisor import RunSupervisor

        return RunSupervisor(experiment, experiment.recovery,
                             device=device).run()
    engine = build_engine(experiment, device=device)
    if resume:
        if not checkpoint_path:
            raise ExperimentError("resume=True requires checkpoint_path")
        path = (checkpoint_path if checkpoint_path.endswith(".npz")
                else checkpoint_path + ".npz")
        if not os.path.exists(path):
            raise ExperimentError(
                f"resume=True but no checkpoint at {path!r}")
        try:
            engine.restore(checkpoint_path)
        except ValueError as e:
            # e.g. a mid-block checkpoint under window_block > 1
            raise ExperimentError(str(e)) from e
    for sink in experiment.sinks:
        engine.stream.attach(sink)
        for rec in engine.stream.records():  # replay restored windows
            sink(rec)
    return SimulationResult(experiment, engine).resume(
        max_windows=max_windows, checkpoint_path=checkpoint_path)
