"""simulate() — validate, compile, run, return a result handle; port of
`repro/api/run.py`.

Resolves the typed spec onto `SimulationEngine` (schema/policy enums ->
engine strings, sweep -> per-instance rate matrix, PER_POINT ->
instance group ids), attaches sinks, and drives the window loop through
the returned `SimulationResult`, so checkpoint/resume and partial runs
share one code path. Runs on the CUDA device unless the caller passes
`device="cpu"`; with no device and no GPU it raises. A multi-shard
`Partitioning` takes one device for every shard, or one per shard; a
`recovery` run is handed to `runtime.supervisor.RunSupervisor`.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.api.result import SimulationResult
from repro_torch.api.spec import Experiment, ExperimentError, Reduction
from repro_torch.core.engine import (
    SimConfig,
    SimulationEngine,
    resolve_observables,
)
from repro_torch.core.sweep import sweep_rates


def observable_names(model) -> list[str]:
    """The observable column names an Experiment on `model` reports
    (what a CsvSink wants), without building an engine."""
    return resolve_observables(model)[1]


def build_engine(experiment: Experiment, device=None) -> SimulationEngine:
    """Compile an Experiment down to a ready-to-run engine (no windows
    are run). Exposed for benchmarks; prefer simulate().

    device: one device (it holds every shard), a sequence of n_shards
    devices (shard k on entry k; entries may repeat), or None: the CUDA
    device, and under a multi-shard Partitioning shard k on cuda:k,
    refused when fewer cards are visible."""
    experiment.validate()
    ens = experiment.ensemble
    sched = experiment.schedule
    part = experiment.partitioning
    try:
        cfg = SimConfig(
            n_instances=ens.n_instances,
            t_end=float(sched.t_end),
            n_windows=sched.n_windows,
            n_lanes=min(experiment.n_lanes, ens.n_instances),
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
        engine = SimulationEngine(
            experiment.model, cfg, group_ids=group_ids,
            record_trajectories=experiment.record_trajectories,
            device=device, sketch=experiment.sketch,
            steering=experiment.steering)
    except ValueError as e:
        # engine-side config/table errors and device placement surface
        # in the API's vocabulary
        raise ExperimentError(str(e)) from e
    if ens.sweep is not None:
        try:
            rates = sweep_rates(engine.system, ens.sweep)
        except KeyError as e:
            raise ExperimentError(
                f"sweep names a rate the model does not define: {e}; "
                f"reactions are {list(engine.system.reaction_names)}"
            ) from e
        engine.set_rates(rates)
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
    refused alongside it.
    """
    if experiment.recovery is not None:
        if checkpoint_path or resume or max_windows is not None:
            raise ExperimentError(
                "Experiment.recovery owns checkpointing and drives the "
                "run to completion; drop checkpoint_path/resume/"
                "max_windows (set Recovery.ckpt_dir and cadence "
                "instead)")
        experiment.validate()  # refuses Recovery(workers > 1), item 16
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
