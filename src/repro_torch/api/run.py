"""simulate() — validate, compile, run, return a result handle; port of
`repro/api/run.py`.

Resolves the typed spec onto `SimulationEngine` (schema/policy enums ->
engine strings, sweep -> per-instance rate matrix, PER_POINT ->
instance group ids), attaches sinks, and drives the window loop through
the returned `SimulationResult`. Runs on the CUDA device unless the
caller passes `device="cpu"`; with no device and no GPU it raises.
"""
from __future__ import annotations

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
    are run). Exposed for benchmarks; prefer simulate()."""
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
            sparse=experiment.sparse,
            kernel_chunk_steps=experiment.kernel_chunk_steps,
            kernel_max_chunks=experiment.kernel_max_chunks,
            stat_blocks=part.blocks if part is not None else 1,
            method=experiment.method.value,
            tau_eps=float(experiment.tau_eps),
            tau_fallback=float(experiment.tau_fallback))
        group_ids = (ens.group_ids()
                     if experiment.reduction is Reduction.PER_POINT
                     else None)
        engine = SimulationEngine(
            experiment.model, cfg, group_ids=group_ids,
            record_trajectories=experiment.record_trajectories,
            device=device)
    except ValueError as e:
        # engine-side config/table errors surface in the API's vocabulary
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
    device; raises when there is none). `max_windows` stops after that
    many windows; the returned handle's `.resume()` continues the run
    in-process. Checkpoints (`checkpoint_path`, `resume`) are not ported
    yet and raise."""
    if checkpoint_path or resume:
        raise ExperimentError(
            "checkpoint_path / resume are not ported to repro_torch yet "
            "(ROADMAP queue 1, item 8, checkpoints)")
    engine = build_engine(experiment, device=device)
    for sink in experiment.sinks:
        engine.stream.attach(sink)
    return SimulationResult(experiment, engine).resume(
        max_windows=max_windows)
