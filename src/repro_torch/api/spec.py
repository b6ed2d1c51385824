"""Typed experiment specification; port of `repro/api/spec.py`.

`Experiment`, `Ensemble` and `Schedule` keep the reference's field
names and defaults, so one spec literal builds in both packages. A
spec is pure data; `simulate()` compiles and runs it.

The one option whose machinery is not ported yet, the multi-process
farm (`Recovery(workers > 1)`), is refused by `validate()` with an
`ExperimentError` that names its ROADMAP queue-1 item; nothing is
silently ignored.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.cwc.rules import CWCModel
from repro_torch.core.reactions import ReactionSystem
from repro_torch.core.sweep import SweepSpec
from repro_torch.runtime.supervisor import Recovery
from repro_torch.stats.sketch import SketchSpec
from repro_torch.steer.policy import Steering

__all__ = [
    "Ensemble", "Experiment", "ExperimentError", "Method", "Partitioning",
    "Policy", "Recovery", "Reduction", "Schedule", "Schema", "SketchSpec",
    "Steering",
]


class ExperimentError(ValueError):
    """A spec failed validation; the message names the offending field."""


class _Coercible(Enum):
    @classmethod
    def coerce(cls, v):
        if isinstance(v, cls):
            return v
        for member in cls:
            if v in (member.value, member.name, member.name.lower()):
                return member
        raise ExperimentError(
            f"unknown {cls.__name__.lower()} {v!r}; expected one of "
            f"{[m.value for m in cls]}")


class Schema(_Coercible):
    """The paper's three parallelisation schemas (Fig. 5)."""

    STATIC_FARM = "i"       # static farm, post-hoc reduction
    TIME_SLICED = "ii"      # self-balancing farm, post-hoc reduction
    ONLINE = "iii"          # time-sliced farm + on-line windowed reduction


class Policy(_Coercible):
    """Lane-grouping policy for the scheduler."""

    STATIC_RR = "static_rr"
    ON_DEMAND = "on_demand"
    PREDICTIVE = "predictive"  # EMA-cost-sorted groups (§5.2 heuristics)


class Method(_Coercible):
    """The per-lane simulation algorithm: Gillespie's direct SSA, or
    adaptive tau-leaping with a per-lane exact fallback."""

    EXACT = "exact"
    TAU_LEAP = "tau_leap"


class Reduction(Enum):
    """What the per-window statistics aggregate over."""

    ENSEMBLE = "ensemble"    # pool every instance
    PER_POINT = "per_point"  # grouped per sweep point (paper §3.1.2)


@dataclass(frozen=True)
class Partitioning:
    """How the instance pool is partitioned over devices.

    n_shards: shards of the pool; shard k owns the contiguous instance
    block [k*I/K, (k+1)*I/K) on its own device (simulate's `device`).
    axis: the farm axis's name (the reference's mesh axis; kept so a
    spec literal builds in both packages).
    stat_blocks: contiguous blocks the per-window statistics reduce over
    (defaults to n_shards). Records depend on this number, never on the
    shard count, so pin it when comparing runs across shard counts or
    resuming a checkpoint on another shard count.
    """

    n_shards: int = 1
    axis: str = "data"
    stat_blocks: Optional[int] = None

    @property
    def blocks(self) -> int:
        return (self.stat_blocks if self.stat_blocks is not None
                else max(self.n_shards, 1))

    def validate(self, n_instances: int) -> None:
        if self.n_shards < 1:
            raise ValueError(
                f"Partitioning.n_shards must be >= 1, got {self.n_shards}")
        if not self.axis or not isinstance(self.axis, str):
            raise ValueError(
                f"Partitioning.axis must be a mesh axis name, "
                f"got {self.axis!r}")
        if n_instances % self.n_shards:
            raise ValueError(
                f"n_instances ({n_instances}) must divide evenly over "
                f"Partitioning.n_shards ({self.n_shards})")
        v = self.blocks
        if v < 1:
            raise ValueError(
                f"Partitioning.stat_blocks must be >= 1, got {v}")
        if v % self.n_shards:
            raise ValueError(
                f"Partitioning.stat_blocks ({v}) must be a multiple of "
                f"n_shards ({self.n_shards}) so each shard owns whole "
                "blocks")
        if n_instances % v:
            raise ValueError(
                f"n_instances ({n_instances}) must divide evenly into "
                f"Partitioning.stat_blocks ({v}) blocks")

    def degrade(self, n_instances: int, n_lost: int = 1) -> "Partitioning":
        """Elastic shard loss: the largest valid shard count d <=
        n_shards - n_lost (d divides n_instances and the block count; d
        = 1 always does, so any loss short of every device degrades).
        stat_blocks is pinned to this partitioning's block count, so a
        run resumed on the survivors stays bitwise the uninterrupted
        one."""
        if n_lost < 1:
            raise ValueError(f"n_lost must be >= 1, got {n_lost}")
        if n_lost >= self.n_shards:
            raise ValueError(
                f"cannot degrade: lost {n_lost} of {self.n_shards} "
                "shards (no survivors)")
        blocks = self.blocks
        target = self.n_shards - n_lost
        d = next(d for d in range(target, 0, -1)
                 if n_instances % d == 0 and blocks % d == 0)
        out = Partitioning(n_shards=d, axis=self.axis, stat_blocks=blocks)
        out.validate(n_instances)
        return out


@dataclass(frozen=True)
class Ensemble:
    """How many stochastic instances, and over which parameter points.
    `replicas` is the number of instances per sweep point (or the whole
    ensemble without a sweep); build one with `Ensemble.make`."""

    replicas: int = 1
    sweep: Optional[SweepSpec] = None

    @staticmethod
    def make(replicas: int = 1,
             sweep: Union[dict, SweepSpec, None] = None) -> "Ensemble":
        if isinstance(sweep, dict):
            sweep = SweepSpec.make(sweep, replicas)
        elif isinstance(sweep, SweepSpec):
            sweep = SweepSpec(sweep.values, replicas)
        return Ensemble(replicas=replicas, sweep=sweep)

    @property
    def n_points(self) -> int:
        return len(self.sweep.points()) if self.sweep else 1

    @property
    def n_instances(self) -> int:
        return self.n_points * self.replicas

    def group_ids(self) -> np.ndarray:
        """(I,) sweep-point id per instance (instance i -> point i//m)."""
        return np.repeat(np.arange(self.n_points, dtype=np.int32),
                         self.replicas)

    def validate(self) -> None:
        if self.replicas < 1:
            raise ExperimentError(
                f"Ensemble.replicas must be >= 1, got {self.replicas}")
        if self.sweep is not None:
            if self.sweep.replicas != self.replicas:
                raise ExperimentError(
                    f"Ensemble.replicas ({self.replicas}) disagrees with "
                    f"sweep.replicas ({self.sweep.replicas}); build via "
                    "Ensemble.make(replicas=..., sweep=...)")
            if not self.sweep.points():
                raise ExperimentError("sweep has no points (empty values)")
            for name, vals in self.sweep.values:
                if len(vals) == 0:
                    raise ExperimentError(
                        f"sweep axis {name!r} has no values")


@dataclass(frozen=True)
class Schedule:
    """The simulation-time grid and its parallelisation schema."""

    t_end: float
    n_windows: int
    schema: Schema = Schema.ONLINE
    policy: Policy = Policy.ON_DEMAND
    max_steps_per_window: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "schema", Schema.coerce(self.schema))
        object.__setattr__(self, "policy", Policy.coerce(self.policy))

    def validate(self) -> None:
        if not self.t_end > 0:
            raise ExperimentError(
                f"Schedule.t_end must be > 0, got {self.t_end}")
        if self.n_windows < 1:
            raise ExperimentError(
                f"Schedule.n_windows must be >= 1, got {self.n_windows}")
        if (self.schema is Schema.STATIC_FARM
                and self.policy is Policy.PREDICTIVE):
            raise ExperimentError(
                "schema STATIC_FARM (i) uses static round-robin groups; "
                "policy PREDICTIVE is only meaningful for time-sliced "
                "schemas (ii/iii)")
        if self.max_steps_per_window is not None \
                and self.max_steps_per_window < 1:
            raise ExperimentError(
                "Schedule.max_steps_per_window must be >= 1 or None, "
                f"got {self.max_steps_per_window}")


@dataclass(frozen=True)
class Experiment:
    """One fully-specified ensemble simulation (the reference's fields
    and defaults).

    use_kernel: advance each window through a fused CUDA kernel (exact
    SSA or tau-leaping, dense or sparse) — one launch per window,
    bitwise identical to the unfused path.
    kernel_chunk_steps / kernel_max_chunks: the kernel path's per-window
    event budget (chunk_steps * max_chunks events per lane); a window
    needing more raises FusedWindowTruncated.
    sinks: callables receiving each StatsRecord; anything with close()
    is closed when the run completes.
    record_trajectories: buffer raw per-window samples under schema
    ONLINE too.
    sparse: the sparse exact step — dependency-graph propensity updates
    over padded sparse tables, for networks of hundreds of species and
    reactions and for any reactant coefficient; bitwise identical to
    the dense step where both run.
    method: Method.EXACT (Gillespie's direct SSA) or Method.TAU_LEAP
    (adaptive tau-leaping; tau_eps bounds each leap's relative
    propensity drift, tau_fallback is the fewest expected events a leap
    must cover, else the lane takes one exact step). Both run dense or
    sparse, through the kernels or the unfused loop.

    host_loop: the reference's per-group gather/advance/scatter
    baseline (one kernel launch per group and window with use_kernel).
    window_block: supersteps — this many windows queued as one dispatch
    with one host sync per block; pipeline_depth: blocks kept in flight
    (an int >= 1, or "auto" to probe). Records are bitwise identical
    for any window_block and pipeline_depth.

    sketch: a SketchSpec — per-window histograms and rare-event counts
    per (sweep point, observable) (`SimulationResult.sketches`).
    steering: a Steering spec — the between-block controller
    (early-stop, reallocation, tau-switch, bimodality flags;
    `SimulationResult.steering_report`). Steered runs advance in
    lock-step blocks, even at window_block=1.

    partitioning: a Partitioning — the pool in n_shards contiguous
    shards, each on its own device, the statistics over stat_blocks
    blocks; records are bitwise the same for any shard count dividing
    stat_blocks.
    recovery: a Recovery — supervised runs (cadenced checkpoints,
    restart on a fault, elastic shard loss, fault drills;
    `SimulationResult.recovery_report`). Recovery(workers > 1), the
    multi-process farm, is not ported yet and is refused by validate().
    """

    model: Union[CWCModel, ReactionSystem]
    ensemble: Ensemble
    schedule: Schedule
    reduction: Reduction = Reduction.ENSEMBLE
    sinks: Sequence = ()
    seed: int = 0
    n_lanes: int = 128
    record_trajectories: bool = False
    use_kernel: bool = False
    kernel_chunk_steps: int = 256
    kernel_max_chunks: int = 64
    host_loop: bool = False
    partitioning: Optional[Partitioning] = None
    method: Method = Method.EXACT
    tau_eps: float = 0.03
    tau_fallback: float = 10.0
    window_block: int = 1
    pipeline_depth: Union[int, str] = 1
    sparse: bool = False
    sketch: Optional[SketchSpec] = None
    steering: Optional[Steering] = None
    recovery: Optional[Recovery] = None

    def __post_init__(self):
        object.__setattr__(self, "method", Method.coerce(self.method))

    def validate(self) -> None:
        if not isinstance(self.model, (CWCModel, ReactionSystem)):
            raise ExperimentError(
                "Experiment.model must be a CWCModel or ReactionSystem, "
                f"got {type(self.model).__name__}")
        if not isinstance(self.ensemble, Ensemble):
            raise ExperimentError(
                "Experiment.ensemble must be an Ensemble "
                f"(got {type(self.ensemble).__name__}); wrap a SweepSpec "
                "via Ensemble.make(replicas=..., sweep=...)")
        if not isinstance(self.schedule, Schedule):
            raise ExperimentError(
                "Experiment.schedule must be a Schedule, "
                f"got {type(self.schedule).__name__}")
        self.ensemble.validate()
        self.schedule.validate()
        if not isinstance(self.reduction, Reduction):
            raise ExperimentError(
                f"Experiment.reduction must be a Reduction enum, "
                f"got {self.reduction!r}")
        if self.n_lanes < 1:
            raise ExperimentError(
                f"Experiment.n_lanes must be >= 1, got {self.n_lanes}")
        if self.use_kernel and self.schedule.max_steps_per_window:
            raise ExperimentError(
                "max_steps_per_window is not honoured by the fused "
                "kernel path (use_kernel=True); drop one of them")
        for name in ("kernel_chunk_steps", "kernel_max_chunks",
                     "window_block"):
            if getattr(self, name) < 1:
                raise ExperimentError(
                    f"Experiment.{name} must be >= 1, got "
                    f"{getattr(self, name)}")
        if self.window_block > 1 and self.host_loop:
            raise ExperimentError(
                "window_block > 1 needs the fused or sharded dispatch "
                "strategy; host_loop is the per-window round-trip "
                "baseline (set window_block=1)")
        if isinstance(self.pipeline_depth, str):
            if self.pipeline_depth != "auto":
                raise ExperimentError(
                    f"Experiment.pipeline_depth must be an int >= 1 or "
                    f"'auto', got {self.pipeline_depth!r}")
        elif (not isinstance(self.pipeline_depth, int)
                or self.pipeline_depth < 1):
            raise ExperimentError(
                f"Experiment.pipeline_depth must be an int >= 1 or "
                f"'auto', got {self.pipeline_depth!r}")
        if not self.tau_eps > 0:
            raise ExperimentError(
                f"Experiment.tau_eps must be > 0, got {self.tau_eps}")
        if self.tau_fallback < 0:
            raise ExperimentError(
                f"Experiment.tau_fallback must be >= 0, got "
                f"{self.tau_fallback}")
        if self.partitioning is not None:
            if not isinstance(self.partitioning, Partitioning):
                raise ExperimentError(
                    "Experiment.partitioning must be a Partitioning, "
                    f"got {type(self.partitioning).__name__}")
            try:
                self.partitioning.validate(self.ensemble.n_instances)
            except ValueError as e:
                raise ExperimentError(str(e)) from e
        self._validate_steering()
        if self.recovery is not None:
            if not isinstance(self.recovery, Recovery):
                raise ExperimentError(
                    "Experiment.recovery must be a Recovery, "
                    f"got {type(self.recovery).__name__}")
            try:
                self.recovery.validate()
            except ValueError as e:
                raise ExperimentError(str(e)) from e
        for s in self.sinks:
            if not callable(s):
                raise ExperimentError(f"sink {s!r} is not callable")
        self._refuse_unported()

    def _validate_steering(self) -> None:
        """The sketch and steering fields, checked as the reference
        checks them: their types, their own validate(), and the four
        conflicts of an enabled steering spec (`Steering.check_run`,
        which the engine calls too)."""
        if self.sketch is not None:
            if not isinstance(self.sketch, SketchSpec):
                raise ExperimentError(
                    "Experiment.sketch must be a SketchSpec, "
                    f"got {type(self.sketch).__name__}")
            try:
                self.sketch.validate()
            except ValueError as e:
                raise ExperimentError(str(e)) from e
        if self.steering is None:
            return
        if not isinstance(self.steering, Steering):
            raise ExperimentError(
                "Experiment.steering must be a Steering, "
                f"got {type(self.steering).__name__}")
        try:
            self.steering.check_run(
                host_loop=self.host_loop, sketched=self.sketch is not None,
                tau_leap=self.method is Method.TAU_LEAP,
                pipeline_depth=self.pipeline_depth)
        except ValueError as e:
            raise ExperimentError(str(e)) from e

    def _refuse_unported(self) -> None:
        """Options whose machinery the port does not have yet, each
        with its ROADMAP queue-1 item."""
        unported = [
            (self.recovery is not None and self.recovery.workers > 1,
             "recovery with workers > 1",
             "item 16, the multi-process farm"),
        ]
        for hit, what, item in unported:
            if hit:
                raise ExperimentError(
                    f"Experiment {what} is not ported to repro_torch yet "
                    f"(ROADMAP queue 1, {item})")

    def with_(self, **changes) -> "Experiment":
        return dataclasses.replace(self, **changes)
