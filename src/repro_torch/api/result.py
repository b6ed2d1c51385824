"""SimulationResult — the handle `simulate()` returns; port of
`repro/api/result.py`.

Wraps the running (or finished) engine: streamed records, per-sweep-
point grouped statistics, raw trajectories, sketches, the steering
report, a supervised run's recovery report and telemetry. The handle
owns the run loop, so a run cut by `max_windows=` continues in-process
with `.resume()`.
"""
from __future__ import annotations

import resource
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.stream import StatsRecord


@dataclass(frozen=True)
class Telemetry:
    """Run telemetry.

    dispatches: pool advances — one per window on the per-window path
    (on the kernel path each is one kernel launch), one per (group x
    window) under host_loop, one per block under supersteps
    (window_block=W).
    host_syncs: blocking device->host waits. Per window: the combined
    record pull (a sketch rides it), plus samples, grouped stats and
    predictive costs; under supersteps ONE per block (the wait on the
    block's ring). A steering decision point adds none (the reference
    counts two: its counter pull and its pool pull).
    block_walls: (first_window, n_windows, dispatch_s) rows, one per
    window on the per-window paths and one per block under supersteps;
    dispatch_s is the host wall to enqueue the device work (excluding
    device compute, which the record pull then waits for). Where the
    rest of a window's time goes, a profiler's trace shows by the
    engine's spans (`core/trace.py`).
    steps_per_window: pool-total solver iterations that advanced a lane
    per window (exact SSA: events fired; tau-leaping: accepted leaps
    plus fired exact steps).
    leaps_per_window: accepted tau-leaps per window (zero on exact
    SSA); steps - leaps is tau-leaping's exact-fallback share.
    pipeline_depth: the resolved in-flight block budget ("auto" probes
    the first block); pipeline_depth_effective: the depth the collector
    ran at; peak_inflight_blocks: the most rings queued at once.
    snapshot_saves / ckpt_flushes: checkpoints served from a ring
    snapshot / that had to flush the pipeline.
    straggler_windows: (window, wall_s, rolling median) rows the
    straggler watchdog flagged (one sample per block under supersteps);
    a farm's also holds ("frontier", worker, window, median window)
    rows of workers whose checkpoint frontier lagged;
    straggler_rate: flagged over observed windows.
    restarts: engine teardowns and restores of a supervised run
    (Experiment.recovery); stall_redispatches: straggler re-dispatches,
    counted apart (they never use the max_restarts budget).
    """

    wall_time_s: float
    peak_buffered_bytes: int
    dispatches: int
    host_syncs: int
    peak_rss_bytes: Optional[int]
    steps_per_window: tuple = ()
    leaps_per_window: tuple = ()
    block_walls: tuple = ()
    pipeline_depth: int = 1
    pipeline_depth_effective: int = 1
    peak_inflight_blocks: int = 0
    snapshot_saves: int = 0
    ckpt_flushes: int = 0
    straggler_windows: tuple = ()
    straggler_rate: float = 0.0
    restarts: int = 0
    stall_redispatches: int = 0


def _peak_rss_bytes() -> int:
    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return ru * (1 if sys.platform == "darwin" else 1024)  # KiB on linux


class SimulationResult:
    def __init__(self, experiment, engine):
        self.experiment = experiment
        self._engine = engine
        self._wall_time = 0.0

    # ------------------------------------------------------------ run
    def resume(self, max_windows: Optional[int] = None,
               checkpoint_path: Optional[str] = None) -> "SimulationResult":
        """Advance the experiment, at most `max_windows` windows (all
        remaining if None), checkpointing after every window — or every
        collected block — when a path is given. Returns self.

        With `window_block > 1` the run advances in pipelined
        supersteps: up to `pipeline_depth` blocks are dispatched ahead
        of the oldest ring pull. A `checkpoint_path` then saves after
        every collected block, on that block's boundary, from the
        in-flight ring's entry snapshot (engine.enable_snapshots): a
        save flushes nothing and waits only for the copy of that
        snapshot's pool to the host (engine.ckpt_pulls), not for the
        blocks in flight. `max_windows` may cut the
        final block short; such a checkpoint rolls back to the cut
        block's boundary.

        Steered runs always take the block loop (decision points live
        at collected block boundaries), even at window_block=1, and run
        lock-step, so their checkpoints save the collected pool with
        nothing in flight and take no snapshots."""
        eng = self._engine
        t0 = time.perf_counter()
        done = 0
        try:
            if eng.cfg.window_block == 1 and eng._steer is None:
                while eng._window < len(eng.grid) and (
                        max_windows is None or done < max_windows):
                    eng.run_window()
                    done += 1
                    if checkpoint_path:
                        eng.checkpoint(checkpoint_path)
            else:
                limit = len(eng.grid) if max_windows is None else min(
                    len(eng.grid), eng._window + max_windows)
                if checkpoint_path and eng._steer is None:
                    eng.enable_snapshots()
                while eng._window < limit:
                    got = eng.run_block(dispatch_limit=limit)
                    if checkpoint_path and got:
                        eng.checkpoint(checkpoint_path)
                eng.flush()
        finally:
            self._wall_time += time.perf_counter() - t0
        if self.completed:
            eng.stream.close()
        return self

    def checkpoint(self, path: str) -> None:
        """Serialise pool + scheduler + emitted records to `path`, in
        the format both packages restore."""
        self._engine.checkpoint(path)

    @property
    def completed(self) -> bool:
        return self._engine._window >= len(self._engine.grid)

    @property
    def windows_run(self) -> int:
        return self._engine._window

    # ----------------------------------------------------------- data
    @property
    def obs_names(self) -> list[str]:
        return list(self._engine.obs_names)

    @property
    def records(self) -> list[StatsRecord]:
        return self._engine.stream.records()

    def means(self) -> np.ndarray:
        """(windows_run, n_obs) ensemble means."""
        return np.stack([r.mean for r in self.records])

    @property
    def t_grid(self) -> np.ndarray:
        return np.asarray(self._engine.grid)

    def trajectories(self) -> Optional[np.ndarray]:
        """(I, T, n_obs) raw samples — schemas i/ii always; schema iii
        when Experiment.record_trajectories was set."""
        return self._engine.trajectories()

    def per_point(self) -> Optional[dict]:
        """Grouped per-sweep-point statistics (Reduction.PER_POINT):
        {"mean"|"var"|"ci90"|"n": (windows, points, n_obs)} plus
        "points", or None for a pooled ensemble reduction."""
        grouped = self._engine.grouped_stats()
        if not grouped:
            return None
        out = {k: np.stack([getattr(g, k) for g in grouped])
               for k in ("n", "mean", "var", "ci90")}
        sweep = self.experiment.ensemble.sweep
        out["points"] = sweep.points() if sweep else [{}]
        return out

    def final_state(self) -> np.ndarray:
        """(I, S) species counts at the last completed window."""
        return self._engine._pool.x.cpu().numpy()

    def sketches(self) -> list:
        """Per-window `WindowSketch`es (hist (G, n_obs, n_bins) int32,
        rare (G, n_obs, n_thr) int32 or None) when the Experiment
        carried a SketchSpec; empty list otherwise. Derive quantiles or
        bimodality flags with `repro_torch.stats.quantiles_from_hist` /
        `bimodality_from_hist`."""
        return self._engine.sketches()

    def steering_report(self) -> Optional[dict]:
        """The steering policy's savings and decision summary (stopped
        points, windows saved, pinned lanes, bimodal flags, decision
        log), or None when the Experiment carried no active Steering."""
        return self._engine.steering_report()

    def recovery_report(self) -> Optional[dict]:
        """The RunSupervisor's event log and summary (restarts, faults by
        kind, the final shard count, events) for a supervised run; None
        otherwise."""
        return getattr(self, "_recovery", None)

    # ------------------------------------------------------ telemetry
    @property
    def telemetry(self) -> Telemetry:
        eng = self._engine
        return Telemetry(
            wall_time_s=self._wall_time,
            peak_buffered_bytes=eng.peak_buffered_bytes,
            dispatches=eng.n_dispatches,
            host_syncs=eng.n_host_syncs,
            peak_rss_bytes=_peak_rss_bytes(),
            steps_per_window=tuple(eng.window_steps),
            leaps_per_window=tuple(eng.window_leaps),
            block_walls=tuple(eng.block_walls),
            pipeline_depth=eng.pipeline_depth,
            pipeline_depth_effective=eng.pipeline_depth_effective,
            peak_inflight_blocks=eng.peak_inflight_blocks,
            snapshot_saves=eng.n_snapshot_saves,
            ckpt_flushes=eng.n_ckpt_flushes,
            straggler_windows=tuple(eng.watchdog.flagged),
            straggler_rate=eng.watchdog.straggler_rate(),
            restarts=getattr(self, "_restarts", 0),
            stall_redispatches=getattr(self, "_stall_redispatches", 0))

    def __repr__(self) -> str:
        state = "completed" if self.completed else (
            f"{self.windows_run}/{len(self._engine.grid)} windows")
        return (f"SimulationResult({state}, instances="
                f"{self.experiment.ensemble.n_instances}, "
                f"schema={self.experiment.schedule.schema.value!r}, "
                f"device={self._engine.device})")
