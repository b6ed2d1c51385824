"""SimulationResult — the handle `simulate()` returns; port of
`repro/api/result.py` for the per-window path.

Wraps the running (or finished) engine: streamed records, per-sweep-
point grouped statistics, raw trajectories and telemetry. The handle
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

    dispatches: window advances (one per window; on the kernel path each
    is one kernel launch).
    host_syncs: blocking device->host copies (the combined per-window
    record pull, plus samples, grouped stats and predictive costs).
    window_wall_times: per-window host wall to enqueue the window's
    device work; on the kernel path this excludes device compute, which
    the record pull then waits for.
    block_walls: (window, 1, dispatch_s, collect_s) rows; collect_s is
    the blocking pull plus host-side emit.
    steps_per_window: pool-total solver iterations that advanced a lane
    per window (exact SSA: events fired; tau-leaping: accepted leaps
    plus fired exact steps).
    leaps_per_window: accepted tau-leaps per window (zero on exact
    SSA); steps - leaps is tau-leaping's exact-fallback share.
    """

    wall_time_s: float
    window_wall_times: tuple
    peak_buffered_bytes: int
    dispatches: int
    host_syncs: int
    peak_rss_bytes: Optional[int]
    steps_per_window: tuple = ()
    leaps_per_window: tuple = ()
    block_walls: tuple = ()


def _peak_rss_bytes() -> int:
    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return ru * (1 if sys.platform == "darwin" else 1024)  # KiB on linux


class SimulationResult:
    def __init__(self, experiment, engine):
        self.experiment = experiment
        self._engine = engine
        self._wall_time = 0.0

    # ------------------------------------------------------------ run
    def resume(self, max_windows: Optional[int] = None
               ) -> "SimulationResult":
        """Advance the experiment, at most `max_windows` windows (all
        remaining if None). Returns self for chaining."""
        eng = self._engine
        t0 = time.perf_counter()
        done = 0
        try:
            while eng._window < len(eng.grid) and (
                    max_windows is None or done < max_windows):
                eng.run_window()
                done += 1
        finally:
            self._wall_time += time.perf_counter() - t0
        if self.completed:
            eng.stream.close()
        return self

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

    # ------------------------------------------------------ telemetry
    @property
    def telemetry(self) -> Telemetry:
        eng = self._engine
        return Telemetry(
            wall_time_s=self._wall_time,
            window_wall_times=tuple(eng.wall_times),
            peak_buffered_bytes=eng.peak_buffered_bytes,
            dispatches=eng.n_dispatches,
            host_syncs=eng.n_host_syncs,
            peak_rss_bytes=_peak_rss_bytes(),
            steps_per_window=tuple(eng.window_steps),
            leaps_per_window=tuple(eng.window_leaps),
            block_walls=tuple(eng.block_walls))

    def __repr__(self) -> str:
        state = "completed" if self.completed else (
            f"{self.windows_run}/{len(self._engine.grid)} windows")
        return (f"SimulationResult({state}, instances="
                f"{self.experiment.ensemble.n_instances}, "
                f"schema={self.experiment.schedule.schema.value!r}, "
                f"device={self._engine.device})")
