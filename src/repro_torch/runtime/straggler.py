"""Straggler detection for the simulation farm; port of
`repro/runtime/straggler.py` (numpy only).

* `WindowWatchdog` — per-window wall-time monitor: a window whose wall
  exceeds `factor` × the running median is flagged. Flags surface in
  `Telemetry.straggler_windows`; `Recovery(redispatch_stragglers=True)`
  escalates them into a supervised re-dispatch.
* `FrontierWatchdog` — per-worker progress monitor for the
  multi-process farm (queue 1 item 16): flags a worker whose collected
  window frontier trails the median of the others.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


def _median(values) -> float:
    """`np.median` of a short sequence, in plain Python: the mean of the
    two middle values for an even count, as numpy takes it. numpy's own
    imports `numpy.ma` on its first call (tens of ms), which would land
    inside the first observed window."""
    s = sorted(values)
    m = len(s) // 2
    return float(s[m]) if len(s) % 2 else (s[m - 1] + s[m]) / 2.0


@dataclass
class WindowWatchdog:
    factor: float = 3.0
    history: deque = field(default_factory=lambda: deque(maxlen=64))
    flagged: list = field(default_factory=list)
    # windows covered by observations; `history` is a bounded median
    # window, never the rate's denominator
    observed: int = 0

    def observe(self, window: int, wall_s: float) -> bool:
        """Returns True if this window is a straggler."""
        med = _median(self.history) if self.history else wall_s
        self.history.append(wall_s)
        self.observed += 1
        if self.history and wall_s > self.factor * max(med, 1e-9):
            self.flagged.append((window, wall_s, med))
            return True
        return False

    def observe_block(self, window: int, n_windows: int,
                      wall_s: float) -> bool:
        """Observe a superstep block as ONE sample at per-window scale:
        `wall_s / n_windows` against the block's first window (n_windows
        equal slices would feed the median correlated copies), while
        `observed` advances by the real window count so the rate keeps
        a per-window denominator."""
        per = wall_s / max(n_windows, 1)
        med = _median(self.history) if self.history else per
        self.history.append(per)
        self.observed += max(n_windows, 1)
        if self.history and per > self.factor * max(med, 1e-9):
            self.flagged.append((window, per, med))
            return True
        return False

    def straggler_rate(self) -> float:
        return len(self.flagged) / self.observed if self.observed else 0.0


@dataclass
class FrontierWatchdog:
    """Coordinator-level per-worker progress monitor (multi-process
    farm). Each heartbeat reports a worker's collected window frontier;
    a worker whose frontier trails the median of the running workers by
    >= `grace_windows` is flagged. Telemetry, not a kill switch: the
    heartbeat timeout handles liveness."""

    grace_windows: int = 4
    frontiers: dict = field(default_factory=dict)    # worker -> window
    flagged: list = field(default_factory=list)      # (worker, win, med)
    observed: int = 0

    def observe(self, worker: int, window: int) -> bool:
        """Record worker's frontier; True if it now lags the median."""
        prev = self.frontiers.get(worker, -1)
        self.frontiers[worker] = max(prev, int(window))
        self.observed += 1
        if len(self.frontiers) < 2:
            return False
        med = _median(self.frontiers.values())
        if med - self.frontiers[worker] >= self.grace_windows:
            self.flagged.append((worker, self.frontiers[worker], med))
            return True
        return False

    def forget(self, worker: int) -> None:
        """Drop a retired or finished worker from the median pool."""
        self.frontiers.pop(worker, None)

    def straggler_rate(self) -> float:
        return len(self.flagged) / self.observed if self.observed else 0.0
