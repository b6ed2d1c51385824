"""Instance scheduling — the paper's Fig. 5 schemas, vectorised; the
port's own copy of `repro/core/scheduler.py`.

An *instance* is one stochastic simulation (replica or sweep point);
a *lane* is a row of the SIMD engine. The scheduler decides which
instances occupy the lanes for each (window × slot):

* `static_rr` (schema i): instances are partitioned into fixed
  round-robin groups that never re-form, whatever their relative cost
  (the paper's load-imbalance case). Since the engine unified all
  schemas onto the windowed pool loop, group membership — not
  trajectory-major execution order — is what distinguishes it; per-lane
  results are order-invariant either way (keyed RNG).
* `on_demand` (schema ii/iii): all instances advance window-by-window,
  sliced into lane-width groups per window (fixed sim-time slices, the
  stop/restart instance objects of §5.2(ii) realised as gather/scatter
  on the pool).
* `predictive` (schema ii/iii + history heuristics): like on_demand but
  groups are formed by sorting instances on an EMA of their per-window
  event cost, so lock-step groups are cost-homogeneous and masked idle
  work shrinks (the paper's "predictive heuristics based on instance
  history").

When the pool is sharded over a mesh axis (`n_shards > 1`), grouping —
including the predictive cost sort — happens *within* each shard's
contiguous instance block, so every lane group lives on one device and
the window permutation never implies a cross-shard gather.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Scheduler:
    n_instances: int
    n_lanes: int
    policy: str = "on_demand"  # static_rr | on_demand | predictive
    ema_alpha: float = 0.5
    n_shards: int = 1  # > 1: group within contiguous shard blocks only
    _cost: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        assert self.n_instances % self.n_shards == 0, (
            f"n_instances={self.n_instances} not divisible by "
            f"n_shards={self.n_shards}")
        self._cost = np.zeros(self.n_instances, np.float64)

    def groups(self) -> list[np.ndarray]:
        """Lane-width instance-index groups for the next window,
        shard-major: groups never mix instances from different shard
        blocks, and every shard yields the same number of groups (its
        block size is uniform), so the concatenated permutation splits
        evenly across devices."""
        per = self.n_instances // self.n_shards
        out = []
        for k in range(self.n_shards):
            lo = k * per
            order = np.arange(lo, lo + per)
            if self.policy == "predictive":
                order = lo + np.argsort(self._cost[lo:lo + per],
                                        kind="stable")
            ngroups = (per + self.n_lanes - 1) // self.n_lanes
            for g in range(ngroups):
                idx = order[g * self.n_lanes:(g + 1) * self.n_lanes]
                if len(idx) < self.n_lanes:  # pad by repeating (masked)
                    idx = np.concatenate(
                        [idx, np.full(self.n_lanes - len(idx), idx[-1])])
                out.append(idx.astype(np.int32))
        return out

    def record_costs(self, idx: np.ndarray, steps: np.ndarray) -> None:
        """Update per-instance EMA cost with events used this window."""
        a = self.ema_alpha
        self._cost[idx] = (1 - a) * self._cost[idx] + a * steps

    def imbalance(self) -> float:
        """Coefficient of variation of instance costs (diagnostics)."""
        c = self._cost
        return float(c.std() / max(c.mean(), 1e-9))
