"""Typed recoverable faults and deterministic fault injection; port of
`repro/runtime/fault.py` (numpy only).

A fault is a value: the engine raises `InvariantViolation` from its
guards, the injector simulates the rest, and
`runtime.supervisor.RunSupervisor` catches a `RecoverableError`,
classifies it by `kind` and recovers by restore and replay. Per-lane
counter-based RNG makes the work relocatable: a lane re-run from a
checkpoint gives the same bits, so every fault here is recoverable.

`FailurePlan` holds a schedule — explicit {window: kind} entries plus
an optional seeded probabilistic layer drawn once per plan seed, the
same draws as the reference's for the same seed — and
`FailureInjector` fires each scheduled fault exactly once.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class RecoverableError(Exception):
    """Base for faults the supervisor recovers from by restore and
    replay. `window` is the engine window the fault surfaced at (-1
    unknown); `kind` is its FAULT_KINDS tag."""

    kind = "crash"

    def __init__(self, message: str, window: int = -1):
        super().__init__(message)
        self.window = window


class EngineCrash(RecoverableError):
    """Simulated or detected process death: rebuild and restore."""

    kind = "crash"


class DeviceLost(RecoverableError):
    """A shard's device dropped out: rebuild on the survivors
    (`Partitioning.degrade` and reshard-on-restore)."""

    kind = "device_lost"

    def __init__(self, message: str, window: int = -1, n_lost: int = 1):
        super().__init__(message, window)
        self.n_lost = n_lost


class EngineStall(RecoverableError):
    """A window breached the straggler watchdog hard enough to abandon:
    supervised re-dispatch of the offending block."""

    kind = "stall"


class HostLost(RecoverableError):
    """A worker process of the multi-process farm died (queue 1 item
    16): its coordinator restarts it from its namespaced checkpoints."""

    kind = "host_lost"

    def __init__(self, message: str, window: int = -1, worker: int = -1):
        super().__init__(message, window)
        self.worker = worker


class WorkerStall(RecoverableError):
    """A worker process is alive but its heartbeat went stale (queue 1
    item 16): killed and restarted like HostLost, tagged apart."""

    kind = "worker_stall"

    def __init__(self, message: str, window: int = -1, worker: int = -1):
        super().__init__(message, window)
        self.worker = worker


class InvariantViolation(RecoverableError):
    """An engine invariant guard tripped (non-finite statistics, a
    negative mean, ring/record disagreement): the in-memory state is
    untrusted, recover from the last durable checkpoint."""

    kind = "nan_pool"

    def __init__(self, message: str, window: int = -1, check: str = ""):
        super().__init__(message, window)
        self.check = check


# The typed fault vocabulary (injection and classification):
#   crash        drop the engine between windows; restore the newest file
#   device_lost  drop a shard; restore onto a degraded partitioning
#   ckpt_corrupt truncate the newest checkpoint, then crash: drills the
#                fallback past a corrupt file
#   stall        watchdog-grade stall; re-dispatch = restore and replay
#   nan_pool     poison the pool; the engine's own guard must catch it
#   host_lost    kill a worker process (multi-process farm only)
#   worker_stall stop a worker process past its heartbeat timeout
FAULT_KINDS = ("crash", "device_lost", "ckpt_corrupt", "stall", "nan_pool",
               "host_lost", "worker_stall")


@dataclass
class FailurePlan:
    """Deterministic failure schedule: `schedule` maps window -> fault
    kind; `random_rate` > 0 adds per-window `random_kind` faults drawn
    by `materialize` from `np.random.default_rng(seed)`, so the same
    (seed, rate, n_windows) always gives the same schedule."""

    schedule: dict = field(default_factory=dict)
    seed: int = 0
    random_rate: float = 0.0
    random_kind: str = "crash"

    def __post_init__(self):
        for kind in self.schedule.values():
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; expected one of "
                    f"{FAULT_KINDS}")
        if not 0.0 <= self.random_rate <= 1.0:
            raise ValueError(
                f"random_rate must be in [0, 1], got {self.random_rate}")
        if self.random_kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown random_kind {self.random_kind!r}; expected "
                f"one of {FAULT_KINDS}")

    def materialize(self, n_windows: int) -> dict:
        """Concrete {window: kind} for a run of `n_windows` windows:
        explicit entries win; seeded draws fill the rest."""
        out = dict(self.schedule)
        if self.random_rate > 0.0:
            rng = np.random.default_rng(self.seed)
            hits = rng.random(n_windows) < self.random_rate
            for w in np.nonzero(hits)[0]:
                out.setdefault(int(w), self.random_kind)
        return out


class FailureInjector:
    """Fires each scheduled fault exactly once: a restarted run passes
    the same window again during replay, and a refired fault would keep
    the drill from converging."""

    def __init__(self, plan: FailurePlan, n_windows: Optional[int] = None):
        self.plan = plan
        self.schedule = (plan.materialize(n_windows)
                         if n_windows is not None else dict(plan.schedule))
        self.events: list = []
        self._fired: set = set()

    def maybe_fail(self, step: int) -> Optional[str]:
        if step in self._fired:
            return None
        kind = self.schedule.get(step)
        if kind:
            self._fired.add(step)
            self.events.append((step, kind))
        return kind


def run_sim_with_failures(make_engine, ckpt_path: str, plan: FailurePlan,
                          ckpt_every: int = 1):
    """Minimal drill: run a SimulationEngine window by window, dropping
    it and restoring a new one from the last checkpoint at each planned
    fault. `make_engine() -> SimulationEngine`. Returns (the surviving
    run's records in window order, the injector's events). The
    production loop (cadence, retention, elastic recovery) is
    `runtime.supervisor.RunSupervisor`."""
    eng = make_engine()
    inj = FailureInjector(plan, n_windows=len(eng.grid))
    eng.checkpoint(ckpt_path)
    records = {}
    guard = 0
    while eng._window < len(eng.grid):
        w = eng._window
        if inj.maybe_fail(w):
            eng = make_engine()
            eng.restore(ckpt_path)
            continue
        rec = eng.run_window()
        records[rec.window] = rec
        if (w + 1) % ckpt_every == 0:
            eng.checkpoint(ckpt_path)
        guard += 1
        assert guard < 10 * len(eng.grid), "drill did not converge"
    ordered = [records[w] for w in range(len(eng.grid))]
    return ordered, inj.events
