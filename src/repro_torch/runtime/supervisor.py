"""RunSupervisor — the self-healing run lifecycle; port of
`repro/runtime/supervisor.py`.

The engine turns faults into typed `RecoverableError`s and checkpoints
into atomic, checksummed files that do not depend on the shard count;
this loop turns the two into a run that survives anything short of
losing every device:

* cadenced checkpoints on window or block boundaries, named by window,
  under a keep-last-K `RetentionPolicy`;
* restart on any RecoverableError after a bounded exponential backoff:
  the engine is dropped, rebuilt, and restored from the newest file
  that verifies, past corrupt or truncated ones (a fresh start at
  window 0 if none survives);
* elastic shard loss: a `DeviceLost` shrinks the Partitioning by
  `degrade()` (stat_blocks pinned, so records stay bitwise) and the
  rebuild lands on the first d devices of the run's device list
  through reshard-on-restore;
* straggler escalation: with `redispatch_stragglers` a watchdog flag
  raises an EngineStall that re-dispatches its block from the last
  checkpoint (once per window, on its own counter);
* deterministic fault injection (`FailurePlan`) through the same
  machinery.

The contract: trajectories are a pure function of (seed, counter-RNG
state) and a checkpoint carries the pool, its counters, the emitted
records and the steering state, so a run under any injected fault
sequence gives records, sketches and steering decisions bitwise equal
to the uninterrupted run's. Sinks are attached only once the run has
succeeded, so restarts never write a record twice.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.ckpt import store as ckpt_store
from repro_torch.runtime.fault import (
    DeviceLost,
    EngineCrash,
    EngineStall,
    FailureInjector,
    FailurePlan,
    RecoverableError,
)


@dataclass(frozen=True)
class Recovery:
    """Supervised-recovery spec (`Experiment(recovery=Recovery(...))`),
    the reference's fields and defaults.

    ckpt_dir: directory of the cadenced checkpoints (made on run).
    cadence: checkpoint every N windows, rounded up to a multiple of the
    experiment's window_block (restore refuses mid-block files).
    keep_last: RetentionPolicy depth; >= 2 keeps a fallback behind the
    newest file, which is what survives a corrupt newest checkpoint.
    max_restarts: recoveries allowed before the run is declared dead (a
    RuntimeError carrying the last fault).
    backoff_base_s / backoff_max_s: restart backoff base * 2^(restart-1),
    capped.
    elastic: on DeviceLost, degrade the Partitioning to the survivors.
    redispatch_stragglers: escalate watchdog flags into a supervised
    re-dispatch of the offending block (one retry per window).
    inject: a FailurePlan drill; None in production.
    workers, heartbeat_s, max_worker_restarts, namespace: the
    multi-process farm's (queue 1 item 16); workers > 1 is refused by
    the port's Experiment.validate until it is ported. They stay so
    that the reference's spec literal builds unchanged; until then only
    `validate` reads heartbeat_s and max_worker_restarts. namespace also
    prefixes this supervisor's checkpoint names.
    """

    ckpt_dir: str = "recovery"
    cadence: int = 1
    keep_last: int = 3
    max_restarts: int = 8
    backoff_base_s: float = 0.0
    backoff_max_s: float = 30.0
    elastic: bool = True
    redispatch_stragglers: bool = False
    inject: Optional[FailurePlan] = None
    workers: int = 1
    heartbeat_s: float = 2.0
    max_worker_restarts: int = 2
    namespace: str = ""

    def validate(self) -> None:
        if not self.ckpt_dir:
            raise ValueError("Recovery.ckpt_dir must be a directory path")
        if self.cadence < 1:
            raise ValueError(
                f"Recovery.cadence must be >= 1, got {self.cadence}")
        if self.keep_last < 1:
            raise ValueError(
                f"Recovery.keep_last must be >= 1, got {self.keep_last}")
        if self.max_restarts < 0:
            raise ValueError(
                f"Recovery.max_restarts must be >= 0, got "
                f"{self.max_restarts}")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("Recovery backoff times must be >= 0")
        if self.inject is not None \
                and not isinstance(self.inject, FailurePlan):
            raise ValueError(
                "Recovery.inject must be a runtime.fault.FailurePlan, "
                f"got {type(self.inject).__name__}")
        if self.workers < 1:
            raise ValueError(
                f"Recovery.workers must be >= 1, got {self.workers}")
        if self.heartbeat_s <= 0:
            raise ValueError(
                f"Recovery.heartbeat_s must be > 0, got "
                f"{self.heartbeat_s}")
        if self.max_worker_restarts < 0:
            raise ValueError(
                f"Recovery.max_worker_restarts must be >= 0, got "
                f"{self.max_worker_restarts}")
        ckpt_store.checkpoint_name(0, self.namespace)  # charset check


class RunSupervisor:
    """Owns one Experiment's engine lifecycle end to end. `run()`
    returns the SimulationResult simulate() returns, with
    `recovery_report()` filled in.

    device: as for simulate(): None (shard k on cuda:k), one device
    holding every shard, or one device per shard. After a DeviceLost
    the d surviving shards take the first d entries of a list."""

    def __init__(self, experiment, recovery: Recovery, device=None):
        recovery.validate()
        self.experiment = experiment
        self.recovery = recovery
        self.device = device
        self._part = experiment.partitioning
        self._restarts = 0
        # straggler re-dispatches are rebalancing, not crashes: their
        # own counter, outside the max_restarts budget
        self._stall_redispatches = 0
        self._events: list[dict] = []
        self._stall_retried: set[int] = set()
        self._injector = (
            FailureInjector(recovery.inject,
                            n_windows=experiment.schedule.n_windows)
            if recovery.inject is not None else None)
        # saves land on superstep boundaries: the cadence rounded up to
        # a multiple of window_block
        wb = max(1, experiment.window_block)
        self._cadence = ((max(recovery.cadence, wb) + wb - 1) // wb) * wb
        self._depth_effective = 1
        # (teardown s, rebuild s, restore s) of each recovery
        self.recovery_walls: list[tuple[float, float, float]] = []

    # ------------------------------------------------------------- api
    def run(self):
        from repro_torch.api.result import SimulationResult

        rec = self.recovery
        os.makedirs(rec.ckpt_dir, exist_ok=True)
        t0 = time.perf_counter()
        teardown_s = None
        while True:
            t_build = time.perf_counter()
            engine = self._build()
            t_restore = time.perf_counter()
            self._restore_newest_valid(engine)
            if teardown_s is not None:
                self.recovery_walls.append(
                    (teardown_s, t_restore - t_build,
                     time.perf_counter() - t_restore))
            try:
                self._drive(engine)
                self._depth_effective = engine.pipeline_depth_effective
                break
            except RecoverableError as e:
                t_down = time.perf_counter()
                engine = None  # drop the engine: its pool is untrusted
                self._handle_fault(e)
                teardown_s = time.perf_counter() - t_down
        # sinks attach only now: the record buffer replays into each
        # once, so a run that restarted still writes every record once
        for sink in self.experiment.sinks:
            engine.stream.attach(sink)
            for r in engine.stream.records():
                sink(r)
        engine.stream.close()
        result = SimulationResult(self.experiment, engine)
        result._wall_time = time.perf_counter() - t0
        result._restarts = self._restarts
        result._stall_redispatches = self._stall_redispatches
        result._recovery = self.report()
        return result

    def report(self) -> dict:
        """The recovery event log and its summary counters."""
        kinds: dict = {}
        for ev in self._events:
            if ev["event"] == "fault":
                kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
        return {
            "restarts": self._restarts,
            "stall_redispatches": self._stall_redispatches,
            "faults_by_kind": kinds,
            "final_n_shards": (self._part.n_shards
                               if self._part is not None else None),
            "pipeline_depth_effective": self._depth_effective,
            "events": list(self._events),
        }

    # ------------------------------------------------------ lifecycle
    def _log(self, event: str, **detail) -> None:
        self._events.append({"event": event, **detail})

    def _devices(self):
        """The build's device argument: a list is cut to the surviving
        shards' first entries; anything else passes through."""
        if isinstance(self.device, (list, tuple)):
            n = self._part.n_shards if self._part is not None else 1
            return list(self.device)[:n]
        return self.device

    def _build(self):
        from repro_torch.api.run import build_engine

        exp = self.experiment.with_(sinks=(), recovery=None,
                                    partitioning=self._part)
        return build_engine(exp, device=self._devices())

    def _restore_newest_valid(self, engine) -> None:
        """Restore the newest checkpoint that verifies, past corrupt or
        truncated files; a fresh start at window 0 if none survives."""
        for w, path in reversed(
                ckpt_store.list_checkpoints(self.recovery.ckpt_dir,
                                            self.recovery.namespace)):
            try:
                engine.restore(path)
            except ckpt_store.CheckpointCorrupt as e:
                self._log("corrupt_checkpoint_skipped", window=w,
                          path=path, error=str(e))
                continue
            self._log("restored", window=w, path=path)
            return
        self._log("fresh_start")

    def _drive(self, engine) -> None:
        rec = self.recovery
        n = len(engine.grid)
        per_window = engine.cfg.window_block == 1 and engine._steer is None
        if not per_window and engine._steer is None:
            # cadence saves come from the oldest in-flight block's entry
            # snapshot, so the pipeline keeps its depth through a save
            # (steered runs are lock-step: nothing is in flight)
            engine.enable_snapshots()
        if not ckpt_store.list_checkpoints(rec.ckpt_dir, rec.namespace):
            self._save(engine)  # window-0 anchor: an early crash restores
        while engine._window < n:
            w = engine._window
            next_save = min(n, (w // self._cadence + 1) * self._cadence)
            if per_window:
                self._inject(engine, w, w + 1)
                engine.run_window()
            else:
                self._inject(engine, w, min(w + engine.cfg.window_block, n))
                engine.run_block()
            self._check_stragglers(engine)
            # the cadence is a window_block multiple and blocks collect
            # in grid order, so the frontier lands on every save boundary
            if engine._window >= next_save:
                self._save(engine)

    def _save(self, engine) -> None:
        rec = self.recovery
        path = os.path.join(
            rec.ckpt_dir,
            ckpt_store.checkpoint_name(engine._window, rec.namespace))
        engine.checkpoint(path)
        pruned = ckpt_store.RetentionPolicy(rec.keep_last).apply(
            rec.ckpt_dir, rec.namespace)
        self._log("checkpoint", window=engine._window, path=path,
                  pruned=len(pruned))

    def _handle_fault(self, e: RecoverableError) -> None:
        rec = self.recovery
        if isinstance(e, EngineStall):
            # restore and replay like any fault, on its own counter and
            # without a backoff: delaying the retry of a slow window only
            # makes it slower (the injector fires once, the watchdog
            # retries a window once)
            self._stall_redispatches += 1
            self._log("fault", kind=e.kind, window=e.window,
                      stall_redispatch=self._stall_redispatches,
                      error=str(e))
            return
        self._restarts += 1
        self._log("fault", kind=e.kind, window=e.window,
                  restart=self._restarts, error=str(e))
        if self._restarts > rec.max_restarts:
            raise RuntimeError(
                f"run declared dead after {self._restarts} restarts "
                f"(Recovery.max_restarts={rec.max_restarts}); last "
                f"fault: {e}") from e
        if isinstance(e, DeviceLost) and rec.elastic \
                and self._part is not None and self._part.n_shards > 1:
            n_inst = self.experiment.ensemble.n_instances
            old = self._part.n_shards
            self._part = self._part.degrade(n_inst, e.n_lost)
            self._log("degraded", from_shards=old,
                      to_shards=self._part.n_shards)
        delay = min(rec.backoff_max_s,
                    rec.backoff_base_s * (2 ** (self._restarts - 1)))
        if delay > 0:
            time.sleep(delay)

    # ------------------------------------------------------ escalation
    def _check_stragglers(self, engine) -> None:
        if not self.recovery.redispatch_stragglers:
            return
        for w, wall, med in engine.watchdog.flagged:
            if w in self._stall_retried:
                continue
            # one retry per window: replay is bitwise, so a window that
            # is slow by nature is slow again and the run goes on
            self._stall_retried.add(w)
            raise EngineStall(
                f"window {w} breached the straggler watchdog "
                f"({wall:.4f}s vs rolling median {med:.4f}s); "
                "re-dispatching its block from the last checkpoint",
                window=w)

    # ------------------------------------------------------- injection
    def _inject(self, engine, w_lo: int, w_hi: int) -> None:
        if self._injector is None:
            return
        for wi in range(w_lo, w_hi):
            kind = self._injector.maybe_fail(wi)
            if kind is None:
                continue
            self._log("fault_injected", window=wi, kind=kind)
            if kind == "crash":
                raise EngineCrash(f"injected crash before window {wi}",
                                  window=wi)
            if kind == "device_lost":
                raise DeviceLost(
                    f"injected device loss before window {wi}",
                    window=wi, n_lost=1)
            if kind == "ckpt_corrupt":
                # corrupt the newest file THEN crash: one fault drills
                # the fallback past a corrupt checkpoint
                self._corrupt_newest()
                raise EngineCrash(
                    f"injected crash (after checkpoint corruption) "
                    f"before window {wi}", window=wi)
            if kind == "stall":
                raise EngineStall(
                    f"injected stall at window {wi}; re-dispatching",
                    window=wi)
            if kind == "nan_pool":
                # poison the pool and do not raise: the engine's own
                # invariant guard must catch it
                self._poison_pool(engine)

    def _corrupt_newest(self) -> None:
        cks = ckpt_store.list_checkpoints(self.recovery.ckpt_dir,
                                          self.recovery.namespace)
        if not cks:
            return
        path = cks[-1][1]
        size = os.path.getsize(path)
        # truncate rather than flip bytes: a flipped byte can land in zip
        # padding and pass verification; half a file never loads
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        self._log("checkpoint_corrupted", path=path)

    @staticmethod
    def _poison_pool(engine) -> None:
        """NaN populations in every shard, as fresh leaves on each
        shard's device: held ring snapshots keep the clean pool."""
        import torch

        engine._pools = [p._replace(x=torch.full_like(p.x, float("nan")))
                         for p in engine._pools]
