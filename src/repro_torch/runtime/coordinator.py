"""FarmCoordinator — a coordinator process that outlives its workers;
port of `repro/runtime/coordinator.py`.

The multi-process elastic ensemble farm: the coordinator partitions an
Experiment's ensemble (sweep points x replicas) into `Recovery.workers`
contiguous shards, launches each shard as a WORKER PROCESS
(`runtime.worker`: the RunSupervisor loop with cadenced checkpoints
under a per-worker namespace in the shared ckpt_dir) and supervises
them through heartbeat files:

* each worker writes an atomic JSON heartbeat (window frontier,
  checkpoint frontier, straggler rate, phase) every ``heartbeat_s / 2``;
* a heartbeat stale for ``3 x heartbeat_s`` is a `worker_stall`: the
  worker is SIGKILLed (after a SIGCONT, so a SIGSTOPped one dies too)
  and restarted. A worker whose heartbeat says "init" (starting up) or
  "done" (its windows run: it writes its bundle and exits, the CUDA
  context's teardown included, after its last beat) is held to the
  launch grace, ``max(60, 10 x heartbeat_s)`` s, instead; the
  reference holds "done" to the running limit, which a card worker's
  exit can outlast at a heartbeat of half a second;
* a dead process, or an exit without a verifying result bundle, is a
  `host_lost`;
* a restart waits a bounded exponential backoff (``backoff_base_s *
  2^(restarts-1)``, capped at ``backoff_max_s``) and resumes from the
  newest checkpoint in the worker's namespace that verifies (the
  worker's RunSupervisor skips corrupt files);
* a slot that dies more than ``max_worker_restarts`` times is RETIRED:
  its shard goes back on the queue, and the first survivor that
  finishes its own shard takes it up in the same namespace, so it
  resumes from the retired worker's checkpoints;
* a `FrontierWatchdog` flags workers whose window frontier falls behind
  the fleet's median (telemetry; liveness is the heartbeat's job).

Devices: every worker runs on a device of the caller's `device`
argument. None means the CUDA devices, worker k on cuda:(k mod cards);
one device holds every worker (each in its own CUDA context on a card,
where their kernels time-slice); a list places worker slot k on entry
k mod its length. A worker sent to a card never falls back to the CPU.
The kernel library is built once here before card workers start.

WHY THE MERGE IS BITWISE: worker lanes take their key rows from the
GLOBAL key table, so each lane runs the trajectory it runs in one
process; each worker owns whole stat blocks of the global Welford
partition and exports its per-window partial stacks; the coordinator
concatenates them in global block order and runs the same
`reduction.merge_blocks` + `finalize` fold the single-process engine's
`_pack_window` runs, on the run's lead device (the first worker device)
so the ops run on the hardware the single-process run folds on. Grouped
partials fold through the zero-extended global (V, G) stack, sketch
counts add or concatenate, trajectories concatenate, and steering
reports merge (`_merge_steering`). The result equals `Partitioning(
n_shards=1, stat_blocks=B)` run in one process, bit for bit, however
many workers died, stalled or were reassigned on the way.

Fault injection (`Recovery.inject`) is process-level here: `host_lost`
and `crash` SIGKILL a worker, `worker_stall` and `stall` SIGSTOP it past
the heartbeat timeout, `ckpt_corrupt` kills it and truncates the newest
checkpoint in its namespace. Each scheduled fault fires once, on the
first worker whose heartbeat frontier crosses its window. The
coordinator keeps no checkpoint: its state, the shard queue, is a
function of the Experiment, and a rerun finds the workers' bundles and
checkpoints.

Worker specs are written with the standard library's pickle: the model
travels compiled (`CompiledModel`), since a CWCModel's init_fn may be a
closure.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from repro_torch.ckpt import store as ckpt_store
from repro_torch.core import reduction
from repro_torch.core.cwc.compile import CompiledModel
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import resolve_observables
from repro_torch.core.stream import StatsRecord, StatsStream
from repro_torch.runtime.fault import FailureInjector
from repro_torch.runtime.straggler import FrontierWatchdog
from repro_torch.runtime.supervisor import Recovery
from repro_torch.stats.sketch import WindowSketch

# process-level fault kinds the coordinator injects; the engine's own
# kinds (device_lost, nan_pool) belong to a workers=1 Recovery
_INJECTABLE = {
    "host_lost": "kill", "crash": "kill",
    "worker_stall": "stop", "stall": "stop",
    "ckpt_corrupt": "corrupt",
}


def worker_devices(device, n_workers: int) -> list[torch.device]:
    """The device of each worker slot: None, worker k on cuda:(k mod
    cards) (raises without a card); one device, every worker on it."""
    if device is None:
        resolve_device(None)  # the port's refusal when there is no card
        n = torch.cuda.device_count()
        return [torch.device("cuda", k % n) for k in range(n_workers)]
    return [resolve_device(device)] * n_workers


class _Shard:
    """One contiguous slice of the global ensemble and its files (spec,
    heartbeat, result bundle)."""

    def __init__(self, index: int, lo: int, hi: int, blocks: int,
                 ckpt_dir: str):
        self.index = index
        self.lo, self.hi, self.blocks = lo, hi, blocks
        self.namespace = f"shard{index:02d}"
        self.spec_path = os.path.join(
            ckpt_dir, f"{self.namespace}__spec.pkl")
        self.hb_path = os.path.join(
            ckpt_dir, f"hb_{self.namespace}.json")
        # holds no "ckpt_", so the store's namespaced listing never takes
        # a result bundle for a checkpoint
        self.result_path = os.path.join(
            ckpt_dir, f"{self.namespace}__result.npz")
        self.owner = index  # original slot; differs after reassignment
        self.bundle: Optional[dict] = None
        self.launch_t = 0.0  # wall clock of its last launch


class _Slot:
    """One worker slot (a "host"): the unit the restart budget and
    retirement apply to. Slot i first runs shard i."""

    def __init__(self, index: int, device: torch.device):
        self.index = index
        self.device = device
        self.proc: Optional[subprocess.Popen] = None
        self.shard: Optional[_Shard] = None
        self.restarts = 0
        self.retired = False
        self.next_start = 0.0
        self.launch_t = 0.0
        self.shards_run: list[int] = []


class FarmCoordinator:
    """Drives one Experiment across `recovery.workers` worker processes
    and merges their results bit for bit. `run()` returns the
    SimulationResult simulate() returns, with `recovery_report()`
    carrying the farm's event log. `device` places the workers
    (`worker_devices`); the merge runs on the first worker's device."""

    def __init__(self, experiment, recovery: Recovery, device=None):
        recovery.validate()
        experiment.validate()
        self.experiment = experiment
        self.recovery = recovery
        ens = experiment.ensemble
        k = recovery.workers
        blocks = (experiment.partitioning.blocks
                  if experiment.partitioning is not None else k)
        per = ens.n_instances // k
        self.n_windows = experiment.schedule.n_windows
        self.devices = worker_devices(device, k)
        self.shards = [
            _Shard(i, i * per, (i + 1) * per, blocks // k,
                   recovery.ckpt_dir)
            for i in range(k)]
        self._events: list[dict] = []
        self._faults: dict = {}
        self._total_restarts = 0
        self._reassignments = 0
        self.merge_s = 0.0
        self.watchdog = FrontierWatchdog()
        self._injector = None
        if recovery.inject is not None:
            self._injector = FailureInjector(recovery.inject,
                                             n_windows=self.n_windows)
            bad = [kind for kind in self._injector.schedule.values()
                   if kind not in _INJECTABLE]
            if bad:
                raise ValueError(
                    f"fault kind(s) {sorted(set(bad))} cannot be "
                    "injected at the farm coordinator (process) level;"
                    f" coordinator kinds are {sorted(_INJECTABLE)} — "
                    "engine-internal kinds run under a workers=1 "
                    "Recovery")
        # the model as the workers get it: compiled, so that the standard
        # library's pickle takes it
        system, names, idx = resolve_observables(experiment.model)
        self._worker_exp = experiment.with_(
            model=CompiledModel(system, tuple(names),
                                tuple(tuple(i) for i in idx)),
            sinks=(), recovery=None)

    # ------------------------------------------------------------- api
    def run(self):
        from repro_torch.api.result import SimulationResult

        rec = self.recovery
        t0 = time.perf_counter()
        os.makedirs(rec.ckpt_dir, exist_ok=True)
        if self.experiment.use_kernel and any(
                d.type == "cuda" for d in self.devices):
            # one build before the workers start, not K racing nvcc
            from repro_torch.kernels import build

            build.load()
        slots = [_Slot(i, d) for i, d in enumerate(self.devices)]
        for slot, sh in zip(slots, self.shards):
            slot.shard = sh
        pending: collections.deque = collections.deque()
        done: set = set()
        poll = min(0.2, rec.heartbeat_s / 4.0)
        try:
            while len(done) < len(self.shards):
                now = time.time()
                for slot in slots:
                    if slot.retired or slot.proc is not None:
                        continue
                    if slot.shard is None:
                        if not pending:
                            continue
                        sh = pending.popleft()
                        slot.shard = sh
                        self._reassignments += 1
                        self._log("shard_reassigned", shard=sh.index,
                                  from_worker=sh.owner,
                                  to_worker=slot.index)
                        sh.owner = slot.index
                    if now >= slot.next_start:
                        self._launch(slot)
                if pending and all(s.retired or s.proc is None
                                   and s.shard is None for s in slots):
                    raise RuntimeError(
                        "farm dead: every worker slot is retired "
                        f"({self._total_restarts} restarts) with "
                        f"{len(pending)} shard(s) unfinished; raise "
                        "Recovery.max_worker_restarts or fix the "
                        "underlying fault")
                time.sleep(poll)
                for slot in slots:
                    if slot.proc is None:
                        continue
                    self._poll_slot(slot, pending, done)
        finally:
            for slot in slots:
                if slot.proc is not None:
                    self._kill(slot.proc)
                    slot.proc = None
        wall = time.perf_counter() - t0
        t_merge = time.perf_counter()
        view = self._merge()
        self.merge_s = time.perf_counter() - t_merge
        for sink in self.experiment.sinks:
            view.stream.attach(sink)
            for r in view.stream.records():
                sink(r)
        view.stream.close()
        result = SimulationResult(self.experiment, view)
        result._wall_time = wall
        result._restarts = self._total_restarts
        result._stall_redispatches = sum(
            sh.bundle["_meta"]["report"].get("stall_redispatches", 0)
            for sh in self.shards)
        result._recovery = self._report(slots)
        return result

    # --------------------------------------------------- process layer
    def _write_spec(self, sh: _Shard, device: torch.device) -> None:
        worker_rec = dataclasses.replace(
            self.recovery, workers=1, namespace=sh.namespace,
            inject=None)
        spec = {
            "experiment": self._worker_exp,
            "recovery": worker_rec,
            "shard": (sh.lo, sh.hi, sh.blocks),
            "shard_index": sh.index,
            "heartbeat_path": sh.hb_path,
            "result_path": sh.result_path,
            "device": str(device),
        }
        tmp = f"{sh.spec_path}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(spec, f)
        os.replace(tmp, sh.spec_path)

    def _launch(self, slot: _Slot) -> None:
        import repro_torch

        sh = slot.shard
        try:
            os.remove(sh.hb_path)  # a stale file must not look alive
        except FileNotFoundError:
            pass
        self._write_spec(sh, slot.device)
        env = dict(os.environ)
        src_root = str(Path(repro_torch.__file__).resolve().parents[1])
        env["PYTHONPATH"] = src_root + (
            os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else "")
        log_path = os.path.join(self.recovery.ckpt_dir,
                                f"{sh.namespace}.log")
        with open(log_path, "ab") as logf:
            slot.proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.runtime.worker",
                 sh.spec_path],
                stdout=logf, stderr=subprocess.STDOUT, env=env)
        slot.launch_t = sh.launch_t = time.time()
        if sh.index not in slot.shards_run:
            slot.shards_run.append(sh.index)
        self._log("worker_launched", worker=slot.index, shard=sh.index,
                  pid=slot.proc.pid, attempt=slot.restarts,
                  device=str(slot.device))

    def _poll_slot(self, slot: _Slot, pending, done: set) -> None:
        rec = self.recovery
        sh = slot.shard
        hb = self._read_heartbeat(sh)
        if hb is not None:
            if self.watchdog.observe(sh.index, int(hb.get("window", 0))):
                self._log("frontier_straggler", worker=slot.index,
                          shard=sh.index, window=int(hb["window"]))
            self._maybe_inject(slot, int(hb.get("window", 0)))
        rc = slot.proc.poll()
        if rc is not None:
            slot.proc = None
            bundle = self._load_bundle(sh) if rc == 0 else None
            if bundle is not None:
                sh.bundle = bundle
                done.add(sh.index)
                slot.shard = None
                self.watchdog.forget(sh.index)
                # quiet_s: from the worker's last heartbeat to the poll
                # that saw its exit (the bundle's write and the exit)
                self._log("worker_done", worker=slot.index,
                          shard=sh.index, quiet_s=self._quiet_s(sh))
            else:
                why = (f"exit code {rc}" if rc != 0 else
                       "exit 0 without a verifying result bundle")
                self._fault(slot, pending, "host_lost",
                            f"worker process died ({why})",
                            window=-1 if hb is None
                            else int(hb.get("window", -1)))
            return
        now = time.time()
        grace = max(60.0, 10.0 * rec.heartbeat_s)
        if hb is not None:
            try:
                stale = now - os.path.getmtime(sh.hb_path)
            except OSError:
                return
            # "init" (engine build, restore, the kernel library's load)
            # and "done" (the bundle's write, then the exit past the last
            # beat) are judged by the launch grace, a running worker by
            # the 3 x heartbeat_s contract
            limit = (grace if hb.get("phase") in ("init", "done")
                     else 3.0 * rec.heartbeat_s)
            if stale > limit and now - slot.launch_t > limit:
                self._kill(slot.proc)
                slot.proc = None
                self._fault(slot, pending, "worker_stall",
                            f"heartbeat stale for {stale:.1f}s in phase "
                            f"{hb.get('phase')} (limit {limit:.1f}s, "
                            f"heartbeat_s={rec.heartbeat_s})",
                            window=int(hb.get("window", -1)))
        elif now - slot.launch_t > grace:
            # never wrote a first heartbeat: hung before liveness
            self._kill(slot.proc)
            slot.proc = None
            self._fault(slot, pending, "worker_stall",
                        "no heartbeat after launch grace", window=-1)

    def _fault(self, slot: _Slot, pending, kind: str, msg: str,
               window: int) -> None:
        rec = self.recovery
        sh = slot.shard
        self._faults[kind] = self._faults.get(kind, 0) + 1
        self._log("fault", kind=kind, worker=slot.index,
                  shard=sh.index, window=window, error=msg)
        try:
            os.remove(sh.hb_path)
        except FileNotFoundError:
            pass
        slot.restarts += 1
        self._total_restarts += 1
        if slot.restarts > rec.max_worker_restarts:
            slot.retired = True
            slot.shard = None
            pending.append(sh)
            self._log("worker_retired", worker=slot.index,
                      shard=sh.index, restarts=slot.restarts)
        else:
            backoff = (min(rec.backoff_max_s,
                           rec.backoff_base_s * 2 ** (slot.restarts - 1))
                       if rec.backoff_base_s > 0 else 0.0)
            slot.next_start = time.time() + backoff
            self._log("restart_scheduled", worker=slot.index,
                      shard=sh.index, backoff_s=backoff,
                      attempt=slot.restarts)

    @staticmethod
    def _kill(proc: subprocess.Popen) -> None:
        # CONT first: a SIGSTOPped child must still die on KILL (and a
        # stopped process's CUDA context is torn down only by its death)
        for sig in (signal.SIGCONT, signal.SIGKILL):
            try:
                proc.send_signal(sig)
            except (ProcessLookupError, OSError):
                pass
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass

    @staticmethod
    def _quiet_s(sh: _Shard) -> Optional[float]:
        try:
            return round(time.time() - os.path.getmtime(sh.hb_path), 3)
        except OSError:
            return None

    def _read_heartbeat(self, sh: _Shard) -> Optional[dict]:
        try:
            with open(sh.hb_path) as f:
                return json.loads(f.read())
        except (FileNotFoundError, json.JSONDecodeError, OSError):
            return None

    def _load_bundle(self, sh: _Shard) -> Optional[dict]:
        try:
            arrays = ckpt_store.verify(
                sh.result_path,
                required=("window", "grid", "final_x", "meta"))
        except (ckpt_store.CheckpointCorrupt, FileNotFoundError):
            return None
        if int(arrays["window"]) != self.n_windows:
            return None
        arrays["_meta"] = json.loads(str(arrays.pop("meta")))
        return arrays

    # -------------------------------------------------- fault injection
    def _maybe_inject(self, slot: _Slot, frontier: int) -> None:
        if self._injector is None or slot.proc is None:
            return
        for w in sorted(self._injector.schedule):
            if w > frontier:
                break
            kind = self._injector.maybe_fail(w)
            if kind is None:
                continue
            self._log("fault_injected", kind=kind, window=w,
                      worker=slot.index, shard=slot.shard.index)
            mode = _INJECTABLE[kind]
            if mode in ("kill", "corrupt"):
                # kill FIRST: truncating while the worker lives races a
                # cadence save that could replace the corrupt file
                self._kill(slot.proc)
                if mode == "corrupt":
                    self._corrupt_newest(slot.shard)
            elif mode == "stop":
                try:
                    slot.proc.send_signal(signal.SIGSTOP)
                except (ProcessLookupError, OSError):
                    pass
            return  # at most one injection per poll

    def _corrupt_newest(self, sh: _Shard) -> None:
        ckpts = ckpt_store.list_checkpoints(self.recovery.ckpt_dir,
                                            sh.namespace)
        if not ckpts:
            return
        _, path = ckpts[-1]
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))

    # ----------------------------------------------------------- merge
    def _merge(self):
        return merge_bundles(
            self.experiment, [sh.bundle for sh in self.shards],
            self.devices[0], watchdog_flagged=list(self.watchdog.flagged))

    # ---------------------------------------------------------- report
    def _report(self, slots) -> dict:
        metas = [sh.bundle["_meta"] for sh in self.shards]
        return {
            "workers": self.recovery.workers,
            "restarts": self._total_restarts,
            "faults_by_kind": dict(self._faults),
            "reassignments": self._reassignments,
            "pipeline_depth_effective": max(
                m["telemetry"]["pipeline_depth_effective"] for m in metas),
            "frontier_stragglers": list(self.watchdog.flagged),
            "per_worker": {
                s.index: {"restarts": s.restarts, "retired": s.retired,
                          "shards_run": list(s.shards_run),
                          "device": str(s.device)}
                for s in slots},
            "worker_reports": {
                sh.index: m["report"] for sh, m in zip(self.shards, metas)},
            # the supervisor's run wall per shard (its last attempt: the
            # engine's build and restore, the windows, the saves); the
            # process's lifetime less this is the worker's start-up
            # (interpreter, imports, the spec, the device's context)
            "worker_walls": {
                sh.index: m["telemetry"]["wall_time_s"]
                for sh, m in zip(self.shards, metas)},
            "worker_lifetimes": {
                sh.index: m["t_done"] - sh.launch_t
                for sh, m in zip(self.shards, metas)},
            # of a lifetime: the interpreter and imports, then the spec's
            # load and the device's context (wall clock, s)
            "worker_startup": {
                sh.index: {"imports_s": m["t_main"] - sh.launch_t,
                           "device_s": m["t_device"] - m["t_main"]}
                for sh, m in zip(self.shards, metas)},
            "kernel_launches": {
                sh.index: m["kernel_launches"]
                for sh, m in zip(self.shards, metas)},
            # each worker's heartbeat timing (its last attempt): the
            # longest span between two writes by phase, the longest write
            "heartbeats": {
                sh.index: m.get("heartbeat")
                for sh, m in zip(self.shards, metas)},
            "merge_s": self.merge_s,
            "events": list(self._events),
        }

    def _log(self, event: str, **detail) -> None:
        self._events.append({"event": event,
                             "t": round(time.time(), 3), **detail})


# -------------------------------------------------------------- merge
def merge_bundles(experiment, bundles: list, device,
                  watchdog_flagged=()) -> "_FarmEngineView":
    """The finished run from the workers' result bundles, in global shard
    order: the block partial stacks concatenated in global block order
    and folded on `device` by `_pack_window`'s ops (merge_blocks +
    finalize), the grouped partials through the zero-extended global
    (V, G) stack, sketch counts added (pooled) or concatenated (per
    point), trajectories and final populations concatenated, steering
    reports merged. Takes either package's bundles."""
    metas = [b["_meta"] for b in bundles]
    grid = np.asarray(bundles[0]["grid"])
    w_total = len(grid)
    stream = StatsStream()
    if all("bp_n" in b for b in bundles):
        # (W, V, n_obs) per leaf; the fold runs over the block axis,
        # every window at once (elementwise ops: the same bits as one
        # window at a time)
        acc = reduction.Welford(*(torch.as_tensor(np.concatenate(
            [b[f"bp_{f}"] for b in bundles], axis=1).swapaxes(0, 1).copy(),
            device=device) for f in ("n", "mean", "m2")))
        st = reduction.finalize(reduction.merge_blocks(acc))
        n, mean, var, ci90 = (leaf.cpu().numpy() for leaf in st)
        for w in range(w_total):
            stream.emit(StatsRecord(
                t=float(grid[w]), window=w, mean=mean[w], var=var[w],
                ci90=ci90[w], n=float(n[w].max())))
    grouped: list = []
    if all("gp_n" in b for b in bundles):
        v_tot = sum(b["gp_n"].shape[1] for b in bundles)
        g_tot = sum(b["gp_n"].shape[2] for b in bundles)
        tail = bundles[0]["gp_n"].shape[3:]
        full = np.zeros((3, v_tot, w_total, g_tot) + tail, np.float32)
        v0 = g0 = 0
        for b in bundles:
            vk, gk = b["gp_n"].shape[1:3]
            for i, f in enumerate(("n", "mean", "m2")):
                full[i, v0:v0 + vk, :, g0:g0 + gk] = \
                    b[f"gp_{f}"].swapaxes(0, 1)
            v0 += vk
            g0 += gk
        st = reduction.finalize(reduction.merge_blocks(reduction.Welford(
            *torch.as_tensor(full, device=device))))
        leaves = [leaf.cpu().numpy() for leaf in st]
        grouped = [reduction.Stats(*(leaf[w] for leaf in leaves))
                   for w in range(w_total)]
    sketches: list = []
    if all("sketch_hist" in b for b in bundles):
        pooled = not grouped  # one group everywhere: counts add
        for w in range(w_total):
            hists = [b["sketch_hist"][w] for b in bundles]
            rares = ([b["sketch_rare"][w] for b in bundles]
                     if all("sketch_rare" in b for b in bundles)
                     else None)
            if pooled:
                hist = np.sum(hists, axis=0, dtype=np.int32)
                rare = (np.sum(rares, axis=0, dtype=np.int32)
                        if rares is not None else None)
            else:
                hist = np.concatenate(hists, axis=0)
                rare = (np.concatenate(rares, axis=0)
                        if rares is not None else None)
            sketches.append(WindowSketch(hist=hist, rare=rare))
    samples = (np.concatenate([b["samples"] for b in bundles], axis=0)
               if all("samples" in b for b in bundles) else None)
    sketch_params = (SimpleNamespace(
        lo=np.asarray(bundles[0]["sketch_lo"]),
        width=np.asarray(bundles[0]["sketch_width"]))
        if "sketch_lo" in bundles[0] else None)
    final_x = np.concatenate([b["final_x"] for b in bundles], axis=0)
    return _FarmEngineView(
        experiment=experiment, grid=grid, stream=stream, grouped=grouped,
        sketches=sketches, samples=samples, final_x=final_x, metas=metas,
        sketch_params=sketch_params, device=torch.device(device),
        steering=_merge_steering(
            metas, experiment.ensemble.replicas, w_total),
        watchdog_flagged=list(watchdog_flagged))


def _merge_steering(metas: list, replicas: int,
                    n_windows: int) -> Optional[dict]:
    """The workers' steering reports merged into the report the
    single-process run gives. Each worker steers its own whole sweep
    points, so its decisions ARE the global ones restricted to its
    points: stop entries concatenate (point indices offset by the
    worker's first point, in shard order, as the single scan lists
    them), no_leap entries add their lane counts per window with
    `total_pinned` rebuilt from each worker's latest cumulative count."""
    reps = [m.get("steering") for m in metas]
    if all(r is None for r in reps):
        return None
    p0s = [m["lo"] // replicas for m in metas]
    stop: dict = {}
    noleap: dict = {}
    bimodal: list = []
    for wk, (rep, p0) in enumerate(zip(reps, p0s)):
        if rep is None:
            continue
        for d in rep["decisions"]:
            if d["action"] == "stop":
                stop.setdefault(d["window"], []).append(
                    ([p + p0 for p in d["points"]], d["rel_ci"]))
            elif d["action"] == "no_leap":
                noleap.setdefault(d["window"], []).append((wk, d))
        for f in rep.get("bimodal_flags", []):
            bimodal.append({"window": f["window"],
                            "point": f["point"] + p0, "obs": f["obs"]})
    decisions: list = []
    totals = [0] * len(metas)
    for w in sorted(set(stop) | set(noleap)):
        if w in stop:  # the policy logs stops before no_leap pins
            pts: list = []
            ci: list = []
            for p_list, ci_list in stop[w]:
                pts += p_list
                ci += ci_list
            decisions.append({"window": w, "action": "stop",
                              "points": pts, "rel_ci": ci})
        if w in noleap:
            n_new = 0
            for wk, d in noleap[w]:
                totals[wk] = d["total_pinned"]
                n_new += d["n_lanes"]
            decisions.append({"window": w, "action": "no_leap",
                              "n_lanes": n_new,
                              "total_pinned": sum(totals)})
    bimodal.sort(key=lambda f: (f["window"], f["point"], f["obs"]))
    stop_windows: dict = {}
    stopped: list = []
    total = simulated = 0
    pinned = 0
    for rep, p0 in zip(reps, p0s):
        if rep is None:
            continue
        total += rep["point_windows_total"]
        simulated += rep["point_windows_simulated"]
        pinned += rep["lanes_pinned_exact"]
        stopped += [p + p0 for p in rep["stopped_points"]]
        for p, w in rep["stop_windows"].items():
            stop_windows[int(p) + p0] = int(w)
    stopped.sort()
    return {
        "n_points": sum(r["n_points"] for r in reps if r is not None),
        "stopped_points": stopped,
        "stop_windows": {p: stop_windows[p] for p in sorted(stop_windows)},
        "point_windows_total": total,
        "point_windows_simulated": simulated,
        "windows_saved_ratio": (total / simulated if simulated
                                else float(total)),
        "lanes_pinned_exact": pinned,
        "bimodal_flags": bimodal,
        "decisions": decisions,
    }


class _FarmEngineView:
    """A merged, finished engine stand-in: what the port's
    SimulationResult reads (records, per-point stats, trajectories,
    final populations, sketches, the steering report, telemetry), fed
    from the workers' merged bundles. It runs no further window:
    `resume()` on the handle finds the run complete, and `checkpoint()`
    is refused."""

    def __init__(self, experiment, grid, stream, grouped, sketches,
                 samples, final_x, metas, sketch_params, device, steering,
                 watchdog_flagged):
        self.grid = grid
        self.device = device
        self._sketch = sketch_params
        self.stream = stream
        self.obs_names = list(metas[0]["obs_names"])
        self.cfg = SimpleNamespace(window_block=experiment.window_block)
        self._steer = None
        self._window = len(grid)
        self._pool = SimpleNamespace(x=torch.from_numpy(final_x))
        self._grouped = grouped
        self._sketches = sketches
        self._samples = samples
        self._steering = steering
        tels = [m["telemetry"] for m in metas]
        w = len(grid)
        self.peak_buffered_bytes = max(
            t["peak_buffered_bytes"] for t in tels)
        self.n_dispatches = sum(t["dispatches"] for t in tels)
        self.n_host_syncs = sum(t["host_syncs"] for t in tels)
        # per-window step/leap counts merge only when every worker has
        # the whole series (a restart trims it)
        if all(len(t["steps_per_window"]) == w for t in tels):
            self.window_steps = [
                sum(col) & 0xFFFFFFFF
                for col in zip(*(t["steps_per_window"] for t in tels))]
            self.window_leaps = [
                sum(col) & 0xFFFFFFFF
                for col in zip(*(t["leaps_per_window"] for t in tels))]
        else:
            self.window_steps = []
            self.window_leaps = []
        observed = sum(t["watchdog_observed"] for t in tels)
        flagged = sorted(
            (tuple(f) for t in tels for f in t["straggler_windows"]),
            key=lambda f: f[0])
        self.watchdog = SimpleNamespace(
            flagged=flagged + [("frontier",) + tuple(f)
                               for f in watchdog_flagged],
            straggler_rate=lambda: (len(flagged) / observed
                                    if observed else 0.0))
        self.block_walls = sorted(
            (tuple(bw) for t in tels for bw in t["block_walls"]),
            key=lambda b: b[0])
        self.pipeline_depth = max(t["pipeline_depth"] for t in tels)
        self.pipeline_depth_effective = max(
            t["pipeline_depth_effective"] for t in tels)
        self.peak_inflight_blocks = max(
            t["peak_inflight_blocks"] for t in tels)
        self.n_snapshot_saves = sum(t["snapshot_saves"] for t in tels)
        self.n_ckpt_flushes = sum(t["ckpt_flushes"] for t in tels)

    # ----------------------------------------------- result interface
    def flush(self) -> None:
        pass  # nothing in flight: the farm merged finished bundles

    def trajectories(self):
        return self._samples

    def grouped_stats(self):
        return list(self._grouped)

    def sketches(self):
        return list(self._sketches)

    def steering_report(self):
        return self._steering

    def checkpoint(self, path: str) -> None:
        raise RuntimeError(
            "a farm result is already complete and has no live pool to "
            "checkpoint; per-worker checkpoints live under "
            "Recovery.ckpt_dir namespaces")
