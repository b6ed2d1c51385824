"""Farm worker process — one ensemble shard under a RunSupervisor; port
of `repro/runtime/worker.py`.

Launched by `runtime.coordinator.FarmCoordinator` as
``python -m repro_torch.runtime.worker <spec.pkl>``. The spec (standard
library pickle) carries the Experiment with its model compiled
(`CompiledModel`; sinks and recovery stripped), this worker's shard
``(lo, hi, stat_blocks)``, a per-shard Recovery whose `namespace` keys
its checkpoints inside the SHARED ckpt_dir, the heartbeat and result
paths, and the device it runs on.

The worker is the single-process machinery rebased onto a slice of the
global ensemble:

* the engine is built through `api.run.build_engine(shard=...)`: same
  seed and options, instance rows [lo, hi), key rows from the GLOBAL
  key table (counter-based streams do not depend on a lane's position,
  so lane i runs the trajectory it runs in the single-process run),
  rates and group ids sliced to the range, block partials on;
* `RunSupervisor` drives it with cadenced namespaced checkpoints; faults
  of the engine recover in-process, the death of the process is the
  coordinator's to handle;
* a daemon thread writes newline-terminated JSON heartbeats (window
  frontier, checkpoint frontier, straggler rate, phase) every
  ``heartbeat_s / 2``; a SIGSTOP freezes it, which is how the
  coordinator sees a stalled worker;
* at the end it writes an atomic, checksummed result bundle
  (`ckpt.store.save_atomic`): the per-window Welford partial stacks for
  the bitwise merge, grouped, sketch and trajectory slices, the final
  populations and a JSON meta blob (supervisor report, telemetry,
  steering report, the kernels' launch counts). A worker relaunched
  after it finished restores its final checkpoint, falls through the
  drive loop and writes the same bundle again.

A worker sent to a CUDA device that finds none fails; it never runs on
the CPU instead.
"""
from __future__ import annotations

import json
import os
import pickle
import sys
import threading
import time

import numpy as np
import torch

from repro_torch.ckpt import store as ckpt_store
from repro_torch.runtime.supervisor import Recovery, RunSupervisor


def _write_json_atomic(path: str, payload: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(payload) + "\n")
    os.replace(tmp, path)


def kernel_launches() -> dict:
    """Each kernel wrapper's launch count in this process."""
    from repro_torch.kernels import propensity, ssa_step

    return {name: int(fn.launches) for name, fn in (
        ("ssa_window", ssa_step.ssa_window_call),
        ("sparse_window", ssa_step.sparse_window_call),
        ("tau_window", ssa_step.tau_window_call),
        ("sparse_tau_window", ssa_step.sparse_tau_window_call),
        ("propensity", propensity.propensity_call))}


class WorkerSupervisor(RunSupervisor):
    """RunSupervisor over one shard: builds the engine through the shard
    seam (global key rows, sliced rates and groups, partials on) on its
    device, and feeds the heartbeat from the drive loop. device as for
    RunSupervisor: None is the CUDA device, and raises without one."""

    def __init__(self, experiment, recovery: Recovery, shard: tuple,
                 shard_index: int, heartbeat_path: str, device=None):
        super().__init__(experiment, recovery, device=device)
        self._shard = tuple(shard)
        self._shard_index = int(shard_index)
        self._hb_path = heartbeat_path
        self._hb_lock = threading.Lock()
        # "init" covers the engine build, the first restore and the
        # kernel library's load, which can hold the GIL long enough to
        # starve the heartbeat thread: the coordinator judges it by the
        # launch grace until "run"
        self._hb_state = {"shard": self._shard_index, "pid": os.getpid(),
                          "window": 0, "ckpt_window": -1,
                          "straggler_rate": 0.0, "phase": "init"}
        self._hb_stop = threading.Event()
        # the heartbeat's own timing, for the bundle's meta: the longest
        # span between two finished writes by the phase of the later one
        # (what the coordinator's staleness check sees) and the longest
        # write
        self._hb_last = None
        self._hb_max_gap: dict = {}
        self._hb_max_write = 0.0

    # ------------------------------------------------------- heartbeat
    def write_heartbeat(self) -> None:
        with self._hb_lock:
            payload = dict(self._hb_state, time=time.time())
        t0 = time.time()
        _write_json_atomic(self._hb_path, payload)
        t1 = time.time()
        with self._hb_lock:
            if self._hb_last is not None:
                phase = payload["phase"]
                self._hb_max_gap[phase] = max(
                    self._hb_max_gap.get(phase, 0.0), t1 - self._hb_last)
            self._hb_last = t1
            self._hb_max_write = max(self._hb_max_write, t1 - t0)

    def heartbeat_timing(self) -> dict:
        with self._hb_lock:
            return {"max_gap_s": dict(self._hb_max_gap),
                    "max_write_s": self._hb_max_write}

    def start_heartbeat(self) -> None:
        self.write_heartbeat()  # announce liveness before the run

        def beat():
            while not self._hb_stop.wait(self.recovery.heartbeat_s / 2):
                self.write_heartbeat()

        threading.Thread(target=beat, daemon=True).start()

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()

    def _progress(self, engine) -> None:
        with self._hb_lock:
            self._hb_state.update(
                window=engine._window,
                ckpt_window=self._ckpt_frontier,
                straggler_rate=engine.watchdog.straggler_rate(),
                phase="run")

    # ----------------------------------------------------------- build
    def _build(self):
        from repro_torch.api.run import build_engine

        exp = self.experiment.with_(sinks=(), recovery=None,
                                    partitioning=None)
        engine = build_engine(exp, device=self.device, shard=self._shard)
        engine.enable_block_partials()
        return engine


def _result_bundle(result, sup: WorkerSupervisor, started: dict) -> dict:
    eng = result._engine
    arrays = {
        "window": np.int64(eng._window),
        "grid": np.asarray(eng.grid, np.float64),
        "final_x": eng._pool.x.cpu().numpy(),
    }
    for prefix, parts in (("bp", eng._block_partials),
                          ("gp", eng._grouped_partials)):
        if parts:
            for i, name in enumerate(("n", "mean", "m2")):
                arrays[f"{prefix}_{name}"] = np.stack([p[i] for p in parts])
    traj = eng.trajectories()
    if traj is not None:
        arrays["samples"] = traj
    grouped = eng.grouped_stats()
    if grouped:
        for name in ("n", "mean", "var", "ci90"):
            arrays[f"grouped_{name}"] = np.stack(
                [getattr(g, name) for g in grouped])
    sketches = eng.sketches()
    if sketches:
        arrays["sketch_hist"] = np.stack([s.hist for s in sketches])
        if sketches[0].rare is not None:
            arrays["sketch_rare"] = np.stack([s.rare for s in sketches])
    if eng._sketch is not None:  # bin geometry for later quantiles
        arrays["sketch_lo"] = np.asarray(eng._sketch.lo)
        arrays["sketch_width"] = np.asarray(eng._sketch.width)
    tele = result.telemetry
    meta = {
        "shard": sup._shard_index,
        "lo": sup._shard[0], "hi": sup._shard[1],
        "obs_names": list(eng.obs_names),
        "report": sup.report(),
        "steering": eng.steering_report(),
        "device": str(eng.device),
        "kernel_launches": kernel_launches(),
        "heartbeat": sup.heartbeat_timing(),
        # wall clock (s) at the start of run_worker (the interpreter and
        # the imports done), with the device up, and now
        **started, "t_done": time.time(),
        "telemetry": {
            "wall_time_s": tele.wall_time_s,
            # the bundle format both packages' coordinators merge: the
            # reference's reads per-window walls, which the port does
            # not keep (a profiler's trace of the engine's spans has them)
            "window_wall_times": [],
            "peak_buffered_bytes": int(tele.peak_buffered_bytes),
            "dispatches": int(tele.dispatches),
            "host_syncs": int(tele.host_syncs),
            "steps_per_window": [int(v) for v in tele.steps_per_window],
            "leaps_per_window": [int(v) for v in tele.leaps_per_window],
            "straggler_windows": [list(v) for v in
                                  tele.straggler_windows],
            "watchdog_observed": int(eng.watchdog.observed),
            "block_walls": [list(v) for v in tele.block_walls],
            "pipeline_depth": int(tele.pipeline_depth),
            "pipeline_depth_effective": int(
                tele.pipeline_depth_effective),
            "peak_inflight_blocks": int(tele.peak_inflight_blocks),
            "snapshot_saves": int(tele.snapshot_saves),
            "ckpt_flushes": int(tele.ckpt_flushes),
            "restarts": int(tele.restarts),
            "stall_redispatches": int(tele.stall_redispatches),
        },
    }
    arrays["meta"] = np.array(json.dumps(meta))
    return arrays


def run_worker(spec_path: str) -> int:
    started = {"t_main": time.time()}
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    device = torch.device(spec["device"])
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"farm worker for shard {spec['shard_index']} was sent to "
                f"{device} and finds no CUDA device; it does not fall back "
                "to the CPU")
        torch.cuda.set_device(device)
        torch.empty(0, device=device)  # the CUDA context, made here
    started["t_device"] = time.time()
    sup = WorkerSupervisor(
        spec["experiment"], spec["recovery"], spec["shard"],
        spec["shard_index"], spec["heartbeat_path"], device=device)
    sup.start_heartbeat()
    try:
        result = sup.run()
        # a last heartbeat with the finished frontier, then the bundle
        sup._hb_state.update(window=result.windows_run, phase="done")
        sup.write_heartbeat()
        ckpt_store.save_atomic(spec["result_path"],
                               _result_bundle(result, sup, started))
    finally:
        sup.stop_heartbeat()
    return 0


def main(argv) -> int:
    if len(argv) != 1:
        print("usage: python -m repro_torch.runtime.worker <spec.pkl>",
              file=sys.stderr)
        return 2
    return run_worker(argv[0])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
