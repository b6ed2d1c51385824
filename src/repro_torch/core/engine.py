"""SimulationEngine — the windowed ensemble simulator; port of
`repro/core/engine.py`.

Runs an ensemble of stochastic CWC simulations (replicas and/or a
parameter sweep) under one of the paper's three schemas:

  schema "i"   static farm, post-hoc reduction (baseline)
  schema "ii"  time-sliced self-balancing farm, post-hoc reduction
  schema "iii" time-sliced farm + on-line windowed reduction

Each window advances the whole instance pool (core/dispatch.py): with
`use_kernel=True` through a fused CUDA window, one kernel launch per
window; otherwise through the unfused group loop; with `host_loop=True`
through the reference's per-group baseline. `sparse=True` switches
them to the sparse exact step (dependency-graph propensity updates, no
S/R cap of the dense kernel, any reactant coefficient). All give the
same bits. `method="tau_leap"` runs adaptive tau-leaping
(core/tau_leap.py) instead of exact SSA on every one of these paths,
again with the same bits on all. The window's statistics, step/leap
counters and the kernel's truncation flag then come to the host in ONE
combined device-to-host copy, and a `StatsRecord` is emitted.

Supersteps (`window_block=W`): W windows are queued as one dispatch
(`FusedDispatch.advance_block`) whose per-window products are packed
into an on-device ring; the ring is copied into pinned host memory by a
non-blocking copy, followed by a CUDA event. The depth-K collector
(`pipeline_depth`, "auto" to probe) keeps up to K blocks in flight
before it waits on the oldest block's event — one host sync per block —
and emits that block's records. Records are bitwise identical for any W
and K. Ring snapshots (`enable_snapshots`) let `checkpoint()` save the
collected frontier while blocks stay in flight: the save copies the
snapshot's pool on a side stream that waits only for that pool, not for
the blocks queued after it. `checkpoint()` and `restore()` write and
read the reference's single-file format, so either package restores
the other's files.

Not ported yet (each raises in `repro_torch.api` before an engine is
built): sketches, steering, supervision and multi-shard partitioning.
"""
from __future__ import annotations

import collections
import math
import time
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.ckpt import store as ckpt_store
from repro_torch.core import reduction
from repro_torch.core.cwc.compile import compile_model
from repro_torch.core.cwc.rules import CWCModel
from repro_torch.core.device import resolve_device, to_device
from repro_torch.core.dispatch import FusedDispatch, HostLoopDispatch
from repro_torch.core.gillespie import (
    LaneState,
    init_lanes,
    sparse_system_tensors,
    system_tensors,
)
from repro_torch.core.reactions import ReactionSystem, sparse_tables
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.stream import StatsRecord, StatsStream
from repro_torch.core.tau_leap import tau_tables

SCHEMAS = ("i", "ii", "iii")
POLICIES = ("static_rr", "on_demand", "predictive")
METHODS = ("exact", "tau_leap")


@dataclass(frozen=True)
class SimConfig:
    n_instances: int = 128
    t_end: float = 10.0
    n_windows: int = 50
    n_lanes: int = 128  # width of a scheduler lane group
    schema: str = "iii"  # i | ii | iii
    policy: str = "on_demand"  # static_rr | on_demand | predictive
    seed: int = 0
    max_steps_per_window: Optional[int] = None
    use_kernel: bool = False  # the fused CUDA SSA window (kernels/)
    host_loop: bool = False  # the per-group gather/advance/scatter baseline
    sparse: bool = False  # the sparse exact step (dependency graph)
    # the kernel path's per-window event budget: chunk_steps * max_chunks
    # events per lane in one launch; a window needing more raises
    # FusedWindowTruncated (never silently truncates)
    kernel_chunk_steps: int = 256
    kernel_max_chunks: int = 64
    stat_blocks: int = 1  # contiguous blocks of the Welford merge tree
    # simulation algorithm: "exact" (Gillespie's direct SSA) or
    # "tau_leap" (adaptive Cao tau, Poisson reaction counts, per-lane
    # exact fallback — core/tau_leap.py)
    method: str = "exact"
    tau_eps: float = 0.03  # Cao bound: max relative propensity drift
    tau_fallback: float = 10.0  # leap only when tau covers >= this
    #   many expected SSA events (else one exact step)
    # superstep width: this many windows queued as ONE dispatch, their
    # records packed into an on-device ring and pulled per block by the
    # pipelined collector; 1 is the per-window path. Records are
    # bitwise identical for any value.
    window_block: int = 1
    # blocks that may sit in flight (ring pull outstanding) after each
    # collector turn before the oldest is collected; "auto" probes the
    # first collected block (resolve_auto_depth). Changes only WHEN
    # rings are pulled, never what was computed.
    pipeline_depth: Union[int, str] = 1
    # host-side invariant checks on the statistics the collector has
    # already pulled (non-finite moments, negative means, ring/record
    # count disagreement): no extra device syncs
    guards: bool = True

    def __post_init__(self):
        if self.window_block < 1:
            raise ValueError(
                f"SimConfig.window_block must be >= 1, got "
                f"{self.window_block}")
        if self.window_block > 1 and self.host_loop:
            raise ValueError(
                "window_block > 1 needs the fused or sharded dispatch "
                "strategy; host_loop is the per-window round-trip "
                "baseline (set window_block=1)")
        if isinstance(self.pipeline_depth, str):
            if self.pipeline_depth != "auto":
                raise ValueError(
                    f"SimConfig.pipeline_depth must be an int >= 1 or "
                    f"'auto', got {self.pipeline_depth!r}")
        elif self.pipeline_depth < 1:
            raise ValueError(
                f"SimConfig.pipeline_depth must be >= 1, got "
                f"{self.pipeline_depth}")
        if self.schema not in SCHEMAS:
            raise ValueError(f"SimConfig.schema must be one of {SCHEMAS}, "
                             f"got {self.schema!r}")
        if self.policy not in POLICIES:
            raise ValueError(f"SimConfig.policy must be one of "
                             f"{POLICIES}, got {self.policy!r}")
        for name in ("kernel_chunk_steps", "kernel_max_chunks",
                     "stat_blocks", "n_lanes", "n_windows"):
            if getattr(self, name) < 1:
                raise ValueError(f"SimConfig.{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        if self.n_instances % self.stat_blocks:
            raise ValueError(
                f"n_instances ({self.n_instances}) must divide evenly "
                f"into stat_blocks ({self.stat_blocks}) blocks")
        if self.method not in METHODS:
            raise ValueError(
                f"SimConfig.method must be 'exact' or 'tau_leap', got "
                f"{self.method!r}")
        if not self.tau_eps > 0:
            raise ValueError(
                f"SimConfig.tau_eps must be > 0, got {self.tau_eps}")
        if self.tau_fallback < 0:
            raise ValueError(
                f"SimConfig.tau_fallback must be >= 0, got "
                f"{self.tau_fallback}")


# pipeline_depth="auto" bounds: the floor keeps at least one queued
# block behind the one being collected; the cap bounds memory (each
# in-flight block holds its ring, and its snapshot when enabled)
AUTO_DEPTH_MIN = 2
AUTO_DEPTH_MAX = 8


def resolve_auto_depth(pull_s: float, host_s: float) -> int:
    """Pick a pipeline depth from the first collected block's profile.

    `pull_s` is the blocking ring-pull wall with a cold pipeline (a
    proxy for one block's remaining device+transfer time when the
    collector asks) and `host_s` the collector's host-side reduce/emit
    wall for that block. Queueing K blocks gives the device ~K blocks
    of runway while the host works, so the depth that hides the host
    work is 1 + ceil(host_s / pull_s), clamped to [AUTO_DEPTH_MIN,
    AUTO_DEPTH_MAX]. Results are bitwise identical for any outcome.
    """
    if pull_s <= 0:
        return AUTO_DEPTH_MIN
    return max(AUTO_DEPTH_MIN,
               min(AUTO_DEPTH_MAX, 1 + math.ceil(host_s / pull_s)))


class _InFlight(NamedTuple):
    """One dispatched-but-uncollected superstep in the pipeline."""
    w0: int  # first window of the block
    n_win: int  # windows in the block
    pull: dict  # the ring on the host (pinned on the card), being filled
    done: Optional[torch.cuda.Event]  # recorded after the ring's copies
    #   on the card; None on the CPU, where the ring is host memory
    dispatch_wall: float  # host wall to ENQUEUE the block (async)
    obs_row_bytes: int  # one window's obs footprint (schema-iii acct)
    ring_bytes: int  # the queued ring (+ snapshot) footprint
    snapshot: Optional[LaneState]  # the pool at this block's entry,
    #   held by reference (nothing writes a pool leaf in place, see
    #   core/dispatch.py) — lets checkpoint() save this block's entry
    #   boundary while it is still in flight
    snap_ready: Optional[torch.cuda.Event]  # recorded before the block's
    #   launches: the snapshot's leaves are complete once it has run


class InvariantViolation(RuntimeError):
    """A host-side guard on the pulled window statistics tripped; the
    pool state is untrusted from this window on."""

    def __init__(self, msg: str, window: int, check: str):
        super().__init__(msg)
        self.window = window
        self.check = check


def resolve_observables(model):
    """(system, obs_names, obs_idx) for a model — the single source of
    the observable-column derivation (engine and api share it)."""
    if isinstance(model, CWCModel):
        system, meta = compile_model(model)
        names = list(meta["observables"]) or list(meta["species"])
        idx = [v for v in meta["observables"].values()] or [
            [i] for i in range(system.n_species)]
    else:
        system = model
        names = list(model.species_names)
        idx = [[i] for i in range(model.n_species)]
    return system, names, idx


class SimulationEngine:
    def __init__(self, model, cfg: SimConfig, rates=None,
                 group_ids=None, record_trajectories: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.system, self.obs_names, self.obs_idx = resolve_observables(
            model)
        self.cfg = cfg
        self.grid = np.linspace(cfg.t_end / cfg.n_windows, cfg.t_end,
                                cfg.n_windows)
        self.stream = StatsStream()
        self.scheduler = Scheduler(
            cfg.n_instances, min(cfg.n_lanes, cfg.n_instances),
            policy=("static_rr" if cfg.schema == "i" else cfg.policy))
        # the dense comb unroll's MAX_COEF ceiling binds only when the
        # dense step runs
        self._tensors_base = system_tensors(self.system, device=self.device,
                                            require_dense=not cfg.sparse)
        self._sparse_tensors = (sparse_system_tensors(
            sparse_tables(self.system), device=self.device)
            if cfg.sparse and cfg.method == "exact" else None)
        # the method seam: tau-leaping's tables (dense or sparse form),
        # None for exact SSA
        self._tau_tables = (tau_tables(self.system, sparse=cfg.sparse,
                                       device=self.device)
                            if cfg.method == "tau_leap" else None)
        # shared rates stay (R,) on the device (the kernel keeps them in
        # shared memory); a sweep installs an (I, R) matrix
        self.rates = np.broadcast_to(
            self.system.rates, (cfg.n_instances, self.system.n_reactions))
        self._rates_dev = self._tensors_base[3]
        self._dispatch: Optional[FusedDispatch] = None
        if rates is not None:
            self.set_rates(rates)
        self._window = 0
        # superstep pipeline (window_block > 1): windows DISPATCHED run
        # ahead of windows COLLECTED (records emitted); each in-flight
        # block's ring waits in `_pending` until its one blocking pull
        self._dispatched = 0
        self._pending: collections.deque = collections.deque()
        # resolved in-flight block budget (None while "auto" awaits its
        # first-collect probe) and the probe's measurements
        self._depth: Optional[int] = (
            None if cfg.pipeline_depth == "auto"
            else int(cfg.pipeline_depth))
        self.depth_probe: Optional[dict] = None
        self.peak_inflight_blocks = 0
        # ring snapshots (opt-in, enable_snapshots) and the checkpoint
        # counters: saves served from a snapshot, saves that flushed
        self._snap_enabled = False
        self.n_snapshot_saves = 0
        self.n_ckpt_flushes = 0
        # one (wall s, in-flight blocks still running when it ended) per
        # save: the blocking wait for the saved pool's copy to the host
        self.ckpt_pulls: list[tuple[float, int]] = []
        self._save_staging: Optional[tuple] = None
        # the aligned ENTRY snapshot (w0, pool) of a block cut short by
        # a max_windows limit: checkpoint() rolls a mid-block save back
        # to it, so the file restores under the run's own window_block
        self._aligned_snap: Optional[tuple] = None
        self._record_trajectories = record_trajectories
        self._samples: list = []
        self._peak_buffered = 0
        self.wall_times: list[float] = []
        self.block_walls: list[tuple] = []
        # telemetry: window dispatches and blocking device->host pulls
        self.n_dispatches = 0
        self.n_host_syncs = 0
        self.window_steps: list[int] = []
        self.window_leaps: list[int] = []
        self._cum_steps = 0
        self._cum_leaps = 0
        self._group_ids = None
        self._group_ids_dev = None
        self._grouped_fn = None
        self._n_groups = 0
        self._grouped: list[reduction.Stats] = []
        if group_ids is not None:
            self.set_groups(group_ids)
        self._perm_cache: Optional[torch.Tensor] = None
        self._dispatch = (HostLoopDispatch if cfg.host_loop
                          else FusedDispatch)(self)
        self._pool = init_lanes(self.system, cfg.n_instances, cfg.seed,
                                device=self.device)

    # -------------------------------------------------------- re-spec
    def set_rates(self, rates) -> None:
        """Install a per-instance (I, R) rate matrix (parameter sweep).
        Must happen before the first window runs."""
        if self._window or self._dispatched:
            raise RuntimeError("rates must be set before running")
        rates = np.asarray(rates, np.float32)
        want = (self.cfg.n_instances, self.system.n_reactions)
        if rates.shape != want:
            raise ValueError(f"rates must have shape {want}, got "
                             f"{rates.shape}")
        self.rates = rates
        self._rates_dev = torch.as_tensor(rates, device=self.device)
        if self._dispatch is not None:
            self._dispatch.set_rates(self._rates_dev)

    def set_groups(self, group_ids) -> None:
        """Enable grouped reduction: group_ids (I,) maps each instance
        to a reduction group (e.g. its sweep point)."""
        ids = np.asarray(group_ids, np.int32)
        if ids.shape != (self.cfg.n_instances,):
            raise ValueError(f"group_ids must have shape "
                             f"({self.cfg.n_instances},), got {ids.shape}")
        self._group_ids = ids
        self._group_ids_dev = torch.as_tensor(ids, device=self.device)
        self._n_groups = int(ids.max()) + 1
        if self.cfg.stat_blocks == 1:
            self._grouped_fn = partial(reduction.grouped_stats,
                                       n_groups=self._n_groups)
        else:
            def grouped_fn(obs, gids, n_groups=self._n_groups,
                           n_blocks=self.cfg.stat_blocks):
                return reduction.finalize(reduction.merge_blocks(
                    reduction.blocked_grouped_welford(obs, gids, n_groups,
                                                      n_blocks)))

            self._grouped_fn = grouped_fn

    # ------------------------------------------------------------------
    def _permutation(self) -> torch.Tensor:
        """Concatenated, padded scheduler groups as a device index map
        (cached unless the predictive policy regroups every window)."""
        predictive = self.scheduler.policy == "predictive"
        if not predictive and self._perm_cache is not None:
            return self._perm_cache
        perm = to_device(
            np.concatenate(self.scheduler.groups()).astype(np.int64),
            self.device)
        if not predictive:
            self._perm_cache = perm
        return perm

    # ------------------------------------------------------------------
    def _pack_window(self, obs, steps_sum, leaps_sum, truncated):
        """One window's small results as ONE float64 device row: the
        record's moments (mean, var, ci90, n), the pool's step/leap
        totals and the truncation flag, each widened exactly. The
        per-window and the superstep paths both pull this row, so their
        records come from the same ops on the same values."""
        stats = reduction.blocked_stats(obs, self.cfg.stat_blocks)
        if truncated is None:  # the unfused paths have no event budget
            truncated = torch.zeros((), dtype=torch.bool, device=obs.device)
        parts = [stats.mean, stats.var, stats.ci90, stats.n, steps_sum,
                 leaps_sum, truncated]
        return torch.cat([p.reshape(-1).to(torch.float64) for p in parts])

    def _emit_row(self, w: int, row: np.ndarray) -> StatsRecord:
        """Check one pulled `_pack_window` row (truncation, guards),
        book its step/leap telemetry and return window w's record."""
        n_obs = len(self.obs_idx)
        mean, var, ci90, n = (row[i * n_obs:(i + 1) * n_obs].astype(
            np.float32) for i in range(4))
        steps_sum, leaps_sum, truncated = row[4 * n_obs:4 * n_obs + 3]
        if truncated:
            # a silently partial window must never become a record
            self._raise_truncated(w, float(self.grid[w]))
        if self.cfg.guards:
            self._guard_stats(w, mean, var)
        # cumulative totals tracked as residues mod 2^32 (the reference's
        # int32 device sums wrap there), per-window deltas exact
        steps_cum = int(steps_sum) & 0xFFFFFFFF
        leaps_cum = int(leaps_sum) & 0xFFFFFFFF
        self.window_steps.append((steps_cum - self._cum_steps) & 0xFFFFFFFF)
        self.window_leaps.append((leaps_cum - self._cum_leaps) & 0xFFFFFFFF)
        self._cum_steps, self._cum_leaps = steps_cum, leaps_cum
        return StatsRecord(t=float(self.grid[w]), window=w, mean=mean,
                           var=var, ci90=ci90, n=float(n.max()))

    def _buffering(self) -> bool:
        """Schemas i/ii buffer raw samples; iii only on request."""
        return self.cfg.schema in ("i", "ii") or self._record_trajectories

    def run_window(self) -> StatsRecord:
        """Advance every instance to the next grid point and emit its
        record. Schemas share this loop; they differ in grouping policy
        (schema i: static_rr) and in what is buffered (i/ii: raw
        samples; iii: nothing beyond the record)."""
        if self._pending:  # mixing with supersteps: drain them first
            self.flush()
        cfg = self.cfg
        w = self._window
        horizon = np.float32(self.grid[w])
        t0 = time.perf_counter()
        res = self._dispatch.advance(horizon)
        if self.scheduler.policy == "predictive":
            steps_delta = res.steps_delta.cpu().numpy()
            self.n_host_syncs += 1
            self.scheduler.record_costs(np.arange(cfg.n_instances),
                                        steps_delta)
        self.wall_times.append(time.perf_counter() - t0)
        obs = res.obs
        row = self._pack_window(obs, self._pool.steps.sum(dtype=torch.int64),
                                self._pool.leaps.sum(dtype=torch.int64),
                                res.truncated)
        t_pull = time.perf_counter()
        row = row.cpu().numpy()  # ONE combined blocking pull
        self.n_host_syncs += 1
        rec = self._emit_row(w, row)
        obs_bytes = obs.numel() * obs.element_size()
        if self._buffering():
            self._samples.append(obs.cpu().numpy())
            self.n_host_syncs += 1
            self._peak_buffered = max(
                self._peak_buffered, sum(s.nbytes for s in self._samples))
        else:  # schema iii: on-line reduction, window dropped immediately
            self._peak_buffered = max(self._peak_buffered, obs_bytes)
        if self._grouped_fn is not None:
            g = self._grouped_fn(obs, self._group_ids_dev)
            leaves = torch.stack(list(g)).cpu().numpy()
            self._grouped.append(reduction.Stats(*leaves))
            self.n_host_syncs += 1
        self.stream.emit(rec)
        self.block_walls.append(
            (w, 1, self.wall_times[-1], time.perf_counter() - t_pull))
        self._window += 1
        self._dispatched = self._window
        return rec

    def _raise_truncated(self, window: int, horizon: float):
        """The one FusedWindowTruncated raise for both the per-window
        and the superstep collect path. Everything still in flight was
        dispatched from the truncated pool, so the pipeline is dropped
        first and the dispatch cursor rewinds to the collected frontier:
        a caller that catches the error and drives on re-runs from the
        failed window instead of skipping the dropped ones."""
        from repro_torch.kernels.ops import FusedWindowTruncated

        self._pending.clear()
        self._dispatched = self._window
        cfg = self.cfg
        raise FusedWindowTruncated(
            f"window {window} (horizon {horizon:g}) exhausted "
            f"kernel_max_chunks={cfg.kernel_max_chunks} x "
            f"kernel_chunk_steps={cfg.kernel_chunk_steps} events with "
            "live lanes still below the horizon; raise those limits "
            "or use more windows")

    def _raise_invariant(self, window: int, check: str, detail: str):
        """Typed invariant-guard raise, with `_raise_truncated`'s
        in-flight hygiene: the pipeline was dispatched from the
        now-untrusted pool, so it is dropped."""
        self._pending.clear()
        self._dispatched = self._window
        raise InvariantViolation(
            f"engine invariant {check!r} violated at window {window}: "
            f"{detail}", window=window, check=check)

    def _guard_stats(self, window: int, mean, var) -> None:
        """Host-side invariant checks on the moments already pulled:
        observables are sums of species counts, so a sound pool gives
        finite, non-negative means."""
        if not (np.isfinite(mean).all() and np.isfinite(var).all()):
            self._raise_invariant(
                window, "non_finite_stats",
                "window statistics contain NaN/inf")
        if (mean < 0.0).any():
            self._raise_invariant(
                window, "negative_population",
                f"window mean dipped below zero (min {mean.min():g})")

    # -------------------------------------------------- supersteps
    @property
    def pipeline_depth(self) -> int:
        """Resolved in-flight block budget. For pipeline_depth="auto"
        this is 1 until the first collected block's probe resolves it
        (resolve_auto_depth)."""
        return self._depth if self._depth is not None else 1

    @property
    def pipeline_depth_effective(self) -> int:
        """The depth the collector actually runs at (steering, item 13,
        will force 1 here)."""
        return self.pipeline_depth

    def enable_snapshots(self) -> None:
        """Opt in to ring-snapshot checkpointing: every subsequent block
        dispatch keeps the pool at its entry, so checkpoint() can save
        the oldest in-flight block's entry boundary — which IS the
        collected frontier — without flushing the pipeline. The
        snapshot holds the entry pool's tensors by reference (no pool
        leaf is ever written in place), so it costs no copy, only the
        memory it keeps alive. On the card the saves' staging is made
        here, while nothing is in flight."""
        self._snap_enabled = True
        if self.device.type == "cuda":
            self._staging()

    def _staging(self) -> tuple:
        """(pinned host buffer per pool leaf, side stream) for a save's
        pool copy on the card, made once and reused by every save."""
        if self._save_staging is None:
            self._save_staging = (
                {f: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                 for f, v in zip(LaneState._fields, self._pool)},
                torch.cuda.Stream(self.device))
        return self._save_staging

    def _observe(self) -> torch.Tensor:
        """(I, n_obs) observables of the current pool."""
        return self._dispatch._extract_obs(self._pool.x)

    def _next_block_windows(self, limit: int) -> int:
        """Size of the next superstep: realigned to the absolute
        window_block grid (so a mid-grid start — a max_windows cut —
        converges back onto block boundaries; restore() rejects
        MID-block checkpoints), capped by the grid end and the caller's
        dispatch limit."""
        w0 = self._dispatched
        wb = self.cfg.window_block
        return min(wb - (w0 % wb), len(self.grid) - w0, limit - w0)

    def _pull_async(self, ring: dict):
        """Start the ring's device-to-host copy: (host tensors, event).
        On the card each tensor goes into its own pinned buffer by a
        non-blocking copy on the current stream, and one event is
        recorded after them; the collector's wait on it is the block's
        one host sync (a pinned buffer read before its event completes
        holds stale bytes). On the CPU the ring already is host memory."""
        if self.device.type != "cuda":
            return ring, None
        host = {}
        for k, v in ring.items():
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def _dispatch_block(self, limit: int) -> None:
        """Queue the next W windows as ONE dispatch, fold each window's
        statistics on the device with the per-window path's ops, pack
        them into the block's ring and start its copy to the host. All
        of it goes on the current stream, so the ring's tensors may be
        freed as soon as the copies are queued."""
        cfg = self.cfg
        w0 = self._dispatched
        n_win = self._next_block_windows(limit)
        horizons = self.grid[w0:w0 + n_win]
        snapshot = self._pool if self._snap_enabled else None
        snap_ready = None
        if snapshot is not None and self.device.type == "cuda":
            snap_ready = torch.cuda.Event()
            snap_ready.record(torch.cuda.current_stream(self.device))
        t0 = time.perf_counter()
        res = self._dispatch.advance_block(horizons)
        ring = {"rows": torch.stack([
            self._pack_window(res.obs[w], res.steps_end[w], res.leaps_end[w],
                              res.truncated and res.truncated[w])
            for w in range(n_win)])}
        if self._grouped_fn is not None:
            ring["grouped"] = torch.stack([
                torch.stack(list(self._grouped_fn(o, self._group_ids_dev)))
                for o in res.obs])
        if self._buffering():
            ring["obs"] = torch.stack(res.obs)
        if res.steps_delta is not None:
            ring["steps_delta"] = torch.stack(res.steps_delta)
        # sketches ride this ring once item 12 is ported
        pull, done = self._pull_async(ring)
        dispatch_wall = time.perf_counter() - t0
        # every queued ring (and snapshot) is live at once at depth K,
        # so peak_buffered must see their sum
        ring_bytes = sum(
            t.numel() * t.element_size()
            for t in (*ring.values(), *(snapshot or ())))
        obs_row_bytes = res.obs[0].numel() * res.obs[0].element_size()
        self._pending.append(_InFlight(
            w0, n_win, pull, done, dispatch_wall, obs_row_bytes,
            ring_bytes, snapshot, snap_ready))
        self._dispatched = w0 + n_win
        self.peak_inflight_blocks = max(
            self.peak_inflight_blocks, len(self._pending))
        self._peak_buffered = max(
            self._peak_buffered,
            sum(e.ring_bytes for e in self._pending)
            + sum(s.nbytes for s in self._samples))

    def _collect_block(self) -> None:
        """Wait for the OLDEST in-flight block's ring (its one host
        sync), then emit its windows' records exactly as the per-window
        path does."""
        cfg = self.cfg
        ent = self._pending.popleft()
        w0, n_win, pull = ent.w0, ent.n_win, ent.pull
        if (ent.snapshot is not None and cfg.window_block > 1
                and w0 % cfg.window_block == 0
                and (w0 + n_win) % cfg.window_block):
            # this block was cut short (a max_windows dispatch limit):
            # keep its aligned ENTRY snapshot so a later checkpoint()
            # at the mid-block frontier saves a boundary-aligned file
            self._aligned_snap = (w0, ent.snapshot)
        t0 = time.perf_counter()
        if ent.done is not None:
            ent.done.synchronize()
        self.n_host_syncs += 1
        pull_s = time.perf_counter() - t0
        wall = ent.dispatch_wall + pull_s
        # the straggler watchdog observes this block wall (item 15)
        rows = pull["rows"].numpy()
        if cfg.guards and rows.shape[0] != n_win:
            self._raise_invariant(
                w0, "ring_record_mismatch",
                f"superstep ring holds {rows.shape[0]} rows for a "
                f"{n_win}-window block at window {w0}")
        for w in range(n_win):
            self.wall_times.append(wall / n_win)
            rec = self._emit_row(w0 + w, rows[w])
            if "obs" in pull:
                self._samples.append(pull["obs"][w].numpy().copy())
                self._peak_buffered = max(
                    self._peak_buffered,
                    sum(s.nbytes for s in self._samples))
            else:
                self._peak_buffered = max(self._peak_buffered,
                                          ent.obs_row_bytes)
            if "grouped" in pull:
                self._grouped.append(reduction.Stats(
                    *pull["grouped"][w].numpy().copy()))
            if "steps_delta" in pull:
                # per-window EMA updates in window order: the cost state
                # at every block boundary matches the per-window path's
                self.scheduler.record_costs(
                    np.arange(cfg.n_instances),
                    pull["steps_delta"][w].numpy())
            # block partials for the multi-process farm go here (item 16)
            self.stream.emit(rec)
            self._window += 1
        host_s = time.perf_counter() - t0 - pull_s
        self.block_walls.append((w0, n_win, ent.dispatch_wall,
                                 pull_s + host_s))
        if self._depth is None:
            # pipeline_depth="auto": the first collect ran at depth 1
            # (cold pipeline), so pull_s approximates one block's
            # remaining device+transfer time and host_s the collector
            # work to hide behind it
            self._depth = resolve_auto_depth(pull_s, host_s)
            self.depth_probe = dict(
                dispatch_s=ent.dispatch_wall, pull_s=pull_s, host_s=host_s,
                collect_dispatch_ratio=(
                    (pull_s + host_s) / max(ent.dispatch_wall, 1e-9)),
                depth=self._depth)

    def run_block(self, dispatch_limit: Optional[int] = None) -> int:
        """One turn of the pipelined superstep loop: dispatch the next
        window block if any remains below `dispatch_limit` (an absolute
        window index), then collect the oldest in-flight block once more
        than `pipeline_depth` blocks are queued behind it — or once
        dispatching is done — so host-side reduction and sinks for block
        k run while the device simulates blocks k+1..k+K. Returns the
        number of windows collected this call."""
        limit = len(self.grid)
        if dispatch_limit is not None:
            limit = min(limit, dispatch_limit)
        if self._dispatched < limit:
            self._dispatch_block(limit)
        before = self._window
        depth = self.pipeline_depth  # "auto" acts as 1 until resolved
        if self._pending and (len(self._pending) > depth
                              or self._dispatched >= limit):
            self._collect_block()
        # steering's decision point at the collected boundary (item 13)
        return self._window - before

    def flush(self) -> None:
        """Collect every in-flight superstep so the emitted records
        catch up with the dispatched pool state."""
        while self._pending:
            self._collect_block()

    def run(self) -> list[StatsRecord]:
        if self.cfg.window_block == 1:
            while self._window < len(self.grid):
                self.run_window()
        else:
            while self._window < len(self.grid):
                self.run_block()
        return self.stream.records()

    # ------------------------------------------------------------ fault
    def checkpoint(self, path: str) -> None:
        """One-file snapshot in the reference's format: pool +
        scheduler + rates + emitted records (+ any buffered samples and
        grouped stats). Either package restores it.

        With ring snapshots enabled (enable_snapshots), the oldest
        in-flight block's ENTRY snapshot is the pool at the collected
        frontier, so the save happens WITHOUT flushing the pipeline.
        Without snapshots (or with nothing in flight) saving flushes
        first. A `max_windows` cut landing MID-block rolls the save
        back to the cut block's aligned entry snapshot, so the file
        always restores under the run's own window_block.

        The save waits for one copy, the saved pool's to the host
        (`_pull_pool`, booked in `ckpt_pulls`); a snapshot's copy does
        not wait for the blocks in flight behind it."""
        p = None
        ready = None
        win = self._window
        if self._pending:
            snap = self._pending[0].snapshot
            if snap is not None:
                # blocks collect in order, so the oldest pending block's
                # first window IS self._window
                assert self._pending[0].w0 == self._window
                p = snap
                ready = self._pending[0].snap_ready
                self.n_snapshot_saves += 1
            else:
                self.n_ckpt_flushes += 1
        if p is None:
            self.flush()
            p = self._pool
            win = self._window
            wb = self.cfg.window_block
            if wb > 1 and win % wb and win != len(self.grid):
                aligned = self._aligned_snap
                if aligned is not None and aligned[0] == win - win % wb:
                    win, p = aligned
                    self.n_snapshot_saves += 1
        extra = {}
        recs = [r for r in self.stream.records() if r.window < win]
        if recs:
            extra = dict(
                rec_t=np.asarray([r.t for r in recs], np.float64),
                rec_window=np.asarray([r.window for r in recs], np.int64),
                rec_mean=np.stack([r.mean for r in recs]),
                rec_var=np.stack([r.var for r in recs]),
                rec_ci90=np.stack([r.ci90 for r in recs]),
                rec_n=np.asarray([r.n for r in recs], np.float64))
        if self._samples[:win]:
            extra["samples"] = np.stack(self._samples[:win], axis=1)
        if self._grouped[:win]:
            for name in ("n", "mean", "var", "ci90"):
                extra[f"grouped_{name}"] = np.stack(
                    [getattr(g, name) for g in self._grouped[:win]])
        # sketch_* (item 12), bp_*/gpp_* (item 16) and steer_* (item 13)
        # keys are written here once their features are ported
        if self._group_ids is not None:
            extra["group_ids"] = self._group_ids
        # keys and draw counters cross as the reference's uint32 words
        pool = self._pull_pool(p, ready)
        for f in ("key", "ctr", "ctr_hi"):
            pool[f] = pool[f].view(np.uint32)
        ckpt_store.save_atomic(path, dict(
            **pool, window=win, cost=self.scheduler._cost,
            rates=np.asarray(self.rates, np.float32), **extra))

    def _pull_pool(self, p: LaneState, ready) -> dict:
        """The leaves of pool `p` as host arrays, for a save. On the card
        they are copied into the pinned buffers of `_staging` on its
        side stream, which waits for the `ready` event (the snapshot's,
        recorded before the block that follows it; else one recorded
        now), so a snapshot's copy runs beside the blocks in flight
        instead of behind them on the one stream. `p` is held until the
        copy is waited on, so the allocator cannot reuse its memory
        under the side stream; the returned arrays view the buffers and
        hold until the next save."""
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            host = {f: getattr(p, f).numpy() for f in LaneState._fields}
            self.ckpt_pulls.append((time.perf_counter() - t0, 0))
            return host
        if ready is None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        host, side = self._staging()
        side.wait_event(ready)
        with torch.cuda.stream(side):
            for f in LaneState._fields:
                host[f].copy_(getattr(p, f), non_blocking=True)
        side.synchronize()
        running = sum(not e.done.query() for e in self._pending
                      if e.done is not None)
        self.ckpt_pulls.append((time.perf_counter() - t0, running))
        return {f: h.numpy() for f, h in host.items()}

    def restore(self, path: str) -> None:
        """Load a checkpoint written by either package. Refuses a file
        cut mid-block for this engine's window_block, and one that
        carries state of a feature not ported yet, before touching any
        state; rebinds the kernel tables to the restored rates."""
        from repro_torch.api.spec import ExperimentError

        z = ckpt_store.verify(
            path, required=("x", "t", "key", "steps", "dead",
                            "window", "cost"))
        for prefix, item in (("sketch_", "item 12, sketches"),
                             ("steer_", "item 13, steering"),
                             ("bp_", "item 16, the multi-process farm"),
                             ("gpp_", "item 16, the multi-process farm")):
            keys = sorted(k for k in z if k.startswith(prefix))
            if keys:
                raise ExperimentError(
                    f"checkpoint {path!r} carries {keys}, state of a "
                    f"feature not ported to repro_torch yet (ROADMAP "
                    f"queue 1, {item})")
        saved_window = int(z["window"])
        wb = self.cfg.window_block
        if wb > 1 and saved_window % wb and saved_window != len(self.grid):
            raise ValueError(
                f"checkpoint at window {saved_window} is mid-block for "
                f"window_block={wb}: supersteps advance {wb} windows "
                "per dispatch, so resume needs a checkpoint on a "
                "window_block boundary — resume with window_block=1 "
                f"(or a divisor of {saved_window}), or re-save the "
                "checkpoint at a multiple of window_block")
        self._pending.clear()  # in-flight rings predate the restore
        self._aligned_snap = None
        # files without `ctr` restart their streams at draw 0; without
        # `ctr_hi`/`leaps` the high word and leap count are 0 (bitwise:
        # every stream below 2^32 draws has hi = 0); without `no_leap`
        # no lane was pinned
        n = z["t"].shape[0]
        zu = np.zeros((n,), np.uint32)
        arrs = dict(x=z["x"], t=z["t"], key=z["key"],
                    ctr=z.get("ctr", zu), ctr_hi=z.get("ctr_hi", zu),
                    steps=z["steps"],
                    leaps=z.get("leaps", np.zeros((n,), np.int32)),
                    dead=z["dead"],
                    no_leap=z.get("no_leap", np.zeros((n,), bool)))
        dtypes = dict(x=np.float32, t=np.float32, key=np.uint32,
                      ctr=np.uint32, ctr_hi=np.uint32, steps=np.int32,
                      leaps=np.int32, dead=bool, no_leap=bool)
        leaves = {}
        for f, a in arrs.items():
            a = np.ascontiguousarray(a, dtypes[f])
            if dtypes[f] is np.uint32:
                a = a.view(np.int32)
            leaves[f] = torch.tensor(a, device=self.device)
        self._pool = LaneState(**leaves)
        self._window = saved_window
        self._dispatched = saved_window
        # per-window telemetry restarts from the restored cumulative
        # counts, as mod-2^32 residues like the live path's
        self.window_steps, self.window_leaps = [], []
        self._cum_steps = int(
            np.asarray(z["steps"], np.int64).sum()) & 0xFFFFFFFF
        self._cum_leaps = int(
            np.asarray(arrs["leaps"], np.int64).sum()) & 0xFFFFFFFF
        self.scheduler._cost = np.array(z["cost"], np.float64)
        if "rates" in z:
            rates = np.asarray(z["rates"], np.float32)
            if (rates == rates[:1]).all():
                # one row for all: keep (R,) on the device, the kernels'
                # shared-rate route (the same bits as the per-lane one)
                self.rates = np.broadcast_to(rates[0], rates.shape)
                self._rates_dev = torch.as_tensor(rates[0].copy(),
                                                  device=self.device)
            else:
                self.rates = rates
                self._rates_dev = torch.as_tensor(rates, device=self.device)
            # the kernel tables are bound to the rates: rebind them
            self._dispatch.set_rates(self._rates_dev)
        if "group_ids" in z:
            self.set_groups(np.asarray(z["group_ids"], np.int32))
        # re-populate already-emitted records (buffer only — sinks are
        # replayed by the caller, so a resumed CSV is written once)
        self.stream.buffer.clear()
        if "rec_t" in z:
            for i in range(len(z["rec_t"])):
                self.stream.buffer.append(StatsRecord(
                    t=float(z["rec_t"][i]), window=int(z["rec_window"][i]),
                    mean=z["rec_mean"][i], var=z["rec_var"][i],
                    ci90=z["rec_ci90"][i], n=float(z["rec_n"][i])))
        self._samples = ([z["samples"][:, w]
                          for w in range(z["samples"].shape[1])]
                         if "samples" in z else [])
        self._grouped = ([
            reduction.Stats(n=z["grouped_n"][w], mean=z["grouped_mean"][w],
                            var=z["grouped_var"][w],
                            ci90=z["grouped_ci90"][w])
            for w in range(len(z["grouped_n"]))]
            if "grouped_n" in z else [])

    @property
    def peak_buffered_bytes(self) -> int:
        return self._peak_buffered

    def trajectories(self) -> Optional[np.ndarray]:
        """(I, T, n_obs) raw samples. Buffered for schemas i/ii; for
        schema iii only when record_trajectories was requested."""
        self.flush()
        if not self._samples:
            return None
        return np.stack(self._samples, axis=1)

    def grouped_stats(self) -> list[reduction.Stats]:
        """Per-window grouped Stats ((n_groups, n_obs) leaves) when a
        grouped reduction is enabled via set_groups()."""
        self.flush()
        return list(self._grouped)
