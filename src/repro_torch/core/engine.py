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

Sketches (`sketch=SketchSpec`): each window's per-(point, observable)
histogram and rare-event counts are computed on the device and packed
into the window's one float64 row, so they ride the per-window path's
one pull and the superstep ring at no extra host sync.

Steering (`steering=Steering`): a between-block controller
(steer/policy.py) decides at each collected block boundary; steered
runs are lock-step (depth 1, each block collected before the next is
dispatched) and go through the block loop even at window_block=1. The
per-lane step/leap counters it reads ride the block's ring, and its
actions are applied on the device by out-of-place ops, so a decision
point adds no host sync and writes no pool leaf in place.

Shards (`n_shards=K`, `Partitioning` in the API): the pool is K
contiguous per-shard `LaneState`s (`_pools`), each on its own device
(`devices`, entries may repeat), advanced by `FusedDispatch` (K
launches a window, one dispatch); each shard's Welford block partials,
grouped partials and sketch counts meet on the lead device
(`devices[0]`), so a window is still ONE packed row and one host pull,
and records are bitwise the unsharded run's at the same stat_blocks.
Checkpoints hold the global pool (each shard copied at its row offset)
and restore into any shard count.

Faults: the guards raise `runtime.fault.InvariantViolation`, a
`RecoverableError` the supervisor (`runtime/supervisor.py`) catches;
the straggler watchdog (`runtime/straggler.py`) observes every window
and every collected block.
"""
from __future__ import annotations

import collections
import math
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.ckpt import store as ckpt_store
from repro_torch.core import reduction
from repro_torch.core.cwc.compile import CompiledModel, compile_model
from repro_torch.core.cwc.rules import CWCModel
from repro_torch.core.device import resolve_devices, to_device
from repro_torch.core.dispatch import (
    FusedDispatch,
    HostLoopDispatch,
    WindowResult,
)
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
from repro_torch.runtime.fault import InvariantViolation
from repro_torch.runtime.straggler import WindowWatchdog
from repro_torch.stats.sketch import SketchSpec, WindowSketch, window_sketch
from repro_torch.steer.policy import Steering, SteeringActions, SteeringPolicy

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
    # contiguous pool shards, each on its own device (FusedDispatch);
    # records depend on stat_blocks only, never on this number
    n_shards: int = 1
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
                     "stat_blocks", "n_lanes", "n_windows", "n_shards"):
            if getattr(self, name) < 1:
                raise ValueError(f"SimConfig.{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        if self.n_instances % self.stat_blocks:
            raise ValueError(
                f"n_instances ({self.n_instances}) must divide evenly "
                f"into stat_blocks ({self.stat_blocks}) blocks")
        if self.stat_blocks % self.n_shards:
            raise ValueError(
                f"stat_blocks ({self.stat_blocks}) must be a multiple of "
                f"n_shards ({self.n_shards}) so each shard owns whole "
                "blocks")
        if self.n_shards > 1 and self.host_loop:
            raise ValueError(
                "sharded dispatch is incompatible with host_loop=True; "
                "the host loop is a single-device baseline")
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
    snapshot: Optional[list]  # the per-shard pools at this block's
    #   entry, held by reference (nothing writes a pool leaf in place,
    #   see core/dispatch.py) — lets checkpoint() save this block's
    #   entry boundary while it is still in flight
    snap_ready: Optional[dict]  # device -> event recorded before the
    #   block's launches there: the snapshot's leaves are complete once
    #   it has run


def resolve_observables(model):
    """(system, obs_names, obs_idx) for a model — the single source of
    the observable-column derivation (engine and api share it)."""
    if isinstance(model, CompiledModel):
        return (model.system, list(model.obs_names),
                [list(i) for i in model.obs_idx])
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
                 device=None, sketch: Optional[SketchSpec] = None,
                 steering: Optional[Steering] = None):
        # one device per shard (shard k owns the contiguous instance
        # block [k*I/K, (k+1)*I/K)); the lead device holds the gathered
        # statistics, the rings and every global tensor
        self.devices = resolve_devices(device, cfg.n_shards)
        self.device = self.devices[0]
        self.system, self.obs_names, self.obs_idx = resolve_observables(
            model)
        self.cfg = cfg
        self.grid = np.linspace(cfg.t_end / cfg.n_windows, cfg.t_end,
                                cfg.n_windows)
        self.stream = StatsStream()
        self.scheduler = Scheduler(
            cfg.n_instances,
            min(cfg.n_lanes, cfg.n_instances // cfg.n_shards),
            policy=("static_rr" if cfg.schema == "i" else cfg.policy),
            n_shards=cfg.n_shards)
        # the system's tables per device: (dense base, sparse exact or
        # None, tau or None); the lead device's are built here
        self._tables: dict = {}
        self._tensors_base, self._sparse_tensors, self._tau_tables = (
            self._tables_on(self.device))
        # shared rates stay (R,) on the device (the kernel keeps them in
        # shared memory); a sweep installs an (I, R) matrix
        self.rates = np.broadcast_to(
            self.system.rates, (cfg.n_instances, self.system.n_reactions))
        self._dispatch: Optional[FusedDispatch] = None
        self._install_rates(self._tensors_base[3])
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
        self._gids_shards: Optional[list] = None
        self._n_groups = 0
        self._grouped: list[reduction.Stats] = []
        # the farm worker's seam (enable_block_partials): each window's
        # Welford block partials (V, n_obs) and grouped partials (V, G,
        # n_obs), pulled in `_pack_window`'s row, so a coordinator can
        # fold every worker's stacks in global block order
        self._export_partials = False
        self._block_partials: list[reduction.Welford] = []
        self._grouped_partials: list[reduction.Welford] = []
        # (v_total, v0, g_total, g0): where this shard's blocks and groups
        # sit in the global (V, G) layout (set_global_stats_layout)
        self._stats_layout: Optional[tuple] = None
        # sketches: the bin geometry resolved from the model's t=0
        # observables (float64, as the reference resolves it), its
        # operands per device, and the pulled WindowSketch per window
        self._sketch = None
        self._sketch_dev: dict = {}
        self._sketches: list[WindowSketch] = []
        if sketch is not None:
            x0 = np.asarray(self.system.x0, np.float64)
            obs0 = np.asarray(
                [x0[list(ii)].sum() for ii in self.obs_idx], np.float64)
            sk = self._sketch = sketch.resolve(obs0)
            for d in dict.fromkeys(self.devices):
                self._sketch_dev[d] = (
                    to_device(sk.lo, d), to_device(sk.inv_width, d),
                    to_device(sk.thresholds, d) if sk.n_thr else None)
        if group_ids is not None:
            self.set_groups(group_ids)
        self._steer: Optional[SteeringPolicy] = None
        # the per-lane (steps, leaps) at the last collected block's end,
        # from its ring: the decision point's counters
        self._steer_counters: Optional[tuple] = None
        if steering is not None:
            steering.check_run(
                host_loop=cfg.host_loop, sketched=sketch is not None,
                tau_leap=cfg.method == "tau_leap",
                pipeline_depth=cfg.pipeline_depth)
        if steering is not None and steering.enabled:
            # lock-step by construction: "auto" resolves to 1 here, with
            # no probe, so the forcing shows in pipeline_depth_effective
            self._depth = 1
            self._steer = SteeringPolicy(
                steering, cfg.n_instances, n_points=(self._n_groups or 1),
                n_windows=cfg.n_windows,
                tau_leap=(cfg.method == "tau_leap"))
        # the straggler watchdog observes every window's wall (every
        # collected block's under supersteps); flags surface in
        # Telemetry.straggler_windows
        self.watchdog = WindowWatchdog()
        self._perm_cache: Optional[list] = None
        self._dispatch = (HostLoopDispatch if cfg.host_loop
                          else FusedDispatch)(self)
        self._pool = init_lanes(self.system, cfg.n_instances, cfg.seed,
                                device=self.device)

    # ----------------------------------------------------------- shards
    def _tables_on(self, device) -> tuple:
        """(dense base tensors, sparse exact tables or None, tau tables or
        None) of the system on `device`, built once per device."""
        if device not in self._tables:
            cfg = self.cfg
            # the dense comb unroll's MAX_COEF ceiling binds only when
            # the dense step runs
            self._tables[device] = (
                system_tensors(self.system, device=device,
                               require_dense=not cfg.sparse),
                sparse_system_tensors(sparse_tables(self.system),
                                      device=device)
                if cfg.sparse and cfg.method == "exact" else None,
                # the method seam: tau-leaping's tables (dense or sparse
                # form), None for exact SSA
                tau_tables(self.system, sparse=cfg.sparse, device=device)
                if cfg.method == "tau_leap" else None)
        return self._tables[device]

    def _split(self, a) -> list:
        """A global (I, ...) tensor as its per-shard row blocks, each on
        its shard's device (views when that is `a`'s own device)."""
        if len(self.devices) == 1:
            return [a]
        per = a.shape[0] // len(self.devices)
        return [a[k * per:(k + 1) * per].to(d)
                for k, d in enumerate(self.devices)]

    @property
    def _pool(self) -> LaneState:
        """The whole pool. Unsharded, the one shard's LaneState; sharded,
        the shards' leaves concatenated on the lead device (a gather:
        the hot paths read `_pools`)."""
        if len(self._pools) == 1:
            return self._pools[0]
        return LaneState(*(torch.cat([getattr(p, f).to(self.device)
                                      for p in self._pools])
                           for f in LaneState._fields))

    @_pool.setter
    def _pool(self, pool: LaneState) -> None:
        """Install a whole pool, split into the shards' row blocks on
        their devices (the leaves are replaced, never written)."""
        self._pools = [LaneState(*leaves) for leaves in
                       zip(*(self._split(a) for a in pool))]

    def _install_rates(self, rates_dev) -> None:
        """Make `rates_dev` ((R,) shared or (I, R) per lane, on the lead
        device) the run's rates: per-lane rows are split by shard,
        shared rates copied once to each device, and the kernel tables
        rebound to them."""
        self._rates_dev = rates_dev
        if rates_dev.ndim == 2:
            shards = self._split(rates_dev)
        else:
            copies = {d: rates_dev.to(d) for d in dict.fromkeys(self.devices)}
            shards = [copies[d] for d in self.devices]
        self._rates_shards = shards
        if self._dispatch is not None:
            self._dispatch.set_rates(shards)

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
        self._install_rates(torch.as_tensor(rates, device=self.device))

    def set_groups(self, group_ids) -> None:
        """Enable grouped reduction: group_ids (I,) maps each instance
        to a reduction group (e.g. its sweep point)."""
        ids = np.array(group_ids, np.int32)
        if ids.shape != (self.cfg.n_instances,):
            raise ValueError(f"group_ids must have shape "
                             f"({self.cfg.n_instances},), got {ids.shape}")
        self._group_ids = ids
        # through pinned memory: steering regroups between blocks, and a
        # copy from pageable memory would wait for the queued work
        self._group_ids_dev = to_device(ids, self.device)
        per = len(ids) // len(self.devices)
        self._gids_shards = (
            [self._group_ids_dev] if len(self.devices) == 1 else
            [to_device(ids[k * per:(k + 1) * per], d)
             for k, d in enumerate(self.devices)])
        self._n_groups = int(ids.max()) + 1

    def set_global_stats_layout(self, v_total: int, v0: int,
                                g_total: int, g0: int) -> None:
        """The farm worker's seam: declare where this shard's stat blocks
        and groups sit in the GLOBAL (V, G) layout, so grouped stats are
        folded through the zero-extended global stack (`_grouped_stats`)
        and steering sees the single-process run's bits. Must run before
        the first window."""
        if self._window or self._dispatched:
            raise RuntimeError("the stats layout must be set before running")
        self._stats_layout = (int(v_total), int(v0), int(g_total), int(g0))

    def enable_block_partials(self) -> None:
        """Opt in to keeping each window's Welford block partials (n,
        mean, m2 per stat block, and per (block, group) with groups). A
        farm worker's records cover only its own rows, so the coordinator
        folds the partial stacks of all workers, in global block order,
        by the same merge_blocks + finalize, which gives the
        single-process records bit for bit. They ride the window's one
        pull (`_pack_window`) and the checkpoint (bp_* and gpp_* keys)."""
        self._export_partials = True

    # ------------------------------------------------------------------
    def _permutations(self) -> list:
        """The concatenated, padded scheduler groups as one shard-local
        device index map per shard (the groups are shard-major and never
        mix shards); cached unless the predictive policy regroups every
        window."""
        predictive = self.scheduler.policy == "predictive"
        if not predictive and self._perm_cache is not None:
            return self._perm_cache
        perm = np.concatenate(self.scheduler.groups()).astype(np.int64)
        k_n = len(self.devices)
        n, per = perm.shape[0] // k_n, self.cfg.n_instances // k_n
        perms = [to_device(perm[k * n:(k + 1) * n] - k * per, d)
                 for k, d in enumerate(self.devices)]
        if not predictive:
            self._perm_cache = perms
        return perms

    # ------------------------------------------------------------------
    def _sketch_eval(self, obs, gids=None):
        """(hist, rare) of observables `obs` on their device, grouped by
        `gids` (a shard's slice of the lane->point map) or by the CURRENT
        whole map (a steering reallocation regroups the next window's
        sketch)."""
        lo, inv_width, thr = self._sketch_dev[obs.device]
        if gids is None:
            gids = self._group_ids_dev
        return window_sketch(
            obs, gids, self._n_groups if gids is not None else 1, lo,
            inv_width, self._sketch.n_bins, thr)

    def _pack_window(self, res: WindowResult):
        """One window's small results as ONE float64 row on the lead
        device: the record's moments (mean, var, ci90, n) folded from the
        window's block stack, the pool's step/leap totals, the truncation
        flag and, with a sketch, its int32 histogram and rare counts
        (below 2^31, so widened exactly) and, with block partials on, the
        window's block and grouped partial stacks (float32, widened
        exactly). The per-window and the superstep paths both pull this
        row, and every dispatch hands the same stack, so their records
        come from the same ops on the same values."""
        stats = reduction.finalize(reduction.merge_blocks(res.stack))
        truncated = res.truncated
        if truncated is None:  # the unfused paths have no event budget
            truncated = torch.zeros((), dtype=torch.bool, device=self.device)
        parts = [stats.mean, stats.var, stats.ci90, stats.n, res.steps_sum,
                 res.leaps_sum, truncated]
        if res.sketch is not None:
            parts.extend(p for p in res.sketch if p is not None)
        if self._export_partials:
            parts.extend(res.stack)
            if res.grouped is not None:
                parts.extend(res.grouped)
        return torch.cat([p.reshape(-1).to(torch.float64) for p in parts])

    def _gathered(self, parts) -> torch.Tensor:
        """Per-shard tensors concatenated in shard order on the lead
        device (the one tensor when unsharded)."""
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(self.device) for p in parts])

    def _grouped_stats(self, res: WindowResult) -> torch.Tensor:
        """The window's per-group Stats, stacked (4, G, n_obs). A farm
        worker (set_global_stats_layout) embeds its (V_loc, G_loc) stack
        in a zeroed global (V, G) stack, folds that, and keeps its own
        groups' rows: the single-process fold sums every block, memberless
        ones as exact zero terms, and with V_loc = 1 the local stack
        alone would take merge_blocks' V == 1 shortcut instead."""
        acc = res.grouped
        if self._stats_layout is None:
            return torch.stack(list(reduction.finalize(
                reduction.merge_blocks(acc))))
        v_tot, v0, g_tot, g0 = self._stats_layout
        v_loc, g_loc = acc.n.shape[:2]
        full = torch.zeros((3, v_tot, g_tot) + tuple(acc.n.shape[2:]),
                           dtype=acc.n.dtype, device=acc.n.device)
        full[:, v0:v0 + v_loc, g0:g0 + g_loc] = torch.stack(list(acc))
        st = reduction.finalize(reduction.merge_blocks(
            reduction.Welford(*full)))
        return torch.stack([leaf[g0:g0 + g_loc] for leaf in st])

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
        g = self._n_groups or 1
        off = 4 * n_obs + 3
        if self._sketch is not None:
            sk = self._sketch
            n_hist = g * n_obs * sk.n_bins
            n_rare = g * n_obs * sk.n_thr
            counts = row[off:off + n_hist + n_rare].astype(np.int32)
            off += n_hist + n_rare
            self._sketches.append(WindowSketch(
                hist=counts[:n_hist].reshape(g, n_obs, sk.n_bins),
                rare=(counts[n_hist:].reshape(g, n_obs, sk.n_thr)
                      if sk.n_thr else None)))
        if self._export_partials:
            v = self.cfg.stat_blocks
            n_bp = 3 * v * n_obs
            self._block_partials.append(reduction.Welford(
                *row[off:off + n_bp].astype(np.float32).reshape(3, v, n_obs)))
            if self._group_ids is not None:
                self._grouped_partials.append(reduction.Welford(
                    *row[off + n_bp:].astype(np.float32).reshape(
                        3, v, g, n_obs)))
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
            steps_delta = self._gathered(res.steps_delta).cpu().numpy()
            self.n_host_syncs += 1
            self.scheduler.record_costs(np.arange(cfg.n_instances),
                                        steps_delta)
        self.wall_times.append(time.perf_counter() - t0)
        self.watchdog.observe(w, self.wall_times[-1])
        row = self._pack_window(res)
        t_pull = time.perf_counter()
        row = row.cpu().numpy()  # ONE combined blocking pull
        self.n_host_syncs += 1
        rec = self._emit_row(w, row)
        obs_bytes = sum(o.numel() * o.element_size() for o in res.obs)
        if self._buffering():
            # the one place a sharded window's observables cross shards
            self._samples.append(self._gathered(res.obs).cpu().numpy())
            self.n_host_syncs += 1
            self._peak_buffered = max(
                self._peak_buffered, sum(s.nbytes for s in self._samples))
        else:  # schema iii: on-line reduction, window dropped immediately
            self._peak_buffered = max(self._peak_buffered, obs_bytes)
        if res.grouped is not None:
            leaves = self._grouped_stats(res).cpu().numpy()
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
        """The depth the collector actually runs at. Steering forces
        lock-step (depth 1) regardless of the requested depth; this is
        the visible record of that forcing."""
        return 1 if self._steer is not None else self.pipeline_depth

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
        """(pinned host buffer per leaf of the whole pool, {device: side
        stream}) for a save's pool copy on the card, made once and
        reused by every save."""
        if self._save_staging is None:
            n = self.cfg.n_instances
            self._save_staging = (
                {f: torch.empty((n,) + v.shape[1:], dtype=v.dtype,
                                pin_memory=True)
                 for f, v in zip(LaneState._fields, self._pools[0])},
                {d: torch.cuda.Stream(d) for d in dict.fromkeys(self.devices)})
        return self._save_staging

    def _record_events(self) -> dict:
        """{device: an event recorded now on its current stream} for
        every device a shard occupies."""
        events = {}
        for d in dict.fromkeys(self.devices):
            events[d] = torch.cuda.Event()
            events[d].record(torch.cuda.current_stream(d))
        return events

    def _observe(self) -> torch.Tensor:
        """(I, n_obs) observables of the current pool, on the lead
        device."""
        return self._gathered(self._dispatch.extract_obs(self._pools))

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
        snapshot = self._pools if self._snap_enabled else None
        snap_ready = None
        if snapshot is not None and self.device.type == "cuda":
            snap_ready = self._record_events()
        t0 = time.perf_counter()
        res = self._dispatch.advance_block(horizons)
        ring = {"rows": torch.stack([self._pack_window(r) for r in res])}
        if res[0].grouped is not None:
            ring["grouped"] = torch.stack(
                [self._grouped_stats(r) for r in res])
        if self._buffering():
            ring["obs"] = torch.stack([self._gathered(r.obs) for r in res])
        if res[0].steps_delta is not None:
            ring["steps_delta"] = torch.stack(
                [self._gathered(r.steps_delta) for r in res])
        if self._steer is not None:
            # the decision point's per-lane counters at the block's end
            # (the pool's own leaves: nothing writes them in place)
            ring["lane_steps"] = self._gathered(
                [p.steps for p in self._pools])
            ring["lane_leaps"] = self._gathered(
                [p.leaps for p in self._pools])
        pull, done = self._pull_async(ring)
        dispatch_wall = time.perf_counter() - t0
        # every queued ring (and snapshot) is live at once at depth K,
        # so peak_buffered must see their sum
        ring_bytes = sum(
            t.numel() * t.element_size()
            for t in (*ring.values(),
                      *(t for p in snapshot or () for t in p)))
        obs_row_bytes = sum(o.numel() * o.element_size()
                            for o in res[0].obs)
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
        # the block's one wall, as one sample at per-window scale
        self.watchdog.observe_block(w0, n_win, wall)
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
            self.stream.emit(rec)
            self._window += 1
        if "lane_steps" in pull:
            self._steer_counters = (pull["lane_steps"].numpy(),
                                    pull["lane_leaps"].numpy())
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
        number of windows collected this call.

        Steering collects the freshly dispatched block at once
        (lock-step): its decision point must see block k's records
        before block k+1 is dispatched, and the decision is applied
        here, at the collected boundary."""
        limit = len(self.grid)
        if dispatch_limit is not None:
            limit = min(limit, dispatch_limit)
        if self._dispatched < limit:
            self._dispatch_block(limit)
        before = self._window
        depth = self.pipeline_depth  # "auto" acts as 1 until resolved
        if self._pending and (self._steer is not None
                              or len(self._pending) > depth
                              or self._dispatched >= limit):
            self._collect_block()
        collected = self._window - before
        if (self._steer is not None and collected and not self._pending
                and self._dispatched == self._window
                and self._window < len(self.grid)):
            self._steer_boundary()
        return collected

    def flush(self) -> None:
        """Collect every in-flight superstep so the emitted records
        catch up with the dispatched pool state."""
        while self._pending:
            self._collect_block()

    # --------------------------------------------------------- steering
    def _steer_boundary(self) -> None:
        """One decision point: hand the policy the freshest per-point
        stats (the newest grouped record, else the pooled record), the
        newest window histogram and the per-lane step/leap counters of
        the block just collected (mod-2^32 residues, as the reference's
        wrapping int32 counters give them), then apply what it decides.
        The counters rode the block's ring, so unlike the reference,
        which pulls them here and pulls the pool again to apply a
        decision (two host syncs a decision point), this adds none to
        `n_host_syncs`."""
        steps, leaps = (a.astype(np.int64) & 0xFFFFFFFF
                        for a in self._steer_counters)
        if self._grouped:
            g = self._grouped[-1]
            point_stats = {"mean": np.asarray(g.mean),
                           "ci90": np.asarray(g.ci90)}
        elif self.stream.records():
            r = self.stream.records()[-1]
            point_stats = {"mean": np.asarray(r.mean),
                           "ci90": np.asarray(r.ci90)}
        else:
            point_stats = None
        hist = self._sketches[-1].hist if self._sketches else None
        gids = (self._group_ids if self._group_ids is not None
                else np.zeros(self.cfg.n_instances, np.int32))
        actions = self._steer.decide(self._window, point_stats, hist,
                                     gids, steps, leaps)
        if actions.any:
            self._apply_steering(actions)

    def _apply_steering(self, a: SteeringActions) -> None:
        """Apply a decision to the pool on its device: the masks and
        the (lane, donor) pairs go up through pinned memory, and every
        edited leaf is a fresh tensor (out-of-place `|`, gathers and
        `index_put`), so ring snapshots holding the old pool by
        reference stay intact. A move clones the donor's x, t and dead
        onto the lane (its own key and counters stay: trajectory
        splitting), and its rates row and scheduler cost; per-lane rates
        then rebind the kernel tables. Shared (R,) rates are the same
        for every lane, so a move leaves them as they are. A sharded pool
        is gathered on the lead device, edited there (a donor may sit on
        another shard) and split back into fresh per-shard leaves."""
        pool = self._pool
        x, t, dead, no_leap = pool.x, pool.t, pool.dead, pool.no_leap
        stop = np.asarray(a.stop_lanes, bool)
        if stop.any():
            dead = dead | to_device(stop, self.device)
        moves = np.asarray(a.moves)
        if moves.size:
            pairs = to_device(moves.astype(np.int64), self.device)
            dst, src = pairs[:, 0], pairs[:, 1]
            x = x.index_put((dst,), x[src])
            t = t.index_put((dst,), t[src])
            dead = dead.index_put((dst,), dead[src])
            if self._rates_dev.ndim == 2:
                self.rates = np.array(self.rates)
                self.rates[moves[:, 0]] = self.rates[moves[:, 1]]
                # engine.set_rates refuses once windows have run; the
                # kernel tables are bound to the rates: rebind them
                self._install_rates(self._rates_dev.index_put(
                    (dst,), self._rates_dev[src]))
            cost = self.scheduler._cost
            cost[moves[:, 0]] = cost[moves[:, 1]]
        if a.no_leap is not None:
            no_leap = to_device(np.asarray(a.no_leap, bool), self.device)
        self._pool = pool._replace(x=x, t=t, dead=dead, no_leap=no_leap)
        if a.new_group_ids is not None:
            # every point keeps >= 1 lane, so n_groups is unchanged
            self.set_groups(a.new_group_ids)

    def sketches(self) -> list[WindowSketch]:
        """Per-window WindowSketch list (empty without a SketchSpec)."""
        self.flush()
        return list(self._sketches)

    def steering_report(self) -> Optional[dict]:
        """The policy's savings and decision summary (None when no
        steering is active)."""
        if self._steer is None:
            return None
        self.flush()
        return self._steer.report()

    def run(self) -> list[StatsRecord]:
        # steered runs go through the block loop even at window_block=1
        # (decisions live at the collected block boundary)
        if self.cfg.window_block == 1 and self._steer is None:
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
        p = None  # the per-shard pools to save
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
            p = self._pools
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
        if self._sketches[:win]:
            extra["sketch_hist"] = np.stack(
                [s.hist for s in self._sketches[:win]])
            if self._sketches[0].rare is not None:
                extra["sketch_rare"] = np.stack(
                    [s.rare for s in self._sketches[:win]])
        if self._block_partials[:win]:
            for i, name in enumerate(("n", "mean", "m2")):
                extra[f"bp_{name}"] = np.stack(
                    [b[i] for b in self._block_partials[:win]])
        if self._grouped_partials[:win]:
            for i, name in enumerate(("n", "mean", "m2")):
                extra[f"gpp_{name}"] = np.stack(
                    [b[i] for b in self._grouped_partials[:win]])
        if self._group_ids is not None:
            # steering's reallocation rewrites the lane->point map, so it
            # is run state, not only construction input
            extra["group_ids"] = self._group_ids
        if self._steer is not None:
            for k, v in self._steer.state_dict().items():
                extra[f"steer_{k}"] = v
        # keys and draw counters cross as the reference's uint32 words
        pool = self._pull_pool(p, ready)
        for f in ("key", "ctr", "ctr_hi"):
            pool[f] = pool[f].view(np.uint32)
        ckpt_store.save_atomic(path, dict(
            **pool, window=win, cost=self.scheduler._cost,
            rates=np.asarray(self.rates, np.float32), **extra))

    def _pull_pool(self, pools: list, ready) -> dict:
        """The whole pool's leaves as host arrays, for a save, from the
        per-shard pools `pools` (gather-on-save: each shard's rows at its
        offset). On the card each shard's leaves are copied into the
        pinned buffers of `_staging` on its device's side stream, which
        waits for that device's `ready` event (the snapshot's, recorded
        before the block that follows it; else one recorded now), so a
        snapshot's copy runs beside the blocks in flight instead of
        behind them on the one stream. `pools` is held until the copies
        are waited on, so the allocator cannot reuse its memory under a
        side stream; the returned arrays view the buffers and hold until
        the next save."""
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            host = {f: torch.cat([getattr(p, f) for p in pools]).numpy()
                    if len(pools) > 1 else getattr(pools[0], f).numpy()
                    for f in LaneState._fields}
            self.ckpt_pulls.append((time.perf_counter() - t0, 0))
            return host
        if ready is None:
            ready = self._record_events()
        host, sides = self._staging()
        for d, side in sides.items():
            side.wait_event(ready[d])
        per = self.cfg.n_instances // len(pools)
        for k, (p, d) in enumerate(zip(pools, self.devices)):
            with torch.cuda.stream(sides[d]):
                for f in LaneState._fields:
                    host[f][k * per:(k + 1) * per].copy_(
                        getattr(p, f), non_blocking=True)
        for side in sides.values():
            side.synchronize()
        running = sum(not e.done.query() for e in self._pending
                      if e.done is not None)
        self.ckpt_pulls.append((time.perf_counter() - t0, running))
        return {f: h.numpy() for f, h in host.items()}

    def restore(self, path: str) -> None:
        """Load a checkpoint written by either package. Refuses a file
        cut mid-block for this engine's window_block before touching any
        state; rebinds the kernel tables to the restored rates."""
        z = ckpt_store.verify(
            path, required=("x", "t", "key", "steps", "dead",
                            "window", "cost"))
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
        # reshard-on-restore: the file holds the whole pool, split here
        # into this engine's shards whatever shard count saved it
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
                rates_dev = torch.as_tensor(rates[0].copy(),
                                            device=self.device)
            else:
                self.rates = rates
                rates_dev = torch.as_tensor(rates, device=self.device)
            # the kernel tables are bound to the rates: rebind them
            self._install_rates(rates_dev)
        if "group_ids" in z:
            # the saved map reflects any steering reallocations
            self.set_groups(np.asarray(z["group_ids"], np.int32))
        if self._steer is not None:
            # a file without steer_* keys leaves the fresh policy as is;
            # an unsteered engine ignores them, as the reference does
            st = {k[len("steer_"):]: z[k] for k in z
                  if k.startswith("steer_")}
            if st:
                self._steer.load_state(st)
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
        sh, sr = z.get("sketch_hist"), z.get("sketch_rare")
        self._sketches = ([
            WindowSketch(hist=sh[w], rare=(sr[w] if sr is not None else None))
            for w in range(len(sh))] if sh is not None else [])
        # a farm worker's partial stacks (either package's bp_*/gpp_*)
        self._block_partials, self._grouped_partials = (
            [reduction.Welford(*(z[f"{p}_{f}"][w]
                                 for f in ("n", "mean", "m2")))
             for w in range(len(z[f"{p}_n"]))] if f"{p}_n" in z else []
            for p in ("bp", "gpp"))

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
