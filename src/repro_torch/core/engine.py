"""SimulationEngine — the windowed ensemble simulator; port of the
per-window path of `repro/core/engine.py`.

Runs an ensemble of stochastic CWC simulations (replicas and/or a
parameter sweep) under one of the paper's three schemas:

  schema "i"   static farm, post-hoc reduction (baseline)
  schema "ii"  time-sliced self-balancing farm, post-hoc reduction
  schema "iii" time-sliced farm + on-line windowed reduction

Each window advances the whole instance pool (core/dispatch.py): with
`use_kernel=True` through a fused CUDA window, one kernel launch per
window; otherwise through the unfused group loop. `sparse=True`
switches both to the sparse exact step (dependency-graph propensity
updates, no S/R cap of the dense kernel, any reactant coefficient). All
four give the same bits. `method="tau_leap"` runs adaptive tau-leaping
(core/tau_leap.py) instead of exact SSA on every one of these paths,
again with the same bits on all four. The window's statistics,
step/leap counters and the kernel's truncation flag then come to the
host in ONE combined device-to-host copy, and a `StatsRecord` is
emitted.

Not ported yet (each raises in `repro_torch.api` before an engine is
built): sketches, steering, supervision, multi-shard partitioning,
supersteps and pipelining, the host-loop dispatch strategy, and
checkpoints.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import torch

from repro_torch.core import reduction
from repro_torch.core.cwc.compile import compile_model
from repro_torch.core.cwc.rules import CWCModel
from repro_torch.core.device import resolve_device
from repro_torch.core.dispatch import FusedDispatch
from repro_torch.core.gillespie import (
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

    def __post_init__(self):
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
        self._dispatch = FusedDispatch(self)
        self._pool = init_lanes(self.system, cfg.n_instances, cfg.seed,
                                device=self.device)

    # -------------------------------------------------------- re-spec
    def set_rates(self, rates) -> None:
        """Install a per-instance (I, R) rate matrix (parameter sweep).
        Must happen before the first window runs."""
        if self._window:
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
        perm = torch.as_tensor(
            np.concatenate(self.scheduler.groups()).astype(np.int64),
            device=self.device)
        if not predictive:
            self._perm_cache = perm
        return perm

    # ------------------------------------------------------------------
    def run_window(self) -> StatsRecord:
        """Advance every instance to the next grid point and emit its
        record. Schemas share this loop; they differ in grouping policy
        (schema i: static_rr) and in what is buffered (i/ii: raw
        samples; iii: nothing beyond the record)."""
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
        stats = reduction.blocked_stats(obs, cfg.stat_blocks)
        # ONE combined blocking pull: the record's moments, the pool's
        # step/leap totals and (kernel path) the truncation flag, each
        # widened exactly to float64 and copied to the host together
        n_obs = obs.shape[1]
        parts = [stats.mean, stats.var, stats.ci90, stats.n,
                 self._pool.steps.sum(dtype=torch.int64),
                 self._pool.leaps.sum(dtype=torch.int64)]
        if res.truncated is not None:
            parts.append(res.truncated)
        t_pull = time.perf_counter()
        packed = torch.cat([p.reshape(-1).to(torch.float64)
                            for p in parts]).cpu().numpy()
        self.n_host_syncs += 1
        mean, var, ci90, n = (packed[i * n_obs:(i + 1) * n_obs].astype(
            np.float32) for i in range(4))
        steps_sum, leaps_sum = packed[4 * n_obs:4 * n_obs + 2]
        if res.truncated is not None and packed[-1]:
            self._raise_truncated(w, float(self.grid[w]))
        self._guard_stats(w, mean, var)
        # cumulative totals tracked as residues mod 2^32 (the reference's
        # int32 device sums wrap there), per-window deltas exact
        steps_cum = int(steps_sum) & 0xFFFFFFFF
        leaps_cum = int(leaps_sum) & 0xFFFFFFFF
        self.window_steps.append((steps_cum - self._cum_steps) & 0xFFFFFFFF)
        self.window_leaps.append((leaps_cum - self._cum_leaps) & 0xFFFFFFFF)
        self._cum_steps, self._cum_leaps = steps_cum, leaps_cum
        obs_bytes = obs.numel() * obs.element_size()
        if cfg.schema in ("i", "ii") or self._record_trajectories:
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
        rec = StatsRecord(t=float(self.grid[w]), window=w, mean=mean,
                          var=var, ci90=ci90, n=float(n.max()))
        self.stream.emit(rec)
        self.block_walls.append(
            (w, 1, self.wall_times[-1], time.perf_counter() - t_pull))
        self._window += 1
        return rec

    def _raise_truncated(self, window: int, horizon: float):
        from repro_torch.kernels.ops import FusedWindowTruncated

        cfg = self.cfg
        raise FusedWindowTruncated(
            f"window {window} (horizon {horizon:g}) exhausted "
            f"kernel_max_chunks={cfg.kernel_max_chunks} x "
            f"kernel_chunk_steps={cfg.kernel_chunk_steps} events with "
            "live lanes still below the horizon; raise those limits "
            "or use more windows")

    def _guard_stats(self, window: int, mean, var) -> None:
        """Host-side invariant checks on the moments already pulled:
        observables are sums of species counts, so a sound pool gives
        finite, non-negative means."""
        if not (np.isfinite(mean).all() and np.isfinite(var).all()):
            raise InvariantViolation(
                f"engine invariant 'non_finite_stats' violated at window "
                f"{window}: window statistics contain NaN/inf",
                window=window, check="non_finite_stats")
        if (mean < 0.0).any():
            raise InvariantViolation(
                f"engine invariant 'negative_population' violated at "
                f"window {window}: window mean dipped below zero (min "
                f"{mean.min():g})", window=window,
                check="negative_population")

    def run(self) -> list[StatsRecord]:
        while self._window < len(self.grid):
            self.run_window()
        return self.stream.records()

    @property
    def peak_buffered_bytes(self) -> int:
        return self._peak_buffered

    def trajectories(self) -> Optional[np.ndarray]:
        """(I, T, n_obs) raw samples. Buffered for schemas i/ii; for
        schema iii only when record_trajectories was requested."""
        if not self._samples:
            return None
        return np.stack(self._samples, axis=1)

    def grouped_stats(self) -> list[reduction.Stats]:
        """Per-window grouped Stats ((n_groups, n_obs) leaves) when a
        grouped reduction is enabled via set_groups()."""
        return list(self._grouped)
