"""Window bodies and dispatch strategies — how the instance pool
advances; port of `repro/core/dispatch.py`.

Two bodies, selected by `SimConfig.use_kernel`, both bitwise identical
per lane, each dense or sparse (`SimConfig.sparse`) and exact or
tau-leaping (`SimConfig.method`):

  unfused (`make_window_body`): the scheduler's lane groups gathered by
      permutation, each advanced by the masked per-lane loop
      (`gillespie.make_advance_fn` over `ssa_step` or the tau step
      `core.tau_leap.make_tau_step`, or `make_sparse_advance_fn` over
      `sparse_ssa_step` with its carried propensities), scattered back;
  kernel (`_ShardBody`): the pool through a fused CUDA window
      (`kernels.ops.window_chunk_loop`, `sparse_window_chunk_loop`,
      `tau_window_chunk_loop` or `sparse_tau_window_chunk_loop`, its
      tables bound to the rates once) — one kernel launch per window.
      Lane groups would not change a single trajectory, so the kernel
      path ignores them.

Two strategies drive them:

  FusedDispatch: the pool as K contiguous shards (`Partitioning`; K = 1
      unsharded), each on its own device (entries may repeat), each
      advanced by its own body bound to its own rate slice — K kernel
      launches per window, one dispatch; the port of the reference's
      FusedDispatch and ShardedDispatch in one. Each shard folds its
      observables into its V/K Welford block partials (and grouped
      partials and int32 sketch counts) on its device; only those
      cross to the lead device (`reduction.gather_blocks_over_axis`),
      so nothing of size (I, n_obs) crosses shards unless trajectories
      are buffered. Records are bitwise the unsharded run's at the same
      stat_blocks, for any shard count. Every launch goes on its
      device's current stream, so shards on one card run back to back;
  HostLoopDispatch: the reference's per-group baseline, one dispatch
      (and kernel launch) per scheduler group and window.

Both hand the engine the same `WindowResult`: the block stack, the
pool totals, the truncation flag and, where asked, grouped partials and
a sketch, on the lead device. The engine folds the stack by the same
ops whatever produced it, which is what keeps their records bitwise
comparable.

Supersteps (`SimConfig.window_block`): `advance_block` queues W window
calls back to back, each through the same per-window code, with no
host sync between launches.

Nothing here writes a pool leaf in place: every kernel writes fresh
outputs (`ssa_step._pool_outputs`), `_window_out` builds a new
`LaneState`, and the scatters are out-of-place `index_put`s. The
engine's ring snapshots rely on it: they hold an earlier pool's tensors
by reference, with no copy.
"""
from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import reduction, trace
from repro_torch.core.device import to_device
from repro_torch.core.gillespie import (
    LaneState,
    make_advance_fn,
    make_sparse_advance_fn,
    ssa_step,
)
from repro_torch.core.tau_leap import make_tau_step
from repro_torch.kernels.ssa_step import bind_network, dense_dep_mask
from repro_torch.kernels.ops import (
    bind_sparse_window,
    sparse_tau_window_chunk_loop,
    sparse_window_chunk_loop,
    tau_window_chunk_loop,
    window_chunk_loop,
)


class WindowResult(NamedTuple):
    """What one window hands back to the engine; everything but `obs`
    and `steps_delta` sits on the lead device.

    obs: per-shard (I/K, n_obs) window samples, in shard order, each on
    its shard's device.
    stack: the (V, n_obs) Welford block partials of the window.
    steps_sum / leaps_sum: int64 0-dim pool totals at the window's end.
    truncated: bool 0-dim on the kernel path (any shard's budget ran
    out), None on the unfused path (its loop has no event budget).
    steps_delta: per-shard (I/K,) events this window, only under the
    predictive policy.
    grouped: the (V, G, n_obs) per-group block partials, with groups.
    sketch: (hist, rare or None) int32 counts, with a SketchSpec.
    """

    obs: list
    stack: reduction.Welford
    steps_sum: Any
    leaps_sum: Any
    truncated: Any = None
    steps_delta: Optional[list] = None
    grouped: Optional[reduction.Welford] = None
    sketch: Optional[tuple] = None


def _obs_extractor(obs_idx, device):
    """Device-side observable extraction shared by both bodies. The
    column indices are put on the device once: a Python list index is
    copied from pageable host memory at every call, and that copy waits
    for every window queued before it. Where every observable is one
    species (a model without declared observables), one gather takes
    them all: a one-term sum of a count is the count."""
    if all(len(ii) == 1 for ii in obs_idx):
        flat = torch.tensor([int(ii[0]) for ii in obs_idx],
                            dtype=torch.int64, device=device)
        return lambda x: x.index_select(1, flat)
    cols = [torch.tensor([int(i) for i in ii], dtype=torch.int64,
                         device=device) for ii in obs_idx]

    def extract(x):
        return torch.stack([x[:, c].sum(dim=1) for c in cols], dim=1)

    return extract


def make_window_body(advance_fn, n_lanes: int):
    """Pool window advance over scheduler lane groups: gather the pool
    by `perm` (the concatenated, padded groups, pool-local indices),
    advance each n_lanes-wide slice with `advance_fn(slice, rates,
    horizon)`, scatter back. Padding duplicates write identical data."""

    def window_body(pool: LaneState, rates, perm, horizon):
        lanes = LaneState(*(a[perm] for a in pool))
        per_lane = rates.ndim == 2
        rates_p = rates[perm] if per_lane else rates
        parts = []
        for lo in range(0, perm.shape[0], n_lanes):
            sl = slice(lo, lo + n_lanes)
            parts.append(advance_fn(LaneState(*(a[sl] for a in lanes)),
                                    rates_p[sl] if per_lane else rates,
                                    horizon))
        flat = [torch.cat(leaf) for leaf in zip(*parts)]
        return LaneState(*(p.index_put((perm,), v)
                           for p, v in zip(pool, flat)))

    return window_body


class _ShardBody:
    """One pool slice's window advance on its device: the fused kernel
    loop bound to the slice's rates, or the unfused group loop. An
    unsharded run has one, over the whole pool."""

    def __init__(self, engine, device):
        self.eng = engine
        self.device = device
        cfg = engine.cfg
        self._kernel = cfg.use_kernel
        self._bound = None  # the dense kernel's, at the first bind
        base, sp, tau = engine._tables_on(device)
        self.extract_obs = _obs_extractor(engine.obs_idx, device)
        if not self._kernel:
            if tau is not None:
                advance = make_advance_fn(
                    make_tau_step(tau, cfg.tau_eps, cfg.tau_fallback),
                    base[:3], cfg.max_steps_per_window)
            elif sp is None:
                advance = make_advance_fn(ssa_step, base[:3],
                                          cfg.max_steps_per_window)
            else:
                advance = make_sparse_advance_fn(sp,
                                                 cfg.max_steps_per_window)
            self.advance = advance
            self._body = make_window_body(advance, engine.scheduler.n_lanes)

    def set_rates(self, rates) -> None:
        """Bind the kernel path's operands to this slice's rates (R,) or
        (I/K, R)."""
        if self._kernel:
            self.loop, self.tables = self.bind(rates)

    def bind(self, rates):
        """(window loop, its table operands) for rates (R,) or (B, R) on
        this body's device."""
        cfg = self.eng.cfg
        base, sp, tau = self.eng._tables_on(self.device)
        if tau is not None:
            if cfg.sparse:
                return partial(sparse_tau_window_chunk_loop, rates=rates,
                               eps=cfg.tau_eps, fallback=cfg.tau_fallback), tau
            return partial(tau_window_chunk_loop, rates=rates,
                           eps=cfg.tau_eps, fallback=cfg.tau_fallback,
                           **self._dense_bound(rates)), tau
        if sp is None:
            return (partial(window_chunk_loop, **self._dense_bound(rates)),
                    (*base[:3], rates))
        return sparse_window_chunk_loop, bind_sparse_window(sp, rates)

    def _dense_bound(self, rates) -> dict:
        """The dense kernel's bound operand on the card, derived at the
        first bind (the tables never change; the CPU twins read none):
        `net`, the exact kernel generated for the network, or the tau
        kernel's `dep_mask`."""
        if not rates.is_cuda:
            return {}
        if self._bound is None:
            base, _, tau = self.eng._tables_on(self.device)
            self._bound = (
                {"net": bind_network(*base[:3])} if tau is None
                else {"dep_mask": dense_dep_mask(*base[:3])})
        return self._bound

    def kernel_window(self, pool, loop, tables, horizon):
        """One window of `pool` through a bound kernel loop: (new pool,
        truncated)."""
        cfg = self.eng.cfg
        out = loop(pool, tables, horizon, chunk_steps=cfg.kernel_chunk_steps,
                   max_chunks=cfg.kernel_max_chunks)
        return out.state, out.truncated

    def window(self, pool, rates, perm, horizon, h_dev):
        """Advance `pool` one window: (new pool, truncated or None).
        horizon: numpy float32 (the kernels take it by value); h_dev:
        the same as a 0-dim tensor on this device (the unfused body's
        operand); perm: the slice's lane groups (unfused only)."""
        if self._kernel:
            return self.kernel_window(pool, self.loop, self.tables, horizon)
        return self._body(pool, rates, perm, h_dev), None


class FusedDispatch:
    """The pool advances one window per dispatch through its shard
    bodies (`Partitioning(n_shards=K)`; one body over the whole pool
    unsharded): shard k is the contiguous instance block
    [k*I/K, (k+1)*I/K) on its own device, advanced by its own body bound
    to its own rate slice; the unfused form takes its slice of the
    shard-major permutation. Per window, one dispatch and K launches;
    the block partials meet on the lead device, so records are bitwise
    the unsharded run's at the same stat_blocks. `advance_block` queues
    a block of such windows."""

    def __init__(self, engine):
        self.eng = engine
        self._kernel = engine.cfg.use_kernel
        self._bodies = [_ShardBody(engine, d) for d in engine.devices]
        # the devices the shards occupy, each once, lead device first
        self.devices = list(dict.fromkeys(engine.devices))
        if self._kernel:
            self.set_rates(engine._rates_shards)

    def set_rates(self, rates_shards) -> None:
        """Bind each body's kernel operands to its rate slice; the engine
        calls this whenever it installs new rates (a sweep, a restore, a
        steering move)."""
        for body, rates in zip(self._bodies, rates_shards):
            body.set_rates(rates)

    def extract_obs(self, pools) -> list:
        """Per-shard (I/K, n_obs) observables of `pools`."""
        return [b.extract_obs(p.x) for b, p in zip(self._bodies, pools)]

    def _horizons(self, horizons):
        """(numpy float32 horizons, {device: the same as a device
        tensor} or None on the kernel path)."""
        hs = np.asarray(horizons, np.float32)
        return hs, (None if self._kernel else
                    {d: to_device(hs, d) for d in self.devices})

    def _products(self, pools, obs, deltas, truncs) -> WindowResult:
        """The window's results from each shard's new pool, observables,
        step deltas and truncation flag: each shard's block partials,
        grouped partials and sketch counts computed on its own device,
        then gathered, summed or ORed on the lead device in shard
        order."""
        eng = self.eng
        lead = eng.device
        v_loc = eng.cfg.stat_blocks // len(pools)

        def total(parts):
            out = parts[0].to(lead)
            for p in parts[1:]:
                out = out + p.to(lead)
            return out

        stack = reduction.gather_blocks_over_axis(
            [reduction.blocked_welford(o, v_loc) for o in obs], lead)
        truncated = None
        if truncs[0] is not None:
            truncated = truncs[0].to(lead)
            for t in truncs[1:]:
                truncated = truncated | t.to(lead)
        grouped = None
        if eng._group_ids is not None:
            grouped = reduction.gather_blocks_over_axis([
                reduction.blocked_grouped_welford(o, g, eng._n_groups, v_loc)
                for o, g in zip(obs, eng._gids_shards)], lead)
        sketch = None
        if eng._sketch is not None:
            counts = [eng._sketch_eval(o, g) for o, g in zip(
                obs, eng._gids_shards or [None] * len(obs))]
            sketch = (total([c[0] for c in counts]),
                      None if counts[0][1] is None
                      else total([c[1] for c in counts]))
        return WindowResult(
            obs=obs, stack=stack,
            steps_sum=total([p.steps.sum(dtype=torch.int64) for p in pools]),
            leaps_sum=total([p.leaps.sum(dtype=torch.int64) for p in pools]),
            truncated=truncated, steps_delta=deltas, grouped=grouped,
            sketch=sketch)

    def _window(self, horizon, h_dev, perms) -> WindowResult:
        """Advance every shard of the engine's pool one window."""
        eng = self.eng
        old = eng._pools
        new, truncs = [], []
        for k, body in enumerate(self._bodies):
            with trace.span(trace.WINDOW_KERNEL):
                pool, trunc = body.window(
                    old[k], eng._rates_shards[k], perms and perms[k],
                    horizon, h_dev and h_dev[body.device])
            new.append(pool)
            truncs.append(trunc)
        eng._pools = new
        deltas = ([n.steps - o.steps for n, o in zip(new, old)]
                  if eng.scheduler.policy == "predictive" else None)
        with trace.span(trace.WINDOW_FOLD):
            return self._products(new, self.extract_obs(new), deltas,
                                  truncs)

    def advance(self, horizon) -> WindowResult:
        """horizon: numpy float32 window end."""
        eng = self.eng
        eng.n_dispatches += 1
        perms = None if self._kernel else eng._permutations()
        hs, hd = self._horizons([horizon])
        return self._window(hs[0], hd and {d: h[0] for d, h in hd.items()},
                            perms)

    def advance_block(self, horizons) -> list[WindowResult]:
        """Queue one window per horizon back to back (no host sync
        between them) and return each window's results in order. One
        dispatch in the telemetry; the predictive policy's groups are
        those of the block's start (regrouping waits for the next block,
        which never changes a trajectory)."""
        eng = self.eng
        eng.n_dispatches += 1
        perms = None if self._kernel else eng._permutations()
        hs, hd = self._horizons(horizons)
        return [self._window(hs[w], hd and {d: h[w] for d, h in hd.items()},
                             perms) for w in range(len(hs))]


class HostLoopDispatch(FusedDispatch):
    """The reference's host-loop baseline: per scheduler group and
    window a gather, an advance and a scatter — with `use_kernel=True`
    one window-kernel launch per group. The groups' truncation flags
    are ORed on the device; nothing is pulled mid-window. Unsharded
    only."""

    def _window(self, horizon, h_dev, perms) -> WindowResult:
        eng = self.eng
        body = self._bodies[0]
        start = pool = eng._pools[0]
        rates = eng._rates_shards[0]
        per_lane = rates.ndim == 2
        n = eng.scheduler.n_lanes
        truncated = None
        for lo in range(0, perms[0].shape[0], n):
            idx = perms[0][lo:lo + n]  # one scheduler group
            sl = LaneState(*(a[idx] for a in pool))
            r = rates[idx] if per_lane else rates
            eng.n_dispatches += 1
            with trace.span(trace.WINDOW_KERNEL):
                if self._kernel:
                    loop, tables = ((body.loop, body.tables) if not per_lane
                                    else body.bind(r))
                    sl, trunc = body.kernel_window(sl, loop, tables, horizon)
                    truncated = (trunc if truncated is None
                                 else truncated | trunc)
                else:
                    sl = body.advance(sl, r, h_dev[body.device])
            # padding duplicates write identical data
            pool = LaneState(*(a.index_put((idx,), v)
                               for a, v in zip(pool, sl)))
        eng._pools = [pool]
        deltas = ([pool.steps - start.steps]
                  if eng.scheduler.policy == "predictive" else None)
        with trace.span(trace.WINDOW_FOLD):
            return self._products([pool], self.extract_obs([pool]), deltas,
                                  [truncated])

    def advance(self, horizon) -> WindowResult:
        # one dispatch per group, counted in _window
        hs, _ = self._horizons([horizon])
        hd = {d: to_device(hs, d)[0] for d in self.devices}
        return self._window(hs[0], hd, self.eng._permutations())

    def advance_block(self, horizons):
        raise NotImplementedError(
            "the host loop has no superstep path; window_block > 1 needs "
            "the fused strategy (SimConfig refuses it with host_loop)")
