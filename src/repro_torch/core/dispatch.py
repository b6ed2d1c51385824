"""Window bodies — how the instance pool advances; port of
`repro/core/dispatch.py`'s fused and host-loop strategies.

Two bodies, selected by `SimConfig.use_kernel`, both bitwise identical
per lane, each dense or sparse (`SimConfig.sparse`) and exact or
tau-leaping (`SimConfig.method`):

  unfused (`make_window_body`): the scheduler's lane groups gathered by
      permutation, each advanced by the masked per-lane loop
      (`gillespie.make_advance_fn` over `ssa_step` or the tau step
      `core.tau_leap.make_tau_step`, or `make_sparse_advance_fn` over
      `sparse_ssa_step` with its carried propensities), scattered back;
  kernel (`FusedDispatch.advance`): the whole pool through a fused CUDA
      window (`kernels.ops.window_chunk_loop`,
      `sparse_window_chunk_loop`, `tau_window_chunk_loop` or
      `sparse_tau_window_chunk_loop`, its tables bound to the rates
      once) — one kernel launch per window. Lane groups would not
      change a single trajectory, so the kernel path ignores them.

Both end in the same device-side observable extraction, which is what
keeps the two paths' records bitwise comparable.

Supersteps (`SimConfig.window_block`): `FusedDispatch.advance_block`
queues W window calls back to back on the current stream, each through
the same body `advance` uses, and returns their per-window products as
an on-device ring (`BlockResult`) with no host sync between launches.
`HostLoopDispatch` is the reference's per-group baseline: a gather,
an advance (one kernel launch with `use_kernel=True`) and a scatter per
scheduler group and window.

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

from repro_torch.core.device import to_device
from repro_torch.core.gillespie import (
    LaneState,
    make_advance_fn,
    make_sparse_advance_fn,
    ssa_step,
)
from repro_torch.core.tau_leap import make_tau_step
from repro_torch.kernels.ssa_step import dense_dep_mask
from repro_torch.kernels.ops import (
    bind_sparse_window,
    sparse_tau_window_chunk_loop,
    sparse_window_chunk_loop,
    tau_window_chunk_loop,
    window_chunk_loop,
)


class WindowResult(NamedTuple):
    """What one window hands back to the engine.

    obs: (I, n_obs) window samples (device tensor).
    steps_delta: (I,) per-instance events this window (device tensor).
    truncated: bool 0-dim device tensor on the kernel path, None on
    the unfused path (its loop has no event budget).
    """

    obs: Any
    steps_delta: Any
    truncated: Any = None


def _obs_extractor(obs_idx, device):
    """Device-side observable extraction shared by both bodies. The
    column indices are put on the device once: a Python list index is
    copied from pageable host memory at every call, and that copy waits
    for every window queued before it."""
    cols = [torch.tensor([int(i) for i in ii], dtype=torch.int64,
                         device=device) for ii in obs_idx]

    def extract(x):
        return torch.stack([x[:, c].sum(dim=1) for c in cols], dim=1)

    return extract


def make_window_body(advance_fn, n_lanes: int, obs_idx, device):
    """Whole-pool window advance over scheduler lane groups: gather the
    pool by `perm` (the concatenated, padded groups), advance each
    n_lanes-wide slice with `advance_fn(slice, rates, horizon)`, scatter
    back. Padding duplicates write identical data."""
    extract_obs = _obs_extractor(obs_idx, device)

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
        new_pool = LaneState(*(p.index_put((perm,), v)
                               for p, v in zip(pool, flat)))
        return new_pool, extract_obs(new_pool.x), \
            new_pool.steps - pool.steps

    return window_body


class BlockResult(NamedTuple):
    """One superstep's on-device record ring: W windows queued back to
    back, each window's products in window order, left on the device
    until the engine's collector pulls the block.

    obs: W (I, n_obs) per-window samples.
    steps_end / leaps_end: W int64 0-dim pool-total step/leap counts at
    each window's end (cumulative; the collector takes mod-2^32 deltas
    like the per-window path).
    steps_delta: W (I,) per-instance events per window, only under the
    predictive policy (the scheduler's costs update window by window at
    collect time; regrouping waits for the next block, which never
    changes a trajectory).
    truncated: W bool 0-dim flags on the kernel path, None on the
    unfused path.
    """

    obs: list
    steps_end: list
    leaps_end: list
    steps_delta: Optional[list] = None
    truncated: Optional[list] = None


class FusedDispatch:
    """The whole pool advances one window per call: through the fused
    kernel (`use_kernel=True`, one launch per window) or the unfused
    group loop; `advance_block` queues a block of such windows."""

    def __init__(self, engine):
        self.eng = engine
        cfg = engine.cfg
        self._kernel = cfg.use_kernel
        sp = engine._sparse_tensors
        tau = engine._tau_tables
        self._extract_obs = _obs_extractor(engine.obs_idx, engine.device)
        if self._kernel:
            self.set_rates(engine._rates_dev)
        else:
            if tau is not None:
                advance = make_advance_fn(
                    make_tau_step(tau, cfg.tau_eps, cfg.tau_fallback),
                    engine._tensors_base[:3], cfg.max_steps_per_window)
            elif sp is None:
                advance = make_advance_fn(ssa_step, engine._tensors_base[:3],
                                          cfg.max_steps_per_window)
            else:
                advance = make_sparse_advance_fn(sp,
                                                 cfg.max_steps_per_window)
            self._advance = advance
            self._body = make_window_body(advance, engine.scheduler.n_lanes,
                                          engine.obs_idx, engine.device)

    def set_rates(self, rates) -> None:
        """Bind the kernel path's operands to rates (R,) or (I, R); the
        engine calls this whenever it installs new rates (a sweep, a
        restore)."""
        if self._kernel:
            self._loop, self._tables = self._bind(rates)

    def _bind(self, rates):
        """(window loop, its table operands) for rates (R,) or (B, R)."""
        cfg = self.eng.cfg
        sp = self.eng._sparse_tensors
        tau = self.eng._tau_tables
        base = self.eng._tensors_base[:3]
        # the dense kernels' dependency masks; the CPU twins read none
        dense_mask = (dense_dep_mask(*base)
                      if rates.is_cuda and not cfg.sparse else None)
        if tau is not None:
            loop = (
                partial(sparse_tau_window_chunk_loop, rates=rates,
                        eps=cfg.tau_eps, fallback=cfg.tau_fallback)
                if cfg.sparse else
                partial(tau_window_chunk_loop, rates=rates, eps=cfg.tau_eps,
                        fallback=cfg.tau_fallback, dep_mask=dense_mask))
            return loop, tau
        if sp is None:
            return (partial(window_chunk_loop, dep_mask=dense_mask),
                    (*base, rates))
        return sparse_window_chunk_loop, bind_sparse_window(sp, rates)

    def _kernel_window(self, pool, loop, tables, horizon):
        """One window of `pool` through the bound kernel loop: (new
        pool, truncated)."""
        cfg = self.eng.cfg
        out = loop(pool, tables, horizon, chunk_steps=cfg.kernel_chunk_steps,
                   max_chunks=cfg.kernel_max_chunks)
        return out.state, out.truncated

    def _window(self, horizon, h_dev, perm):
        """Advance the engine's pool one window: (obs, steps_delta,
        truncated or None). horizon: numpy float32 (the kernels take it
        by value); h_dev: the same as a 0-dim device tensor (the unfused
        body's operand)."""
        eng = self.eng
        old = eng._pool
        if self._kernel:
            eng._pool, truncated = self._kernel_window(
                old, self._loop, self._tables, horizon)
            return (self._extract_obs(eng._pool.x),
                    eng._pool.steps - old.steps, truncated)
        eng._pool, obs, steps_delta = self._body(old, eng._rates_dev, perm,
                                                 h_dev)
        return obs, steps_delta, None

    def _horizons(self, horizons):
        """(numpy float32 horizons, the same on the device or None)."""
        hs = np.asarray(horizons, np.float32)
        return hs, (None if self._kernel
                    else to_device(hs, self.eng.device))

    def advance(self, horizon) -> WindowResult:
        """horizon: numpy float32 window end."""
        eng = self.eng
        eng.n_dispatches += 1
        perm = None if self._kernel else eng._permutation()
        hs, hd = self._horizons([horizon])
        return WindowResult(*self._window(hs[0], None if hd is None
                                          else hd[0], perm))

    def advance_block(self, horizons) -> BlockResult:
        """Queue one window per horizon back to back on the current
        stream (no host sync between them) and return the block's ring.
        One dispatch in the telemetry."""
        eng = self.eng
        eng.n_dispatches += 1
        perm = None if self._kernel else eng._permutation()
        predictive = eng.scheduler.policy == "predictive"
        ring = BlockResult([], [], [], [] if predictive else None,
                           [] if self._kernel else None)
        hs, hd = self._horizons(horizons)
        for w in range(len(hs)):
            obs, steps_delta, truncated = self._window(
                hs[w], None if hd is None else hd[w], perm)
            ring.obs.append(obs)
            ring.steps_end.append(eng._pool.steps.sum(dtype=torch.int64))
            ring.leaps_end.append(eng._pool.leaps.sum(dtype=torch.int64))
            if predictive:
                ring.steps_delta.append(steps_delta)
            if self._kernel:
                ring.truncated.append(truncated)
        return ring


class HostLoopDispatch(FusedDispatch):
    """The reference's host-loop baseline: per scheduler group and
    window a gather, an advance and a scatter — with `use_kernel=True`
    one window-kernel launch per group. The groups' truncation flags
    are ORed on the device; nothing is pulled mid-window."""

    def _window(self, horizon, h_dev, perm):
        eng = self.eng
        start = eng._pool
        rates = eng._rates_dev
        per_lane = rates.ndim == 2
        n = eng.scheduler.n_lanes
        truncated = None
        for lo in range(0, perm.shape[0], n):
            idx = perm[lo:lo + n]  # one scheduler group
            sl = LaneState(*(a[idx] for a in eng._pool))
            r = rates[idx] if per_lane else rates
            eng.n_dispatches += 1
            if self._kernel:
                loop, tables = ((self._loop, self._tables) if not per_lane
                                else self._bind(r))
                sl, trunc = self._kernel_window(sl, loop, tables, horizon)
                truncated = trunc if truncated is None else truncated | trunc
            else:
                sl = self._advance(sl, r, h_dev)
            # padding duplicates write identical data
            eng._pool = LaneState(*(a.index_put((idx,), v)
                                    for a, v in zip(eng._pool, sl)))
        return (eng._observe(), eng._pool.steps - start.steps, truncated)

    def advance(self, horizon) -> WindowResult:
        # one dispatch per group, counted in _window
        hs = np.asarray([horizon], np.float32)
        return WindowResult(*self._window(
            hs[0], to_device(hs, self.eng.device)[0],
            self.eng._permutation()))

    def advance_block(self, horizons) -> BlockResult:
        raise NotImplementedError(
            "the host loop has no superstep path; window_block > 1 needs "
            "the fused strategy (SimConfig refuses it with host_loop)")
