"""Window bodies — how the instance pool advances one window; port of
the per-window fused strategy of `repro/core/dispatch.py`.

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
"""
from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import torch

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


def _obs_extractor(obs_idx):
    """Device-side observable extraction shared by both bodies."""
    obs_idx = tuple(tuple(int(i) for i in ii) for ii in obs_idx)

    def extract(x):
        return torch.stack([x[:, list(ii)].sum(dim=1) for ii in obs_idx],
                           dim=1)

    return extract


def make_window_body(advance_fn, n_lanes: int, obs_idx):
    """Whole-pool window advance over scheduler lane groups: gather the
    pool by `perm` (the concatenated, padded groups), advance each
    n_lanes-wide slice with `advance_fn(slice, rates, horizon)`, scatter
    back. Padding duplicates write identical data."""
    extract_obs = _obs_extractor(obs_idx)

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


class FusedDispatch:
    """The whole pool advances one window per call: through the fused
    kernel (`use_kernel=True`, one launch per window) or the unfused
    group loop."""

    def __init__(self, engine):
        self.eng = engine
        cfg = engine.cfg
        self._kernel = cfg.use_kernel
        sp = engine._sparse_tensors
        tau = engine._tau_tables
        if self._kernel:
            self._extract_obs = _obs_extractor(engine.obs_idx)
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
            self._body = make_window_body(advance, engine.scheduler.n_lanes,
                                          engine.obs_idx)

    def set_rates(self, rates) -> None:
        """Bind the kernel path's operands to rates (R,) or (I, R); the
        engine calls this whenever it installs new rates."""
        if not self._kernel:
            return
        cfg = self.eng.cfg
        sp = self.eng._sparse_tensors
        tau = self.eng._tau_tables
        base = self.eng._tensors_base[:3]
        # the dense kernels' dependency masks; the CPU twins read none
        dense_mask = (dense_dep_mask(*base)
                      if rates.is_cuda and not cfg.sparse else None)
        if tau is not None:
            self._loop = (
                partial(sparse_tau_window_chunk_loop, rates=rates,
                        eps=cfg.tau_eps, fallback=cfg.tau_fallback)
                if cfg.sparse else
                partial(tau_window_chunk_loop, rates=rates, eps=cfg.tau_eps,
                        fallback=cfg.tau_fallback, dep_mask=dense_mask))
            self._tables = tau
        elif sp is None:
            self._loop = partial(window_chunk_loop, dep_mask=dense_mask)
            self._tables = (*base, rates)
        else:
            self._loop = sparse_window_chunk_loop
            self._tables = bind_sparse_window(sp, rates)

    def advance(self, horizon) -> WindowResult:
        """horizon: numpy float32 window end."""
        eng = self.eng
        eng.n_dispatches += 1
        if self._kernel:
            cfg = eng.cfg
            old = eng._pool
            out = self._loop(old, self._tables, horizon,
                             chunk_steps=cfg.kernel_chunk_steps,
                             max_chunks=cfg.kernel_max_chunks)
            eng._pool = out.state
            return WindowResult(self._extract_obs(out.state.x),
                                out.state.steps - old.steps, out.truncated)
        h = torch.as_tensor(horizon, device=eng.device)
        eng._pool, obs, steps_delta = self._body(
            eng._pool, eng._rates_dev, eng._permutation(), h)
        return WindowResult(obs, steps_delta)
