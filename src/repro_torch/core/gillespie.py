"""Batched exact SSA (Gillespie direct method) with sim-time windows;
port of the dense exact path of `repro/core/gillespie.py`.

The paper's three logical steps (Match → Resolve → Update, §2.3) are
tensor ops over the lane axis:

  Match   = `propensities` (lanes × reactions, rates first)
  Resolve = exponential waiting time + inverse-CDF reaction choice
  Update  = add the fired reaction's stoichiometry row

`advance_to(horizon)` is the schema-(ii) time slice: every lane steps
until its clock would cross the horizon; the crossing event is not
applied — the lane freezes exactly at the horizon.

Bitwise parity with the reference needs three things the torch
defaults do not give: the port-owned `log_f32` (core/mathf.py), a0 and
the cumulative sum accumulated left to right in an explicit loop over
R (XLA:CPU reduces that way for small R; `torch.cumsum` does not), and
the first-true index of the inverse-CDF test.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.mathf import log_f32
from repro_torch.core.reactions import (
    ReactionSystem,
    propensities,
    require_dense_capable,
)
from repro_torch.core.stream import (
    counter_uniforms,
    ctr_add,
    from_words,
    lane_keys,
    to_words,
)

_A0_FLOOR = float(np.float32(1e-30))


class LaneState(NamedTuple):
    x: torch.Tensor  # (B, S) float32 counts
    t: torch.Tensor  # (B,) float32 sim clocks
    key: torch.Tensor  # (B, 2) int32 bit patterns of the uint32 key
    ctr: torch.Tensor  # (B,) int32 bits: draw counter, low word
    ctr_hi: torch.Tensor  # (B,) int32 bits: draw counter, high word
    steps: torch.Tensor  # (B,) int32 events fired
    leaps: torch.Tensor  # (B,) int32 accepted tau-leaps (0 on exact)
    dead: torch.Tensor  # (B,) bool: no reaction can ever fire again
    no_leap: torch.Tensor  # (B,) bool: steering's exact-only pin


def init_lanes(system: ReactionSystem, n_lanes: int, seed: int,
               x0=None, device=None) -> LaneState:
    x0 = torch.as_tensor(np.asarray(system.x0 if x0 is None else x0,
                                    np.float32), device=device)
    if x0.ndim == 1:
        x0 = x0.expand(n_lanes, x0.shape[0])
    zi = torch.zeros((n_lanes,), dtype=torch.int32, device=device)
    zb = torch.zeros((n_lanes,), dtype=torch.bool, device=device)
    return LaneState(
        x=x0.contiguous(),
        t=torch.zeros((n_lanes,), dtype=torch.float32, device=device),
        key=lane_keys(seed, n_lanes, device=device),
        ctr=zi, ctr_hi=zi.clone(), steps=zi.clone(), leaps=zi.clone(),
        dead=zb, no_leap=zb.clone())


def ssa_step(state: LaneState, system_tensors, horizon) -> LaneState:
    """One vectorised direct-method step, masked at the horizon.

    system_tensors: (idx, coef, delta_f32, rates) tensors; rates may be
    (R,) or (B, R). horizon: a float32 0-dim tensor (or a float32
    value) on the pool's device.
    """
    idx, coef, delta, rates = system_tensors
    active = (state.t < horizon) & ~state.dead
    a = propensities(state.x, idx, coef, rates)  # (B, R)
    n_r = a.shape[1]
    a0 = torch.zeros_like(state.t)
    for r in range(n_r):
        a0 = a0 + a[:, r]
    now_dead = a0 <= 0.0
    k = to_words(state.key)
    u1, u2 = counter_uniforms(k[:, 0], k[:, 1], to_words(state.ctr),
                              to_words(state.ctr_hi))
    tau = -log_f32(u1) / torch.clamp_min(a0, _A0_FLOOR)
    t_next = state.t + tau
    fire = active & ~now_dead & (t_next <= horizon)
    # inverse-CDF choice: first j with cumsum(a)_j >= u2 * a0 (0 if none)
    thresh = u2 * a0
    cum = torch.zeros_like(a0)
    j = torch.zeros(a0.shape, dtype=torch.int64, device=a0.device)
    found = torch.zeros_like(now_dead)
    for r in range(n_r):
        cum = cum + a[:, r]
        hit = (cum >= thresh) & ~found
        j = torch.where(hit, r, j)
        found = found | hit
    x = torch.where(fire[:, None], state.x + delta[j], state.x)
    # fired lanes advance to t_next; an active lane that did not fire
    # (dead, or its next event would cross) freezes at the horizon
    t = torch.where(fire, t_next,
                    torch.where(active, horizon, state.t))
    lo, hi = ctr_add(to_words(state.ctr), to_words(state.ctr_hi),
                     active.to(torch.int64))
    return LaneState(
        x=x, t=t, key=state.key, ctr=from_words(lo), ctr_hi=from_words(hi),
        steps=state.steps + fire.to(torch.int32), leaps=state.leaps,
        dead=state.dead | (active & now_dead), no_leap=state.no_leap)


def live(state: LaneState, horizon) -> torch.Tensor:
    """(B,) bool: lanes still below the horizon and not dead."""
    return (state.t < horizon) & ~state.dead


def system_tensors(system: ReactionSystem, rates=None, device=None):
    """Dense gather-form tensors (idx_i32, coef_i32, delta_f32,
    rates_f32) — the layout both the plain step and the CUDA kernel
    take. Refuses systems the dense comb unroll would mis-evaluate."""
    require_dense_capable(system)
    return (
        torch.as_tensor(system.reactant_idx.astype(np.int32), device=device),
        torch.as_tensor(system.reactant_coef.astype(np.int32),
                        device=device),
        torch.as_tensor(system.delta.astype(np.float32), device=device),
        torch.as_tensor(np.asarray(system.rates if rates is None else rates,
                                   np.float32), device=device),
    )


def make_advance_fn(step_fn, tensors3, max_steps: Optional[int]):
    """Build `advance(lane_slice, rates, horizon) -> LaneState`: the
    masked per-lane loop to the horizon, bounded by max_steps when set
    (the dense branch of the reference's `make_advance_fn`). Finished
    lanes are exact no-ops inside `step_fn`, so stopping the loop once
    no lane is live gives the same bits as running on."""
    idx_t, coef_t, delta_t = tensors3

    def advance(sl: LaneState, rates, horizon):
        tensors = (idx_t, coef_t, delta_t, rates)
        n = 0
        while (max_steps is None or n < max_steps) and bool(
                live(sl, horizon).any()):
            sl = step_fn(sl, tensors, horizon)
            n += 1
        return sl._replace(
            t=torch.where(sl.dead, torch.maximum(sl.t, horizon), sl.t))

    return advance


def advance_to(state: LaneState, system_tensors, horizon,
               max_steps: Optional[int] = None) -> LaneState:
    """Advance every lane exactly to `horizon` (schema-ii time slice)."""
    idx, coef, delta, rates = system_tensors
    horizon = torch.as_tensor(np.float32(horizon), device=state.t.device)
    return make_advance_fn(ssa_step, (idx, coef, delta), max_steps)(
        state, rates, horizon)
