"""Batched exact SSA (Gillespie direct method) with sim-time windows;
port of the dense and sparse exact paths of `repro/core/gillespie.py`.

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

The sparse path (`sparse_ssa_step`) carries the (B, R) propensity
vector across events and recomputes only the rows of the fired
reaction's dependency list. The reference's `mode="drop"` scatters and
`mode="fill"` gathers are written with one extra junk column: the
population gather reads column S, which holds 1.0; the carried
propensities and the population update scatter pad entries into a
column that is then cut off.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.mathf import log_f32
from repro_torch.core.reactions import (
    ReactionSystem,
    SparseTables,
    comb_factors,
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


def propensity_sum(a):
    """a0: the (B,) sum of the (B, R) propensities, left to right over R
    from zero (XLA:CPU's order for small R; `torch.sum` is not)."""
    a0 = torch.zeros_like(a[:, 0])
    for r in range(a.shape[1]):
        a0 = a0 + a[:, r]
    return a0


def direct_method(a, a0, t, u1, u2):
    """The direct method's Resolve from one counter block's uniforms:
    (t_next, j) with t_next = t - log(u1) / max(a0, 1e-30) and j the
    first r whose left-to-right running sum of `a` reaches u2 * a0 (0
    if none). Shared by the exact step and tau-leaping's exact
    sub-step, so the two spell it alike."""
    t_next = t + -log_f32(u1) / torch.clamp_min(a0, _A0_FLOOR)
    thresh = u2 * a0
    cum = torch.zeros_like(a0)
    j = torch.zeros(a0.shape, dtype=torch.int64, device=a0.device)
    found = torch.zeros(a0.shape, dtype=torch.bool, device=a0.device)
    for r in range(a.shape[1]):
        cum = cum + a[:, r]
        hit = (cum >= thresh) & ~found
        j = torch.where(hit, r, j)
        found = found | hit
    return t_next, j


def ssa_step(state: LaneState, system_tensors, horizon) -> LaneState:
    """One vectorised direct-method step, masked at the horizon.

    system_tensors: (idx, coef, delta_f32, rates) tensors; rates may be
    (R,) or (B, R). horizon: a float32 0-dim tensor (or a float32
    value) on the pool's device.
    """
    idx, coef, delta, rates = system_tensors
    active = (state.t < horizon) & ~state.dead
    a = propensities(state.x, idx, coef, rates)  # (B, R)
    a0 = propensity_sum(a)
    now_dead = a0 <= 0.0
    k = to_words(state.key)
    u1, u2 = counter_uniforms(k[:, 0], k[:, 1], to_words(state.ctr),
                              to_words(state.ctr_hi))
    t_next, j = direct_method(a, a0, state.t, u1, u2)
    fire = active & ~now_dead & (t_next <= horizon)
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


def system_tensors(system: ReactionSystem, rates=None, device=None, *,
                   require_dense: bool = True):
    """Dense gather-form tensors (idx_i32, coef_i32, delta_f32,
    rates_f32) — the layout both the plain step and the CUDA kernel
    take. By default refuses systems the dense comb unroll would
    mis-evaluate (run those with sparse=True)."""
    if require_dense:
        require_dense_capable(system)
    return (
        torch.as_tensor(system.reactant_idx.astype(np.int32), device=device),
        torch.as_tensor(system.reactant_coef.astype(np.int32),
                        device=device),
        torch.as_tensor(system.delta.astype(np.float32), device=device),
        torch.as_tensor(np.asarray(system.rates if rates is None else rates,
                                   np.float32), device=device),
    )


def sparse_system_tensors(tables: SparseTables, device=None):
    """The sparse tables on `device` as one tuple: (idx_pad (R+1, M),
    coef_pad (R+1, M), dep_idx (R+1, K), delta_idx (R+1, D), delta_val
    (R+1, D), max_c)."""
    def dev(a):
        return torch.as_tensor(a, device=device)

    return (dev(tables.reactant_idx), dev(tables.reactant_coef),
            dev(tables.dep_idx), dev(tables.delta_idx),
            dev(tables.delta_val), int(tables.max_coef))


def pad_rates(rates):
    """Append the PAD reaction's zero rate: (R,) -> (R+1,) or (B, R) ->
    (B, R+1)."""
    rates = rates.to(torch.float32)
    zero = torch.zeros((*rates.shape[:-1], 1), dtype=rates.dtype,
                       device=rates.device)
    return torch.cat([rates, zero], dim=-1)


def initial_propensities(x, idx_pad, coef_pad, rates, max_c: int):
    """The dense evaluation that seeds the carried (B, R) propensity
    vector from the padded reactant tables: rates first, slots in order,
    the comb unroll to the system's max_c. Propensities are a pure
    function of x, so a seed at any window or launch boundary has the
    carried value's bits."""
    return propensities(x, idx_pad[:-1], coef_pad[:-1], rates, max_c)


def bind_sparse_step(sp, rates):
    """Pack each reaction's update recipe into one row of two tables:

      int_tab[j] = [delta_idx (D) | dep(j) (K) | reactant idx of each
                    dep row, flattened (K·M)]
      flt_tab[j] = [delta_val (D) | reactant coef of each dep row (K·M)
                    | rates of each dep row (K), shared rates only]

    both with the all-pad row R at the end. Per-lane (B, R) rates stay
    a separate (B, R+1) operand (`rates2d`). Pure layout: every value
    is one the unpacked tables hold.

    Returns (int_tab, flt_tab, rates2d, max_c, d, k, m).
    """
    idx_pad, coef_pad, dep_idx, delta_idx, delta_val, max_c = sp
    d = delta_idx.shape[1]
    k = dep_idx.shape[1]
    m = idx_pad.shape[1]
    r1 = dep_idx.shape[0]
    ridx = idx_pad[dep_idx].reshape(r1, k * m)
    int_tab = torch.cat([delta_idx, dep_idx, ridx], dim=1)
    coefs = coef_pad[dep_idx].reshape(r1, k * m).to(torch.float32)
    rp = pad_rates(rates)
    if rp.ndim == 1:
        flt_tab = torch.cat([delta_val, coefs, rp[dep_idx]], dim=1)
        rates2d = None
    else:
        flt_tab = torch.cat([delta_val, coefs], dim=1)
        rates2d = rp
    return (int_tab.contiguous(), flt_tab.contiguous(), rates2d, max_c, d,
            k, m)


def resolve_carry(a):
    """(a, a0, cum): the carried propensities with their Resolve sums,
    accumulated left to right over R as the dense step does (a0 is the
    last running sum)."""
    cols = []
    run = torch.zeros_like(a[:, 0])
    for r in range(a.shape[1]):
        run = run + a[:, r]
        cols.append(run)
    return a, run, torch.stack(cols, dim=1)


def sparse_ssa_step(state: LaneState, aci, bound, horizon):
    """One direct-method step with dependency-graph propensity updates:
    the Resolve, clock, counter and `dead` logic of `ssa_step` over the
    carried `aci = (a, a0, cum)` (`resolve_carry`); the Update adds the
    fired reaction's sparse delta list, and only its dep(j) rows of `a`
    are recomputed, rates first in slot order.

    bound: `bind_sparse_step(sp, rates)`. Returns (LaneState, aci).
    """
    a, a0, cum = aci
    int_tab, flt_tab, rates2d, max_c, d, k, m = bound
    r = int_tab.shape[0] - 1
    b, s = state.x.shape
    active = (state.t < horizon) & ~state.dead
    now_dead = a0 <= 0.0
    key = to_words(state.key)
    u1, u2 = counter_uniforms(key[:, 0], key[:, 1], to_words(state.ctr),
                              to_words(state.ctr_hi))
    tau = -log_f32(u1) / torch.clamp_min(a0, _A0_FLOOR)
    t_next = state.t + tau
    fire = active & ~now_dead & (t_next <= horizon)
    # first j with cum >= u2 * a0, 0 if none (argmax returns the first)
    j = (cum >= (u2 * a0)[:, None]).to(torch.uint8).argmax(dim=1)
    # lanes that did not fire take the all-pad row R
    jd = torch.where(fire, j, r)
    it = int_tab[jd].long()  # (B, D + K + K·M)
    ft = flt_tab[jd]  # (B, D + K·M [+ K])
    didx, dep, ridx = it[:, :d], it[:, d:d + k], it[:, d + k:]
    dval = ft[:, :d]
    coefs = ft[:, d:d + k * m].reshape(b, k, m)
    if rates2d is None:
        rate_rows = ft[:, d + k * m:]
    else:
        rate_rows = torch.gather(rates2d, 1, dep)
    # Update: pads (every slot of a lane that did not fire) index the
    # junk column S. Changed species are distinct, so each real entry is
    # one add: the bits of the dense x + delta[j].
    x = torch.cat([state.x, torch.zeros_like(state.x[:, :1])], dim=1)
    x = x.scatter_add(1, didx, dval)[:, :s]
    # Match of the dep(j) rows from the new x; pad slots gather the
    # neutral 1.0 of column S
    xp = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
    pops = torch.gather(xp, 1, ridx).reshape(b, k, m)
    f = comb_factors(pops, coefs, max_c)
    a_new = rate_rows.to(x.dtype)
    for mm in range(m):
        a_new = a_new * f[:, :, mm]
    # pad dep entries (R) land in the junk column R, then cut off
    a = torch.cat([a, torch.zeros_like(a[:, :1])], dim=1)
    a = a.scatter(1, dep, a_new)[:, :r]
    t = torch.where(active, torch.where(fire, t_next, horizon), state.t)
    lo, hi = ctr_add(to_words(state.ctr), to_words(state.ctr_hi),
                     active.to(torch.int64))
    return LaneState(
        x=x, t=t, key=state.key, ctr=from_words(lo), ctr_hi=from_words(hi),
        steps=state.steps + fire.to(torch.int32), leaps=state.leaps,
        dead=state.dead | (active & now_dead),
        no_leap=state.no_leap), resolve_carry(a)


def _settle_dead(sl: LaneState, horizon) -> LaneState:
    """Dead lanes end the window at the horizon, as live ones do."""
    return sl._replace(
        t=torch.where(sl.dead, torch.maximum(sl.t, horizon), sl.t))


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
        return _settle_dead(sl, horizon)

    return advance


def make_sparse_advance_fn(sp, max_steps: Optional[int]):
    """`make_advance_fn` over `sparse_ssa_step` (the sparse branch of the
    reference's): sp is a `sparse_system_tensors` tuple. Each call binds
    the recipe rows to its slice's rates and seeds the carried
    propensities from the slice's populations."""
    def advance(sl: LaneState, rates, horizon):
        bound = bind_sparse_step(sp, rates)
        aci = resolve_carry(initial_propensities(sl.x, sp[0], sp[1], rates,
                                                 sp[5]))
        n = 0
        while (max_steps is None or n < max_steps) and bool(
                live(sl, horizon).any()):
            sl, aci = sparse_ssa_step(sl, aci, bound, horizon)
            n += 1
        return _settle_dead(sl, horizon)

    return advance


def advance_to(state: LaneState, system_tensors, horizon,
               max_steps: Optional[int] = None) -> LaneState:
    """Advance every lane exactly to `horizon` (schema-ii time slice)."""
    idx, coef, delta, rates = system_tensors
    horizon = torch.as_tensor(np.float32(horizon), device=state.t.device)
    return make_advance_fn(ssa_step, (idx, coef, delta), max_steps)(
        state, rates, horizon)
