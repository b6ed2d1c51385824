"""Adaptive tau-leaping, the second simulation algorithm; port of
`repro/core/tau_leap.py`.

Exact SSA pays one Resolve/Update per reaction event, so stiff or
large-population models burn tens of thousands of steps per window.
Tau-leaping (Gillespie 2001, with the step-size selection of Cao,
Gillespie and Petzold 2006) picks a leap `tau` over which no propensity
should change by more than a fraction `eps`, fires each reaction
K_j ~ Poisson(a_j tau) times at once, and falls back to one exact SSA
step wherever a leap would cover fewer than `fallback` expected events.

Per lane, one step (`tau_step_core`, all lanes masked in lock-step):

  1. propensities a_j (rates first, as the exact step) and the Cao tau
     from mu_i = sum_j a_j delta_ji, sig2_i = sum_j a_j delta_ji^2 and
     the g_i bound (`gi_tables`), clamped to the horizon and to
     LAM_MAX / max_j a_j;
  2. leap if tau * a0 >= fallback: K_j by inverse transform from one
     uniform each (`poisson_from_uniform`); if a population would go
     negative, retry once at tau/2 with fresh draws;
  3. otherwise, or after two rejections, one exact SSA step (the same
     Resolve as `gillespie.ssa_step`, `gillespie.direct_method`).

Draws come from the lane's counter stream: a leap attempt reads
ceil(R/2) counter blocks at ctr (retry: ctr + ceil(R/2)), the exact
sub-step one block at ctr (after two rejections at ctr + 2 ceil(R/2)),
and the counter then advances by what was consumed — so a trajectory is
a pure function of (lane key, counter), whatever the chunking.

Bits. a0 and the inverse-CDF scan run left to right over R, and mu,
sig2 and the leap's population change dx run left to right over the
nonzero entries of each species' column of delta (`delta_columns`): a
skipped zero adds a_j * 0 = +0, which changes at most the sign of a zero
sum, and the step reads that sign only through |mu| > 0 and sig2 > 0.
dx is a sum of integers below 2^24, exact in any order. XLA:CPU's
`lax.dot` sums left to right for some shapes only (lv8, transport; not
ecoli or ring8), so the port is bitwise against the reference there and
statistically elsewhere. `exp` is the port's `exp_f32`: `torch.exp`
differs from `jnp.exp` on about 10% of the sampler's inputs. Divisions
by scalars are written as tensor divisions: on CUDA, torch divides by a
Python scalar through its reciprocal, which is not IEEE division.

`steps` counts iterations that advanced a lane (accepted leaps plus
fired exact steps); `leaps` counts accepted leaps only.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.gillespie import (
    LaneState,
    direct_method,
    make_advance_fn,
    propensity_sum,
)
from repro_torch.core.mathf import exp_f32
from repro_torch.core.reactions import (
    MAX_COEF,
    ReactionSystem,
    propensities,
    require_dense_capable,
    sparse_tables,
)
from repro_torch.core.stream import (
    counter_uniforms,
    ctr_add,
    from_words,
    to_words,
)

#: default fraction by which a leap may change any propensity (Cao'06)
DEFAULT_EPS = 0.03
#: leap only when tau covers at least this many expected SSA events
DEFAULT_FALLBACK = 10.0
#: cap on any single Poisson mean a_j*tau, so the inverse-transform
#: unroll never truncates: P(X > POISSON_KMAX | lam <= LAM_MAX) < 1e-18
LAM_MAX = 16.0
POISSON_KMAX = 64

_F32 = np.float32
_FLOOR = float(_F32(1e-30))


# ------------------------------------------------------------ host prep
def gi_tables(system: ReactionSystem) -> np.ndarray:
    """(max(MAX_COEF, max_coef), S) float32 coefficient table for the
    Cao g_i bound: g_i(x) = T[0,i] + sum_{k>=1} T[k,i] / max(x_i - k, 1)
    from the highest-order reaction (HOR) consuming species i. For an
    order-o HOR taking c copies of i, g = o + (o/c) sum_{k=1}^{c-1}
    k / (x - k). Ties on o prefer the larger c. Species never consumed
    get g = 1 (`reactant_mask` drops them from the tau minimum)."""
    s = system.n_species
    tab = np.zeros((max(MAX_COEF, system.max_coef), s), np.float32)
    tab[0] = 1.0
    best = np.zeros((2, s), np.int64)  # (o, c) of the HOR per species
    for j in range(system.n_reactions):
        order = int(system.reactant_coef[j].sum())
        for i, c in zip(system.reactant_idx[j], system.reactant_coef[j]):
            if c <= 0 or i >= s:
                continue
            if (order, c) > (best[0, i], best[1, i]):
                best[0, i], best[1, i] = order, c
    for i in range(s):
        o, c = int(best[0, i]), int(best[1, i])
        if o == 0:
            continue
        tab[0, i] = float(o)
        for k in range(1, c):
            tab[k, i] = o / c * k
    return tab


def reactant_mask(system: ReactionSystem) -> np.ndarray:
    """(S,) float32: 1 where some reaction consumes the species — only
    those populations bound the Cao tau."""
    s = system.n_species
    mask = np.zeros((s,), np.float32)
    for j in range(system.n_reactions):
        for i, c in zip(system.reactant_idx[j], system.reactant_coef[j]):
            if c > 0 and i < s:
                mask[i] = 1.0
    return mask


def delta_columns(delta) -> tuple[np.ndarray, np.ndarray]:
    """The nonzero entries of each species' column of delta (R, S), in
    ascending reaction order: (col_j (S, L) int32, col_v (S, L)
    float32), L the most nonzeros of any column (at least 1). Pads sit
    at the end of a row: reaction R with value 0."""
    delta = np.asarray(delta)
    r, s = delta.shape
    cols = [np.nonzero(delta[:, i])[0] for i in range(s)]
    width = max([len(c) for c in cols] + [1])
    col_j = np.full((s, width), r, np.int32)
    col_v = np.zeros((s, width), np.float32)
    for i, js in enumerate(cols):
        col_j[i, :len(js)] = js
        col_v[i, :len(js)] = delta[js, i]
    return col_j, col_v


class TauTables(NamedTuple):
    """The tau step's system operands (`tau_tables`), shared by the plain
    step and both CUDA kernels.

    idx / coef: (R, 4) int32 reactant tables (Match by gather);
    col_j / col_v: `delta_columns` (mu, sig2 and the leap's dx);
    row_idx / row_val: (R+1, D) the species each reaction changes and by
        how much, row R all pads (index S) — the exact sub-step's update
        (`reactions.sparse_tables`' delta_idx / delta_val);
    gi / rmask: `gi_tables` / `reactant_mask`;
    max_c: the comb-factor unroll (MAX_COEF dense, the system's own
        max coefficient sparse)."""

    idx: torch.Tensor
    coef: torch.Tensor
    col_j: torch.Tensor
    col_v: torch.Tensor
    row_idx: torch.Tensor
    row_val: torch.Tensor
    gi: torch.Tensor
    rmask: torch.Tensor
    max_c: int


def tau_tables(system: ReactionSystem, *, sparse: bool = False,
               device=None) -> TauTables:
    """Build `TauTables` on `device`. The dense form (sparse=False)
    refuses reactant coefficients above MAX_COEF, as the dense exact
    step does; the sparse form unrolls to the system's own."""
    if not sparse:
        require_dense_capable(system)
    st = sparse_tables(system)
    col_j, col_v = delta_columns(system.delta)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return TauTables(
        idx=dev(system.reactant_idx.astype(np.int32)),
        coef=dev(system.reactant_coef.astype(np.int32)),
        col_j=dev(col_j), col_v=dev(col_v),
        row_idx=dev(st.delta_idx), row_val=dev(st.delta_val),
        gi=dev(gi_tables(system)), rmask=dev(reactant_mask(system)),
        max_c=max(system.max_coef, 1) if sparse else MAX_COEF)


# ------------------------------------------------------- step primitives
def poisson_from_uniform(u, lam, kmax: int = POISSON_KMAX):
    """Inverse-transform Poisson: the number of the first kmax CDF terms
    below u, as float32 — the smallest k with CDF(k) >= u when lam <=
    LAM_MAX. Terms: pmf = exp(-lam), then pmf *= lam / i (a float32
    division, then a multiply) and cdf += pmf.

    The loop stops once every entry is settled: for lam >= 0 the cdf
    never falls, so an entry with cdf >= u keeps its count. That gives
    the bits of all kmax terms for any input (entries with lam < 0 are
    never settled)."""
    pmf = exp_f32(-lam)
    cdf = pmf
    k = (cdf < u).to(torch.float32)
    for i in range(1, kmax):
        if not bool(((cdf < u) | (lam < 0.0)).any()):
            break
        pmf = pmf * (lam / torch.full_like(lam, float(i)))
        cdf = cdf + pmf
        k = k + (cdf < u).to(torch.float32)
    return k


def column_sums(w, col_j, col_v):
    """(B, S): sum_j w[:, j] * delta_ji over the nonzeros of each
    column, left to right in ascending j from zero (pads read a zero
    column)."""
    wp = torch.cat([w, torch.zeros_like(w[:, :1])], dim=1)
    out = torch.zeros((w.shape[0], col_j.shape[0]), dtype=w.dtype,
                      device=w.device)
    for l in range(col_j.shape[1]):
        out = out + wp[:, col_j[:, l].long()] * col_v[:, l]
    return out


def _uniform_slab(k0, k1, ctr, ctr_hi, off, r: int):
    """(B, R) uniforms: the two of each of the ceil(R/2) counter blocks
    at ctr + off + p, in order."""
    n_pairs = (r + 1) // 2
    p = torch.arange(n_pairs, dtype=torch.int64, device=ctr.device)
    lo, hi = ctr_add(ctr[:, None], ctr_hi[:, None], p[None, :] + off)
    u1, u2 = counter_uniforms(k0[:, None], k1[:, None], lo, hi)
    return torch.stack([u1, u2], dim=2).reshape(ctr.shape[0], -1)[:, :r]


def tau_step_core(x, t, dead, k0, k1, ctr, ctr_hi, steps, leaps,
                  tables: TauTables, rates, horizon, *, eps: float,
                  fallback, lam_max: float = LAM_MAX,
                  kmax: int = POISSON_KMAX):
    """One tau-leap-or-fallback step over the lane axis.

    x (B, S) float32; t (B,) float32; dead (B,) bool; k0 / k1 / ctr /
    ctr_hi (B,) int64 words; steps / leaps (B,) int32; rates (R,) or
    (B, R) float32; horizon a float32 0-dim tensor on x's device;
    fallback a float or a (B,) float32 tensor (+inf pins a lane to
    exact steps). Returns (x, t, dead, ctr, ctr_hi, steps, leaps).

    A finished lane's step is an exact no-op. Poisson draws are
    evaluated only where they are read: attempt 1 for leaping lanes,
    attempt 2 for lanes whose attempt 1 was rejected (the other lanes'
    draws would be discarded)."""
    b, s = x.shape
    r = tables.idx.shape[0]
    n_pairs = (r + 1) // 2
    active = (t < horizon) & ~dead
    a = propensities(x, tables.idx, tables.coef, rates, tables.max_c)
    a0 = propensity_sum(a)
    now_dead = a0 <= 0.0
    alive = active & ~now_dead

    # --- Cao tau candidate: bound the relative propensity drift ---
    mu = column_sums(a, tables.col_j, tables.col_v)
    sig2 = column_sums(a, tables.col_j, tables.col_v * tables.col_v)
    g = torch.broadcast_to(tables.gi[0], x.shape)
    for k in range(1, tables.gi.shape[0]):
        g = g + tables.gi[k] / torch.clamp_min(x - float(k), 1.0)
    bnd = torch.clamp_min(float(_F32(eps)) * x / g, 1.0)
    consuming = tables.rmask > 0.0
    inf = torch.full_like(x, float("inf"))
    amu = mu.abs()
    r1 = torch.where(consuming & (amu > 0.0),
                     bnd / torch.clamp_min(amu, _FLOOR), inf)
    r2 = torch.where(consuming & (sig2 > 0.0),
                     (bnd * bnd) / torch.clamp_min(sig2, _FLOOR), inf)
    tau_c = torch.minimum(r1, r2).amin(dim=1)
    # clamp the leap to the horizon and the Poisson unroll's bound; the
    # method choice reads the clamped tau (finite for live lanes)
    a_max = a.amax(dim=1)
    tau_l = torch.minimum(
        torch.minimum(tau_c, horizon - t),
        torch.full_like(a_max, lam_max) / torch.clamp_min(a_max, _FLOOR))
    do_leap = alive & (tau_l * a0 >= fallback)
    tau_h = 0.5 * tau_l

    def attempt(mask, off, tau):
        """(accepted, x + dx) of a leap with draws at ctr + off, for the
        lanes in `mask` (other lanes draw lam = 0: K = 0, unread)."""
        if not bool(mask.any()):
            return torch.zeros_like(mask), x
        lam = torch.where(mask[:, None], a * tau[:, None], 0.0)
        kc = poisson_from_uniform(
            _uniform_slab(k0, k1, ctr, ctr_hi, off, r), lam, kmax)
        x_new = x + column_sums(kc, tables.col_j, tables.col_v)
        return (x_new >= 0.0).all(dim=1), x_new

    ok1, x1 = attempt(do_leap, 0, tau_l)
    ok2, x2 = attempt(do_leap & ~ok1, n_pairs, tau_h)
    leap1 = do_leap & ok1
    leap2 = do_leap & ~ok1 & ok2
    leaped = leap1 | leap2

    # --- exact SSA sub-step: non-leaping lanes, double rejects, and (for
    # stream parity with ssa_step) lanes that just went dead ---
    exact_lane = active & ~leaped
    e_off = torch.where(do_leap & ~leaped, 2 * n_pairs, 0)
    lo_e, hi_e = ctr_add(ctr, ctr_hi, e_off)
    u1, u2 = counter_uniforms(k0, k1, lo_e, hi_e)
    t_next, j = direct_method(a, a0, t, u1, u2)
    fire = exact_lane & ~now_dead & (t_next <= horizon)
    # the fired row; other lanes take the all-pad row R, whose entries
    # land in a junk column that is cut off
    jd = torch.where(fire, j, r)
    xe = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1).scatter_add(
        1, tables.row_idx[jd].long(), tables.row_val[jd])[:, :s]

    # --- apply ---
    x_new = torch.where(leap1[:, None], x1,
                        torch.where(leap2[:, None], x2, xe))
    t_new = torch.where(
        leap1, torch.minimum(t + tau_l, horizon),
        torch.where(leap2, torch.minimum(t + tau_h, horizon),
                    torch.where(fire, t_next,
                                torch.where(exact_lane, horizon, t))))
    dead_new = dead | (active & now_dead)
    # stream accounting: accepted attempt 1 = n_pairs blocks, retried
    # leap = 2 n_pairs, exact sub-step +1, finished lane 0
    consumed = (torch.where(do_leap, torch.where(ok1, n_pairs, 2 * n_pairs),
                            0) + exact_lane.to(torch.int64))
    lo_n, hi_n = ctr_add(ctr, ctr_hi, consumed)
    steps_new = steps + (leaped | fire).to(torch.int32)
    leaps_new = leaps + leaped.to(torch.int32)
    return x_new, t_new, dead_new, lo_n, hi_n, steps_new, leaps_new


def lane_fallback(no_leap, fallback: float):
    """(B,) float32 leap thresholds: +inf where `no_leap` pins a lane to
    exact steps (steering's exact<->tau switch), `fallback` elsewhere."""
    return torch.where(no_leap, torch.full(no_leap.shape, float("inf"),
                                           device=no_leap.device),
                       float(_F32(fallback)))


# --------------------------------------------------------- host wrapper
def make_tau_step(tables: TauTables, eps: float, fallback: float):
    """`ssa_step`-shaped per-lane step for the dispatch seam:
    step(state: LaneState, system_tensors, horizon) -> LaneState. Of
    system_tensors (idx, coef, delta, rates) only the rates are read;
    the system's tables are `tables`, bound here. A lane with `no_leap`
    set takes exact steps only."""
    def tau_step(state: LaneState, system_tensors, horizon) -> LaneState:
        k = to_words(state.key)
        h = torch.as_tensor(horizon, dtype=torch.float32,
                            device=state.x.device)
        x, t, dead, lo, hi, steps, leaps = tau_step_core(
            state.x, state.t, state.dead, k[:, 0], k[:, 1],
            to_words(state.ctr), to_words(state.ctr_hi), state.steps,
            state.leaps, tables, system_tensors[3], h, eps=eps,
            fallback=lane_fallback(state.no_leap, fallback))
        return LaneState(x=x, t=t, key=state.key, ctr=from_words(lo),
                         ctr_hi=from_words(hi), steps=steps, leaps=leaps,
                         dead=dead, no_leap=state.no_leap)

    return tau_step


def advance_to(state: LaneState, system: ReactionSystem, horizon,
               eps: float = DEFAULT_EPS, fallback: float = DEFAULT_FALLBACK,
               sparse: bool = False) -> LaneState:
    """Standalone tau-leap window advance of every lane to `horizon` with
    the system's rates (tests and notebooks; the engine goes through the
    dispatch seam). `sparse` selects the tables' sparse form."""
    dev = state.x.device
    tables = tau_tables(system, sparse=sparse, device=dev)
    rates = torch.as_tensor(np.asarray(system.rates, np.float32), device=dev)
    h = torch.as_tensor(np.float32(horizon), device=dev)
    return make_advance_fn(make_tau_step(tables, eps, fallback),
                           (tables.idx, tables.coef, None), None)(
        state, rates, h)
