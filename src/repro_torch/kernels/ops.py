"""The fused windows: one kernel call per sim-time window.

Port of `repro/kernels/ops.py`'s exact paths (`window_chunk_loop`,
`sparse_window_chunk_loop`, `_chunk_while`, `FusedWindowOut`,
`FusedWindowTruncated`) and its Match entry point (`propensity`,
`system_kernel_tensors`), and of its tau-leap paths
(`tau_window_chunk_loop`, `sparse_tau_window_chunk_loop`). The reference
runs back-to-back launches of `chunk_steps` iterations in a device-side
while loop until no lane is live or `max_chunks` launches have run. Here
the kernel itself loops each lane until it is no longer live or has
spent the whole budget `chunk_steps * max_chunks`, so a window is ONE
launch. A finished lane's iterations are exact no-ops in the reference,
so every lane ends with the bits the chunked loop gives, and the
reference's chunk count is min(max_chunks, ceil(max_lane(active
iterations) / chunk_steps)). An exact step consumes one counter block,
so the exact kernels' active steps are read off the draw counters; a
tau iteration consumes a varying number, so the tau kernels return
their count. The sparse exact kernel seeds its carried propensities
once per launch; they are a pure function of x, so that gives the
chunked loop's bits too.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.gillespie import LaneState, bind_sparse_step, pad_rates
from repro_torch.core.reactions import ReactionSystem, require_dense_capable
from repro_torch.core.stream import MASK32, to_words
from repro_torch.core.tau_leap import TauTables
from repro_torch.kernels.propensity import propensity_call
from repro_torch.kernels.ssa_step import (
    sparse_recipe,
    sparse_tau_window_call,
    sparse_window_call,
    ssa_window_call,
    tau_window_call,
)

DEFAULT_CHUNK_STEPS = 256
DEFAULT_MAX_CHUNKS = 64


class FusedWindowTruncated(RuntimeError):
    """A fused window hit its event budget with live lanes still below
    the horizon — the result would silently be a partial window. Raise
    `kernel_max_chunks` / `kernel_chunk_steps` or shrink the window."""


class FusedWindowOut(NamedTuple):
    """fused-window result + single-launch telemetry.

    n_chunks: int64 0-dim tensor (device) — the reference's chunk-loop
    iteration count for this window.
    truncated: bool 0-dim tensor (device) — True iff the budget ran out
    with live lanes still below the horizon (the engine raises
    FusedWindowTruncated).
    """

    state: LaneState
    n_chunks: torch.Tensor
    truncated: torch.Tensor


def window_chunk_loop(pool: LaneState, tensors, horizon,
                      chunk_steps: int = DEFAULT_CHUNK_STEPS,
                      max_chunks: int = DEFAULT_MAX_CHUNKS, *,
                      net=None) -> FusedWindowOut:
    """Advance every lane of `pool` to `horizon` through one
    `ssa_window_call` with the whole window's event budget.

    tensors: (idx, coef, delta, rates) as `gillespie.system_tensors`
    gives them. horizon: a float (rounded to float32). net: the kernel
    `ssa_step.bind_network(idx, coef, delta)`, bound once per run by the
    caller (bound per launch when None).
    """
    idx, coef, delta, rates = tensors
    h = np.float32(horizon)
    outs = ssa_window_call(
        pool.x, pool.t, pool.dead.to(torch.int32), pool.key, pool.ctr,
        pool.ctr_hi, idx, coef, delta, rates, h,
        n_steps=chunk_steps * max_chunks, net=net)
    return _exact_window_out(pool, outs, h, chunk_steps, max_chunks)


class SparseWindowTables(NamedTuple):
    """The sparse kernel's table operands for one set of rates
    (`bind_sparse_window`): idx_pad / coef_pad (R+1, M) seed the carry,
    int_tab / flt_tab are `gillespie.bind_sparse_step`'s recipe rows,
    rates_pad is (R+1,) shared or (B, R+1) per lane; the kernel's own:
    dep_lo (R+1,) int32, the lowest row of each dep(j) (R where dep(j) is
    empty, and for the pad row: the a0 fold resumes at the checkpoint
    below it), and `ssa_step.sparse_recipe`'s packed (slot_tab, recipe),
    None off the card."""

    idx_pad: torch.Tensor
    coef_pad: torch.Tensor
    int_tab: torch.Tensor
    flt_tab: torch.Tensor
    rates_pad: torch.Tensor
    max_c: int
    d: int
    k: int
    packed_rates: bool  # shared rates: the dep rows' rates sit in flt_tab
    dep_lo: torch.Tensor
    packed: tuple | None


def bind_sparse_window(sp, rates) -> SparseWindowTables:
    """Pack `gillespie.sparse_system_tensors` tables `sp` with rates (R,)
    or (B, R) into the sparse kernel's operands. Rates change only
    between runs, so a caller binds once and reuses the result for
    every window."""
    int_tab, flt_tab, rates2d, max_c, d, k, _ = bind_sparse_step(sp, rates)
    rates_pad = pad_rates(rates) if rates2d is None else rates2d
    # only the kernel reads the packed tables: the card's tensors get them
    packed = (sparse_recipe(sp[0], sp[1], int_tab, flt_tab, d=d, k=k,
                            packed_rates=rates2d is None)
              if int_tab.is_cuda else None)
    return SparseWindowTables(
        sp[0], sp[1], int_tab, flt_tab, rates_pad, max_c, d, k,
        rates2d is None, sp[2].amin(dim=1).to(torch.int32).contiguous(),
        packed)


def sparse_window_chunk_loop(pool: LaneState, tables: SparseWindowTables,
                             horizon, chunk_steps: int = DEFAULT_CHUNK_STEPS,
                             max_chunks: int = DEFAULT_MAX_CHUNKS
                             ) -> FusedWindowOut:
    """`window_chunk_loop` through the sparse exact kernel
    (`sparse_window_call`): one launch per window with the whole budget.
    tables: `bind_sparse_window(sp, rates)`."""
    h = np.float32(horizon)
    outs = sparse_window_call(
        pool.x, pool.t, pool.dead.to(torch.int32), pool.key, pool.ctr,
        pool.ctr_hi, *tables[:5], h, n_steps=chunk_steps * max_chunks,
        max_c=tables.max_c, d=tables.d, k=tables.k,
        packed_rates=tables.packed_rates, dep_lo=tables.dep_lo,
        packed=tables.packed)
    return _exact_window_out(pool, outs, h, chunk_steps, max_chunks)


def tau_window_chunk_loop(pool: LaneState, tables: TauTables, horizon, *,
                          rates, eps: float, fallback: float,
                          chunk_steps: int = DEFAULT_CHUNK_STEPS,
                          max_chunks: int = DEFAULT_MAX_CHUNKS,
                          dep_mask=None) -> FusedWindowOut:
    """`window_chunk_loop` through the dense tau-leap kernel
    (`tau_window_call`): one launch per window with the whole budget of
    chunk_steps * max_chunks iterations per lane. tables: a dense
    `core.tau_leap.tau_tables`; rates (R,) or (B, R); a lane whose
    `no_leap` is set takes exact steps only. dep_mask: the kernel's
    `ssa_step.dense_dep_mask` of the system, bound once per run by the
    caller (derived per launch when None)."""
    return _tau_window(partial(tau_window_call, dep_mask=dep_mask), pool,
                       tables, horizon, rates, eps, fallback, chunk_steps,
                       max_chunks)


def sparse_tau_window_chunk_loop(pool: LaneState, tables: TauTables,
                                 horizon, *, rates, eps: float,
                                 fallback: float,
                                 chunk_steps: int = DEFAULT_CHUNK_STEPS,
                                 max_chunks: int = DEFAULT_MAX_CHUNKS
                                 ) -> FusedWindowOut:
    """`tau_window_chunk_loop` through the sparse tau-leap kernel
    (`sparse_tau_window_call`: a warp per lane, the comb unroll to the
    tables' max_c). Bitwise identical to the dense loop on a system both
    take."""
    return _tau_window(partial(sparse_tau_window_call, max_c=tables.max_c),
                       pool, tables, horizon, rates, eps, fallback,
                       chunk_steps, max_chunks)


def _tau_window(call, pool, tables, horizon, rates, eps, fallback,
                chunk_steps, max_chunks) -> FusedWindowOut:
    h = np.float32(horizon)
    x, t, dead, steps_d, leaps_d, ctr, ctr_hi, iters = call(
        pool.x, pool.t, pool.dead.to(torch.int32),
        pool.no_leap.to(torch.int32), pool.key, pool.ctr, pool.ctr_hi,
        *tables[:6], rates, tables.gi, tables.rmask, h,
        n_steps=chunk_steps * max_chunks, eps=eps, fallback=fallback)
    return _window_out(pool, x, t, dead, steps_d, leaps_d, ctr, ctr_hi,
                       iters, h, chunk_steps, max_chunks)


def _exact_window_out(pool: LaneState, outs, h, chunk_steps: int,
                      max_chunks: int) -> FusedWindowOut:
    """`_window_out` for an exact kernel's (x, t, dead, steps, ctr,
    ctr_hi): one counter block per active step, no leaps."""
    x, t, dead, steps_d, ctr, ctr_hi = outs
    used = (to_words(ctr) - to_words(pool.ctr)) & MASK32
    return _window_out(pool, x, t, dead, steps_d, None, ctr, ctr_hi, used,
                       h, chunk_steps, max_chunks)


def _window_out(pool: LaneState, x, t, dead, steps_d, leaps_d, ctr, ctr_hi,
                used, h, chunk_steps: int, max_chunks: int
                ) -> FusedWindowOut:
    """The new pool from a window kernel's outputs, with the reference's
    chunk count (from `used`, each lane's active iterations) and
    truncation flag. leaps_d None: the pool's leaps stay."""
    n_chunks = torch.clamp_max(
        (used.max() + chunk_steps - 1) // chunk_steps, max_chunks)
    truncated = ((t < float(h)) & (dead == 0)).any()
    t = torch.where(dead > 0, torch.clamp_min(t, float(h)), t)
    state = LaneState(x=x, t=t, key=pool.key, ctr=ctr, ctr_hi=ctr_hi,
                      steps=pool.steps + steps_d,
                      leaps=pool.leaps if leaps_d is None
                      else pool.leaps + leaps_d,
                      dead=dead > 0, no_leap=pool.no_leap)
    return FusedWindowOut(state=state, n_chunks=n_chunks,
                          truncated=truncated)


def system_kernel_tensors(system: ReactionSystem, device=None):
    """(idx_i32, coef_i32, delta_f32) tensors for the Match kernel — the
    gather form of the reference's (E, coef, delta). Refuses systems
    whose coefficients exceed the kernel's MAX_COEF unroll."""
    require_dense_capable(system)
    return (torch.as_tensor(system.reactant_idx.astype(np.int32),
                            device=device),
            torch.as_tensor(system.reactant_coef.astype(np.int32),
                            device=device),
            torch.as_tensor(system.delta.astype(np.float32), device=device))


def propensity(x, system_tensors_k, rates):
    """(B, R) propensities of populations x through the Match kernel
    (`propensity_call`, rates last). system_tensors_k:
    `system_kernel_tensors(system)`; rates (R,) or (B, R)."""
    idx, coef, _ = system_tensors_k
    return propensity_call(x, idx, coef, rates)
