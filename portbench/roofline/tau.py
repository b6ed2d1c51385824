"""The least work of an adaptive tau-leap iteration (Cao, Gillespie and
Petzold's step size; Poisson counts by inverse transform; the exact
fallback), shared by the dense and the sparse tau kernels."""
from __future__ import annotations

import numpy as np

from portbench.roofline.counts import (
    F_DRAW,
    F_EXP,
    I_BLOCK,
    I_STEP,
    fired_ops,
    match_ops,
    pool_bytes,
    table_bytes,
)


def per_window(net):
    """work(lanes, steps, leaps) -> (bytes, float32 ops, int32 ops) of one
    window in which the lanes made `steps` iterations that advanced
    them, `leaps` of them accepted leaps and the rest fired exact events.
    Each lane evaluates every reaction on entry. Every such iteration
    sums a0 and max a_j (R - 1 operations each) and the gate (6). An
    accepted leap also pays the Match of every reaction (it may change
    every population), the Cao bound of every consumed species (mu and
    sig2 over its column's nonzeros, 5 each; the g_i terms, 4 a nonzero
    coefficient; the bound, r1, r2 and the minima, 11), tau (4), and one
    attempt: each reaction's mean, exp and first CDF compare, the check
    and the update of x (an add and a multiply a nonzero, an add and a
    compare a species) and the clock (2), with ceil(R/2) counter blocks.
    An exact event pays the draw and its update with its dependents'
    Match. A lane's last iteration in a window may be a leap that lands
    on the horizon, so none is charged for crossing it."""
    r, s = net.n_reactions, net.n_species
    nnz_col = (net.delta != 0).sum(axis=0)
    # the reaction of highest order consuming each species, and how many
    # copies of it it takes: c - 1 terms of the g_i sum
    best = np.zeros((2, s), np.int64)
    for j in range(r):
        for i, c in zip(net.idx[j], net.coef[j]):
            if c > 0 and (int(net.coef[j].sum()), c) > tuple(best[:, i]):
                best[:, i] = int(net.coef[j].sum()), c
    cao = sum(5 * int(nnz_col[i]) + 4 * int(best[1, i] - 1) + 11
              for i in np.nonzero(best[0] > 0)[0])
    nnz = int(nnz_col.sum())
    match = match_ops(net)
    leap = cao + 4 + r * (1 + F_EXP + 1) + 2 * (2 * nnz + 2 * s) + 2 + match
    exact = F_DRAW + fired_ops(net, 3)
    i_leap = (r + 1) // 2 * I_BLOCK + 2
    tables = table_bytes(net)

    def work(lanes: int, steps: int, leaps: int):
        n_exact = steps - leaps
        return (pool_bytes(lanes, s) + tables,
                steps * (2 * (r - 1) + 6) + leaps * leap + n_exact * exact
                + lanes * match,
                leaps * i_leap + n_exact * I_STEP)

    return work
