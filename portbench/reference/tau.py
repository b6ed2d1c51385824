"""Adaptive tau-leaping (Gillespie 2001; the step size of Cao, Gillespie
and Petzold 2006) with an exact fallback, over a batch of lanes.

A live lane's iteration: the Cao leap tau_c bounds each consumed
species' expected change mu_i and variance sig2_i (column sums of
a_j * delta_ji, and of a_j * delta_ji^2, left to right over the
reactions that change i) by max(eps * x_i / g_i, 1), g_i from the
highest-order reaction consuming i; the leap is clamped to the horizon
and to LAM_MAX / max_j a_j. When the clamped leap covers at least
`fallback` expected events, each reaction fires K_j ~ Poisson(a_j tau)
times (inverse transform from one uniform each, ceil(R/2) counter blocks
an attempt); a leap that would make a population negative is retried
once at tau/2 with the next blocks. Otherwise, or after two rejections,
the lane takes one exact step (`ssa.direct_method`) from the next block.
"""
from __future__ import annotations

import numpy as np

from portbench.reference.fmath import exp_f32
from portbench.reference.rng import uniforms
from portbench.reference.ssa import direct_method, propensities

F32 = np.float32
FLOOR = F32(1e-30)
LAM_MAX = F32(16.0)
POISSON_KMAX = 64


class TauSystem:
    """The leap's tables of a network: the nonzeros of each species'
    column of delta in ascending reaction order (pads: reaction R, 0),
    the g_i coefficients and which species some reaction consumes."""

    def __init__(self, net):
        r, s = net.n_reactions, net.n_species
        cols = [np.nonzero(net.delta[:, i])[0] for i in range(s)]
        width = max([len(c) for c in cols] + [1])
        self.col_j = np.full((s, width), r, np.int64)
        self.col_v = np.zeros((s, width), F32)
        for i, js in enumerate(cols):
            self.col_j[i, :len(js)] = js
            self.col_v[i, :len(js)] = net.delta[js, i]
        # g_i = o + (o / c) sum_{k < c} k / max(x_i - k, 1) for the
        # reaction of highest order o consuming i, c copies of i (ties
        # on o prefer the larger c); 1 for species nobody consumes
        best = np.zeros((2, s), np.int64)
        for j in range(r):
            order = int(net.coef[j].sum())
            for i, c in zip(net.idx[j], net.coef[j]):
                if c > 0 and (order, c) > (best[0, i], best[1, i]):
                    best[:, i] = order, c
        self.gi = np.zeros((max(4, net.max_coef), s), F32)
        self.gi[0] = 1.0
        for i in range(s):
            o, c = int(best[0, i]), int(best[1, i])
            if o:
                self.gi[0, i] = o
                for k in range(1, c):
                    self.gi[k, i] = o / c * k
        self.consumed = best[0] > 0


def column_sums(w, col_j, col_v):
    """(B, S): sum over each column's nonzeros of w[:, j] * v, left to
    right from zero."""
    wp = np.concatenate([w, np.zeros((w.shape[0], 1), F32)], axis=1)
    out = np.zeros((w.shape[0], col_j.shape[0]), F32)
    for k in range(col_j.shape[1]):
        out = out + wp[:, col_j[:, k]] * col_v[:, k]
    return out


def poisson(u, lam):
    """Inverse-transform Poisson counts (float32) of means lam from
    uniforms u: how many of the first POISSON_KMAX CDF terms lie below
    u, the terms built as pmf = exp(-lam), pmf *= lam / i."""
    pmf = exp_f32(-lam)
    cdf = pmf
    k = (cdf < u).astype(F32)
    for i in range(1, POISSON_KMAX):
        if not ((cdf < u) | (lam < 0)).any():
            break
        pmf = pmf * (lam / F32(i))
        cdf = cdf + pmf
        k = k + (cdf < u).astype(F32)
    return k


def uniform_slab(key, ctr, r: int):
    """(B, r) uniforms: both of each of ceil(r/2) blocks from ctr on."""
    n_pairs = (r + 1) // 2
    c = ctr[:, None] + np.arange(n_pairs, dtype=np.uint64)[None, :]
    u1, u2 = uniforms(key[:, None, :], c)
    return np.stack([u1, u2], axis=2).reshape(ctr.shape[0], -1)[:, :r]


def step(net, ts, lanes, h, eps, fallback, rnd=None):
    """One tau-or-exact iteration of the live lanes of `lanes` (x, t,
    dead, key, ctr, steps, leaps; changed in place) toward horizon h."""
    live = np.nonzero((lanes["t"] < h) & ~lanes["dead"])[0]
    x, t = lanes["x"][live], lanes["t"][live]
    key, ctr = lanes["key"][live], lanes["ctr"][live]
    r = net.n_reactions
    n_pairs = (r + 1) // 2
    a = propensities(net, x, rnd)
    a0 = np.add.accumulate(a, axis=1, dtype=F32)[:, -1]
    dead = a0 <= F32(0.0)

    mu = column_sums(a, ts.col_j, ts.col_v)
    sig2 = column_sums(a, ts.col_j, ts.col_v * ts.col_v)
    g = np.broadcast_to(ts.gi[0], x.shape)
    for k in range(1, ts.gi.shape[0]):
        g = g + ts.gi[k] / np.maximum(x - F32(k), F32(1.0))
    bnd = np.maximum(F32(eps) * x / g, F32(1.0))
    amu = np.abs(mu)
    inf = F32(np.inf)
    r1 = np.where(ts.consumed & (amu > 0), bnd / np.maximum(amu, FLOOR), inf)
    r2 = np.where(ts.consumed & (sig2 > 0),
                  (bnd * bnd) / np.maximum(sig2, FLOOR), inf)
    tau_c = np.minimum(r1, r2).min(axis=1)
    tau_l = np.minimum(np.minimum(tau_c, h - t),
                       LAM_MAX / np.maximum(a.max(axis=1), FLOOR))
    do_leap = ~dead & (tau_l * a0 >= F32(fallback))
    tau_h = F32(0.5) * tau_l

    def attempt(mask, off, tau):
        ok = np.zeros(mask.shape, bool)
        xn = x.copy()
        sel = np.nonzero(mask)[0]
        if sel.size:
            lam = a[sel] * tau[sel, None]
            kc = poisson(uniform_slab(key[sel], ctr[sel] + np.uint64(off),
                                      r), lam)
            xn[sel] = x[sel] + column_sums(kc, ts.col_j, ts.col_v)
            ok[sel] = (xn[sel] >= 0).all(axis=1)
        return ok, xn

    ok1, x1 = attempt(do_leap, 0, tau_l)
    ok2, x2 = attempt(do_leap & ~ok1, n_pairs, tau_h)
    leap1 = do_leap & ok1
    leap2 = do_leap & ~ok1 & ok2
    leaped = leap1 | leap2

    exact = ~leaped
    e_off = np.where(do_leap & ~leaped, np.uint64(2 * n_pairs), np.uint64(0))
    u1, u2 = uniforms(key, ctr + e_off)
    _, t_next, j = direct_method(a, t, u1, u2)
    fire = exact & ~dead & (t_next <= h)
    xe = np.where(fire[:, None], x + net.delta[j], x)

    x_new = np.where(leap1[:, None], x1, np.where(leap2[:, None], x2, xe))
    t_new = np.where(leap1, np.minimum(t + tau_l, h),
                     np.where(leap2, np.minimum(t + tau_h, h),
                              np.where(fire, t_next, h)))
    used = (np.where(do_leap, np.where(ok1, n_pairs, 2 * n_pairs), 0)
            + exact).astype(np.uint64)
    if rnd is not None:
        x_new = rnd(x_new)
    lanes["x"][live], lanes["t"][live] = x_new, t_new
    lanes["dead"][live] = dead
    lanes["ctr"][live] = ctr + used
    lanes["steps"][live] += leaped | fire
    lanes["leaps"][live] += leaped
