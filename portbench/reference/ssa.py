"""Gillespie's direct method over a batch of lanes, in float32.

One step of a live lane: the propensities of every reaction (the rate
times one combination factor C(n, c) per reactant slot, in slot order),
a0 and the running sums left to right, the waiting time
-log(u1) / max(a0, 1e-30) and the first reaction whose running sum
reaches u2 * a0, from the two uniforms of the lane's counter block. The
reaction fires when the new time is within the horizon; otherwise the
lane freezes at the horizon. A lane whose propensities are all zero is
dead. Each step of a live lane uses one counter block.
"""
from __future__ import annotations

import numpy as np

from portbench.reference.fmath import log_f32
from portbench.reference.rng import uniforms

F32 = np.float32
A0_FLOOR = F32(1e-30)


def comb_factor(pops, coef, max_c: int):
    """C(pops, coef) for coef <= max_c as a running product over i of
    max(pops - i, 0), divided by coef!; slots with coef 0 give 1."""
    ff = np.ones_like(pops)
    fact = np.ones_like(pops)
    for i in range(max_c):
        on = coef > i
        ff = np.where(on, ff * np.maximum(pops - F32(i), F32(0.0)), ff)
        fact = np.where(on, fact * F32(i + 1), fact)
    return ff / fact


def propensities(net, x, rnd=None):
    """(B, R) float32 propensities of populations x (B, S)."""
    b = x.shape[0]
    xp = np.concatenate([x, np.ones((b, 1), F32)], axis=1)
    a = np.broadcast_to(net.rates, (b, net.n_reactions))
    for m in range(net.idx.shape[1]):
        if not (net.coef[:, m] > 0).any():
            continue  # an all-pad slot multiplies by exactly 1
        a = a * comb_factor(xp[:, net.idx[:, m]], net.coef[:, m],
                            net.max_coef)
    return a if rnd is None else rnd(a)


def direct_method(a, t, u1, u2):
    """(a0, t_next, j): the total propensity, the next event time and the
    first reaction whose left-to-right running sum reaches u2 * a0."""
    cum = np.add.accumulate(a, axis=1, dtype=F32)
    a0 = cum[:, -1]
    t_next = t + (-log_f32(u1)) / np.maximum(a0, A0_FLOOR)
    j = np.argmax(cum >= (u2 * a0)[:, None], axis=1)
    return a0, t_next, j


def step(net, lanes, h, rnd=None):
    """One step of the live lanes of `lanes` (a dict of x, t, dead, key,
    ctr arrays, changed in place) toward horizon h."""
    live = np.nonzero((lanes["t"] < h) & ~lanes["dead"])[0]
    x, t = lanes["x"][live], lanes["t"][live]
    ctr = lanes["ctr"][live]
    a = propensities(net, x, rnd)
    u1, u2 = uniforms(lanes["key"][live], ctr)
    a0, t_next, j = direct_method(a, t, u1, u2)
    dead = a0 <= F32(0.0)
    fire = ~dead & (t_next <= h)
    x = np.where(fire[:, None], x + net.delta[j], x)
    t = np.where(fire, t_next, h)
    if rnd is not None:
        x = rnd(x)
    lanes["x"][live], lanes["t"][live] = x, t
    lanes["dead"][live] = dead
    lanes["ctr"][live] = ctr + np.uint64(1)
    lanes["steps"][live] += fire
