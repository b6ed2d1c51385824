"""On-line trajectory reduction (paper §5.2 schema iii); port of
`repro/core/reduction.py`.

Samples at fixed sim-time grid points fold into (count, mean, M2)
Welford accumulators per (grid point, observable) while the raw window
is discarded. `merge` is Chan's parallel merge; `merge_over_axis` merges
the accumulators of a mesh axis's shards in one psum; `blocked_welford`
/ `merge_blocks` pin the merge tree to a fixed number of contiguous
instance blocks so a record depends on the block count only, and
`gather_blocks_over_axis` assembles a sharded pool's block partials
into the same stack.

Observables are integer-valued, so while their sums stay below 2^24 the
window mean is exact and bitwise equal to the reference. M2 sums
squared deviations in torch's order, not XLA's, so var and ci90 agree
with the reference within a few ulp (the bound is pinned in the tests).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Z90 = 1.6448536269514722  # two-sided 90% normal quantile


class Welford(NamedTuple):
    n: torch.Tensor  # (...,) float32 count
    mean: torch.Tensor
    m2: torch.Tensor


def init_welford(shape, device=None) -> Welford:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return Welford(n=z, mean=z.clone(), m2=z.clone())


def update_batch(acc: Welford, x, mask: Optional[torch.Tensor] = None
                 ) -> Welford:
    """Fold a batch of samples x: (B, ...) over axis 0; mask: (B,)
    optional validity."""
    if mask is None:
        mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    m = mask.to(torch.float32)
    while m.ndim < x.ndim:
        m = m[..., None]
    xf = x.to(torch.float32)
    nb = torch.broadcast_to(m, x.shape).sum(dim=0)
    mean_b = torch.where(nb > 0, (xf * m).sum(dim=0) / torch.clamp_min(
        nb, 1.0), 0.0)
    m2_b = (((xf - mean_b) * m) ** 2).sum(dim=0)
    return merge(acc, Welford(n=nb, mean=mean_b, m2=m2_b))


def merge(a: Welford, b: Welford) -> Welford:
    n = a.n + b.n
    safe = torch.clamp_min(n, 1.0)
    d = b.mean - a.mean
    mean = a.mean + d * (b.n / safe)
    m2 = a.m2 + b.m2 + d * d * (a.n * b.n / safe)
    return Welford(n=n, mean=torch.where(n > 0, mean, 0.0), m2=m2)


def merge_over_axis(parts: list, mesh, axis) -> list:
    """Merge per-shard accumulators (a list of `Welford`, one per mesh
    position) across a mesh axis with the psum identities
      N = Σn;  MEAN = Σ(n·mean)/N;  M2 = Σ m2 + Σ n·mean² − N·MEAN²
    (algebraically the pairwise Chan merges, but one psum), each Σ left
    to right along the axis (`collectives.psum`), as `merge_blocks`
    sums its blocks. Returns one merged accumulator per position."""
    from repro_torch.sharding.collectives import psum

    n = psum([a.n for a in parts], mesh, axis)
    s1 = psum([a.n * a.mean for a in parts], mesh, axis)
    s2 = psum([a.m2 + a.n * a.mean * a.mean for a in parts], mesh, axis)
    out, done = [], {}
    for ni, s1i, s2i in zip(n, s1, s2):
        key = (id(ni), id(s1i), id(s2i))
        if key not in done:
            safe = torch.clamp_min(ni, 1.0)
            mean = s1i / safe
            m2 = s2i - ni * mean * mean
            done[key] = Welford(n=ni, mean=torch.where(ni > 0, mean, 0.0),
                                m2=torch.clamp_min(m2, 0.0))
        out.append(done[key])
    return out


def blocked_welford(obs, n_blocks: int) -> Welford:
    """Per-block partials: obs (I, ...) -> leaves (V, ...); block b
    covers the contiguous instance rows [b*I/V, (b+1)*I/V).

    Each block is bitwise `update_batch(init_welford(...), x)`, the
    reference's fold, in six ops instead of about forty: with no mask
    its all-ones factor multiplies by exactly 1, its count is exactly
    the block's rows (below 2^24) and the merge into the empty
    accumulator adds exact zeros. The window path runs this once per
    block and shard, so its launches bound how far ahead the host can
    queue supersteps."""
    rows = obs.shape[0] // n_blocks
    xb = obs.reshape((n_blocks, rows) + obs.shape[1:])
    if rows > 2 ** 24:  # a float32 count of ones would round
        parts = [update_batch(init_welford(x.shape[1:], obs.device), x)
                 for x in xb]
        return Welford(*(torch.stack(leaf) for leaf in zip(*parts)))
    n = torch.full(obs.shape[1:], float(rows), dtype=torch.float32,
                   device=obs.device)
    means, m2s = [], []
    for x in xb:
        # a fresh copy, as the masked product is: the sums then read
        # the same aligned layout whatever the block's offset
        xf = x.to(torch.float32, copy=True)
        mean = xf.sum(dim=0) / n
        means.append(mean)
        m2s.append(((xf - mean) ** 2).sum(dim=0))
    return Welford(n=n.expand((n_blocks,) + n.shape),
                   mean=torch.stack(means), m2=torch.stack(m2s))


def _sum_blocks(a):
    """Sum over the leading (block) axis left to right, XLA:CPU's order
    for the reference's merge. `torch.sum` pairs the terms otherwise
    from V = 5 on, and M2's cancellation against N·MEAN² (means ~10^3,
    variances ~10) turns that one rounding into a var thousands of ulp
    off the reference's."""
    out = a[0]
    for v in range(1, a.shape[0]):
        out = out + a[v]
    return out


def merge_blocks(acc: Welford) -> Welford:
    """Canonical merge of a (V, ...) stack of block accumulators in the
    psum form: N = Σn, MEAN = Σ(n·mean)/N, M2 = Σ(m2 + n·mean²) − N·MEAN²,
    each Σ left to right over the blocks. V == 1 returns the single
    block unchanged."""
    if acc.n.shape[0] == 1:
        return Welford(*(a[0] for a in acc))
    n = _sum_blocks(acc.n)
    s1 = _sum_blocks(acc.n * acc.mean)
    s2 = _sum_blocks(acc.m2 + acc.n * acc.mean * acc.mean)
    safe = torch.clamp_min(n, 1.0)
    mean = s1 / safe
    m2 = s2 - n * mean * mean
    return Welford(n=n, mean=torch.where(n > 0, mean, 0.0),
                   m2=torch.clamp_min(m2, 0.0))


def gather_blocks_over_axis(parts: list, device) -> Welford:
    """Assemble the full (V, ...) block stack of a sharded pool on
    `device` (the lead shard's): shard k's (V/K, ...) partials, in shard
    order, go into their rows of a zeroed (3, V, ...) buffer, so every
    position holds one value and exact zeros, as under the reference's
    psum, and the stack is bitwise the one an unsharded run computes.
    Only O(V x n_obs) floats leave each shard. One part (no sharding)
    is returned as it is."""
    if len(parts) == 1:
        return parts[0]
    v_loc = parts[0].n.shape[0]
    buf = torch.zeros((3, v_loc * len(parts)) + tuple(parts[0].n.shape[1:]),
                      dtype=torch.float32, device=device)
    for k, acc in enumerate(parts):
        buf[:, k * v_loc:(k + 1) * v_loc] = torch.stack(
            [acc.n, acc.mean, acc.m2]).to(device)
    return Welford(n=buf[0], mean=buf[1], m2=buf[2])


class Stats(NamedTuple):
    n: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    ci90: torch.Tensor  # half-width of the 90% confidence interval


def finalize(acc: Welford) -> Stats:
    var = acc.m2 / torch.clamp_min(acc.n - 1.0, 1.0)
    sem = torch.sqrt(var / torch.clamp_min(acc.n, 1.0))
    return Stats(n=acc.n, mean=acc.mean, var=var, ci90=Z90 * sem)


def _group_welford(obs, group_ids, n_groups: int) -> Welford:
    """Per-group masked folds: leaves (n_groups, ...)."""
    parts = [update_batch(init_welford(obs.shape[1:], obs.device), obs,
                          mask=group_ids == g) for g in range(n_groups)]
    return Welford(*(torch.stack(leaf) for leaf in zip(*parts)))


def blocked_grouped_welford(obs, group_ids, n_groups: int,
                            n_blocks: int) -> Welford:
    """Per-(block, group) masked partials: leaves (V, n_groups, ...)."""
    bs = obs.shape[0] // n_blocks
    parts = [_group_welford(obs[v * bs:(v + 1) * bs],
                            group_ids[v * bs:(v + 1) * bs], n_groups)
             for v in range(n_blocks)]
    return Welford(*(torch.stack(leaf) for leaf in zip(*parts)))
