"""On-line trajectory reduction (paper §5.2 schema iii); port of
`repro/core/reduction.py`.

Samples at fixed sim-time grid points fold into (count, mean, M2)
Welford accumulators per (grid point, observable) while the raw window
is discarded. `merge` is Chan's parallel merge; `blocked_welford` /
`merge_blocks` pin the merge tree to a fixed number of contiguous
instance blocks so a record depends on the block count only.

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


def blocked_welford(obs, n_blocks: int) -> Welford:
    """Per-block partials: obs (I, ...) -> leaves (V, ...); block b
    covers the contiguous instance rows [b*I/V, (b+1)*I/V)."""
    xb = obs.reshape((n_blocks, obs.shape[0] // n_blocks) + obs.shape[1:])
    parts = [update_batch(init_welford(x.shape[1:], obs.device), x)
             for x in xb]
    return Welford(*(torch.stack(leaf) for leaf in zip(*parts)))


def merge_blocks(acc: Welford) -> Welford:
    """Canonical merge of a (V, ...) stack of block accumulators in the
    psum form: N = Σn, MEAN = Σ(n·mean)/N, M2 = Σ(m2 + n·mean²) − N·MEAN².
    V == 1 returns the single block unchanged."""
    if acc.n.shape[0] == 1:
        return Welford(*(a[0] for a in acc))
    n = acc.n.sum(dim=0)
    s1 = (acc.n * acc.mean).sum(dim=0)
    s2 = (acc.m2 + acc.n * acc.mean * acc.mean).sum(dim=0)
    safe = torch.clamp_min(n, 1.0)
    mean = s1 / safe
    m2 = s2 - n * mean * mean
    return Welford(n=n, mean=torch.where(n > 0, mean, 0.0),
                   m2=torch.clamp_min(m2, 0.0))


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


def grouped_stats(obs, group_ids, n_groups: int) -> Stats:
    """Per-group statistics over the instance axis (sweep points):
    obs (I, n_obs), group_ids (I,) -> Stats with (n_groups, n_obs)
    leaves."""
    return finalize(_group_welford(obs, group_ids, n_groups))


def blocked_stats(obs, n_blocks: int = 1) -> Stats:
    """Window statistics under the fixed `n_blocks` merge tree
    (n_blocks == 1 is the single update_batch fold)."""
    if n_blocks == 1:
        return finalize(update_batch(
            init_welford(obs.shape[1:], obs.device), obs))
    return finalize(merge_blocks(blocked_welford(obs, n_blocks)))


def blocked_grouped_welford(obs, group_ids, n_groups: int,
                            n_blocks: int) -> Welford:
    """Per-(block, group) masked partials: leaves (V, n_groups, ...)."""
    bs = obs.shape[0] // n_blocks
    parts = [_group_welford(obs[v * bs:(v + 1) * bs],
                            group_ids[v * bs:(v + 1) * bs], n_groups)
             for v in range(n_blocks)]
    return Welford(*(torch.stack(leaf) for leaf in zip(*parts)))
