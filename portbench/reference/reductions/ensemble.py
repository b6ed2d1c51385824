"""`Reduction.ENSEMBLE`: one record a window over every lane."""
from __future__ import annotations

import numpy as np

Z90 = 1.6448536269514722


def fold(obs) -> dict:
    """A window's record from the observables (B, n_obs) of every lane,
    in float64: n, mean, the unbiased variance and the half-width of
    the 90% normal confidence interval."""
    obs = np.asarray(obs, np.float64)
    n = obs.shape[0]
    mean = obs.mean(axis=0)
    var = ((obs - mean) ** 2).sum(axis=0) / max(n - 1, 1)
    return dict(n=float(n), mean=mean, var=var,
                ci90=Z90 * np.sqrt(var / n))


def fold_bf16(obs) -> dict:
    """The record's fold evaluated in bfloat16 (the control): the
    observables, the sums, the mean, the deviations and the variance."""
    import torch

    x = torch.as_tensor(np.asarray(obs, np.float32)).to(torch.bfloat16)
    n = x.shape[0]
    mean = x.sum(dim=0) / n
    var = ((x - mean) ** 2).sum(dim=0) / max(n - 1, 1)
    return dict(n=float(n), mean=mean.float().numpy(),
                var=var.float().numpy())
