"""Plain torch oracles for the kernels; port of `repro/kernels/ref.py`.
(The SSA window's oracle, `ssa_window_ref`, is the dense kernel's twin
`kernels.ssa_step.ssa_window_plain`.)"""
from __future__ import annotations

import torch

from repro_torch.core.reactions import propensities


def propensity_ref(x, idx, coef, rates):
    """Gather-based rates-first propensities — the oracle the reference
    holds its Match kernel against (within rtol 1e-6: the kernel
    multiplies the rates last)."""
    if rates.ndim == 1:
        rates = torch.broadcast_to(rates, (x.shape[0], rates.shape[0]))
    return propensities(x, idx, coef, rates)
