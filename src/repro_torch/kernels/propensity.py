"""The Match alone: CUDA kernel wrapper and its plain torch twin; port
of `repro/kernels/propensity.py`.

`propensity_call(x, idx, coef, rates)` gives the (B, R) mass-action
propensities in the association of the reference's Pallas kernel
`_propensity_kernel`: the slot factors C(n, c) multiplied from 1.0 in
slot order, the comb unroll to MAX_COEF, and the rates multiplied LAST
(the SSA steps multiply them first; the two orders can differ in the
last bit). The reference gathers populations with one-hot matmuls
(`reactant_onehots`); the port gathers them by reactant index, which
gives the same bits on integer-valued float32 populations.

For CUDA tensors the wrapper launches `kernels/csrc/propensity.cu` or
raises; for CPU tensors it runs `propensity_plain`. Kernel and twin
give the same bits. `propensity_call.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from functools import partial

import numpy as np
import torch

from repro_torch.core.reactions import (
    MAX_COEF,
    MAX_REACTANTS,
    ReactionSystem,
    comb_factors,
)
from repro_torch.kernels.ssa_step import check_operand, launch

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 4 + [ctypes.c_int] * 5 + [_P, _P]


def reactant_onehots(system: ReactionSystem) -> np.ndarray:
    """(M, S, R) one-hot matrices E[m][s, j] = 1 iff reactant slot m of
    reaction j is species s — the reference kernel's Match operand.
    Padding slots are all-zero columns."""
    m, s, r = MAX_REACTANTS, system.n_species, system.n_reactions
    e = np.zeros((m, s, r), np.float32)
    for j in range(r):
        for mm in range(m):
            idx = system.reactant_idx[j, mm]
            if system.reactant_coef[j, mm] > 0 and idx < s:
                e[mm, idx, j] = 1.0
    return e


def propensity_plain(x, idx, coef, rates):
    """Plain torch twin of the kernel: x (B, S) float32; idx / coef
    (R, M) integer; rates (R,) or (B, R) float32. Returns (B, R)."""
    b = x.shape[0]
    xp = torch.cat([x, torch.ones((b, 1), dtype=x.dtype, device=x.device)],
                   dim=1)  # pad slots read 1.0 and have coef 0
    pops = xp[:, idx]  # (B, R, M)
    a = torch.ones((b, idx.shape[0]), dtype=x.dtype, device=x.device)
    for m in range(idx.shape[1]):
        a = a * comb_factors(pops[:, :, m], coef[None, :, m], MAX_COEF)
    return a * rates.to(x.dtype)


def propensity_call(x, idx, coef, rates):
    """(B, R) propensities, rates last. x: (B, S) float32; idx / coef:
    (R, M) int32 reactant tables; rates: (R,) shared or (B, R) per lane,
    float32. Coefficients above MAX_COEF are evaluated as the reference
    kernel does (unroll to MAX_COEF); `ops.system_kernel_tensors`
    refuses such systems."""
    if x.device.type == "cpu":
        return propensity_plain(x, idx, coef, rates)
    if x.device.type != "cuda":
        raise ValueError(f"propensity_call: unsupported device {x.device}")
    b, s = x.shape
    r, m = idx.shape
    dev = x.device
    check = partial(check_operand, "propensity_call", device=dev)
    check("x", x, torch.float32, (b, s))
    check("idx", idx, torch.int32, (r, m))
    check("coef", coef, torch.int32, (r, m))
    per_lane = rates.ndim == 2
    check("rates", rates, torch.float32, (b, r) if per_lane else (r,))
    from repro_torch.kernels.build import load

    fn = load().propensity_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty((b, r), dtype=torch.float32, device=dev)
    err = launch(fn, dev, x.data_ptr(), idx.data_ptr(), coef.data_ptr(),
                 rates.data_ptr(), int(per_lane), b, s, r, m, out.data_ptr())
    if err != 0:
        raise RuntimeError(f"propensity kernel launch failed: CUDA error "
                           f"{err}")
    propensity_call.launches += 1
    return out


propensity_call.launches = 0
