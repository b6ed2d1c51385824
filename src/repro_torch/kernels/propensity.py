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
give the same bits. `propensity_call.launches` counts kernel launches;
`.route` and `.tile` hold the route and lanes a tile of the last one.

The kernel walks tiles of lanes on one of two routes, picked from the
shape by `match_route` and by nothing else: "shared" stages a tile's
population rows (double buffered) and the reaction tables in shared
memory; "global" gathers from x, for systems whose tables plus two rows
of one lane do not fit a block's shared memory, and for raw tables of
more than MAX_REACTANTS slots a reaction (every system's tables have
exactly MAX_REACTANTS).
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
from repro_torch.kernels.ssa_step import (
    SMEM_BLOCK_BYTES,
    check_operand,
    launch,
)

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 4 + [ctypes.c_int] * 7 + [_P, _P]

#: outputs a tile aims at: 32 for each of the block's 256 threads (on
#: ring80 16 lanes a tile ran faster than 8 or 32; PERF.md)
MATCH_TILE_OUTPUTS = 8192
#: a tile's lanes x species and lanes x reactions stay below this, so the
#: kernel indexes inside a tile in 32 bits
MATCH_TILE_INDEX = 1 << 30


def match_smem_bytes(s: int, r: int, lanes: int) -> int:
    """Shared memory of the "shared" route's block: the packed table (one
    int4 a reaction), the shared rates and two buffers of `lanes`
    population rows, each part rounded up to 16 bytes."""
    return 16 * (r + -(-r // 4) + 2 * -(-lanes * s // 4))


def match_lanes_per_tile(s: int, r: int, m: int = MAX_REACTANTS) -> int:
    """Lanes a tile of the Match kernel, from S, R and the slots M.

    As many lanes as give MATCH_TILE_OUTPUTS outputs (rounded up to a
    multiple of 4, so every whole tile's population rows start 16-byte
    aligned for the kernel's 16-byte copies), fewer
    where the "shared" route's block would pass SMEM_BLOCK_BYTES (then a
    multiple of 4 where at least 4 fit). On the "global" route, the
    lanes that give those outputs."""
    want = -(-MATCH_TILE_OUTPUTS // r)
    want = min(-(-want // 4) * 4,
               (MATCH_TILE_INDEX - 1) // max(s, r))
    if match_route(s, r, m) == "global":
        return max(want, 1)
    fit = min(want, (SMEM_BLOCK_BYTES - match_smem_bytes(s, r, 0))
              // (8 * s))
    while match_smem_bytes(s, r, fit) > SMEM_BLOCK_BYTES:
        fit -= 1
    return fit // 4 * 4 if fit >= 4 else fit


def match_route(s: int, r: int, m: int = MAX_REACTANTS) -> str:
    """"shared" where a reaction has at most MAX_REACTANTS slots and the
    tables plus two population rows of one lane fit a block's shared
    memory, else "global"."""
    return ("shared" if m <= MAX_REACTANTS
            and match_smem_bytes(s, r, 1) <= SMEM_BLOCK_BYTES else "global")


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
    refuses such systems. A live slot (coef > 0) names a species < S."""
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
    route = match_route(s, r, m)
    tile = match_lanes_per_tile(s, r, m)
    out = torch.empty((b, r), dtype=torch.float32, device=dev)
    err = launch(fn, dev, x.data_ptr(), idx.data_ptr(), coef.data_ptr(),
                 rates.data_ptr(), int(per_lane), b, s, r, m,
                 int(route == "shared"), tile, out.data_ptr())
    if err != 0:
        raise RuntimeError(f"propensity kernel launch failed: CUDA error "
                           f"{err}")
    propensity_call.launches += 1
    propensity_call.route, propensity_call.tile = route, tile
    return out


propensity_call.launches = 0
propensity_call.route = None
propensity_call.tile = 0
