"""The fused SSA window: CUDA kernel wrapper and its plain torch twin.

`ssa_window_call` runs up to `n_steps` dense exact SSA events per lane
toward `horizon` — the port of the Pallas kernel
`repro/kernels/ssa_step.py::ssa_window_call` (`_window_kernel`). For
CUDA tensors it launches the hand-written kernel
`kernels/csrc/ssa_window.cu` (built by `kernels/build.py`) or raises;
for CPU tensors it runs `ssa_window_plain`, which loops the port's
`gillespie.ssa_step` — the port of the reference's oracle
`repro/kernels/ref.py::ssa_window_ref`. The two give the same bits.

`ssa_window_call.launches` counts kernel launches (CPU calls do not
count), so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.gillespie import LaneState, live, ssa_step
from repro_torch.core.reactions import MAX_REACTANTS

#: shape caps of the CUDA kernel (per-thread population array, shared
#: memory tables); larger systems raise instead of falling back
MAX_S = 64
MAX_R = 64

_P = ctypes.c_void_p
_ARGTYPES = ([_P] * 10 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int]
             + [_P] * 6 + [_P])


def ssa_window_plain(x, t, dead, key, ctr, ctr_hi, idx, coef, delta, rates,
                     horizon, *, n_steps: int):
    """Plain torch twin of the kernel: loops `ssa_step` up to n_steps
    times (stopping early once no lane is live — later steps would be
    no-ops). Same arguments and results as `ssa_window_call`."""
    b = x.shape[0]
    h = torch.as_tensor(np.float32(horizon), device=x.device)
    zi = torch.zeros((b,), dtype=torch.int32, device=x.device)
    st = LaneState(x=x, t=t, key=key, ctr=ctr, ctr_hi=ctr_hi, steps=zi,
                   leaps=zi, dead=dead > 0,
                   no_leap=torch.zeros_like(dead, dtype=torch.bool))
    tensors = (idx, coef, delta, rates)
    for _ in range(n_steps):
        if not bool(live(st, h).any()):
            break
        st = ssa_step(st, tensors, h)
    return (st.x, st.t, st.dead.to(torch.int32), st.steps, st.ctr,
            st.ctr_hi)


def _check(name, tensor, dtype, shape, device):
    if tensor.dtype != dtype:
        raise ValueError(f"ssa_window_call: {name} must be {dtype}, got "
                         f"{tensor.dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"ssa_window_call: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(tensor.shape)}")
    if tensor.device != device:
        raise ValueError(f"ssa_window_call: {name} is on {tensor.device}, "
                         f"expected {device}")
    if not tensor.is_contiguous():
        raise ValueError(f"ssa_window_call: {name} must be contiguous")


def ssa_window_call(x, t, dead, key, ctr, ctr_hi, idx, coef, delta, rates,
                    horizon, *, n_steps: int):
    """Run up to n_steps fused SSA events per lane toward `horizon`.

    x: (B, S) float32; t: (B,) float32; dead: (B,) int32; key: (B, 2)
    int32 bits; ctr / ctr_hi: (B,) int32 bits; idx / coef: (R, 4)
    int32 reactant tables; delta: (R, S) float32; rates: (R,) shared or
    (B, R) per lane, float32; horizon: a float (rounded to float32).
    Returns (x, t, dead, steps_taken, ctr, ctr_hi) as new tensors.
    """
    if x.device.type == "cpu":
        return ssa_window_plain(x, t, dead, key, ctr, ctr_hi, idx, coef,
                                delta, rates, horizon, n_steps=n_steps)
    if x.device.type != "cuda":
        raise ValueError(f"ssa_window_call: unsupported device {x.device}")
    b, s = x.shape
    r = delta.shape[0]
    if not (1 <= s <= MAX_S and 1 <= r <= MAX_R):
        raise ValueError(
            f"ssa_window_call: the CUDA kernel takes 1 <= S <= {MAX_S} "
            f"species and 1 <= R <= {MAX_R} reactions, got S={s}, R={r}")
    if not 0 <= n_steps < 2 ** 31:
        raise ValueError(f"ssa_window_call: n_steps={n_steps} out of range")
    dev = x.device
    _check("x", x, torch.float32, (b, s), dev)
    _check("t", t, torch.float32, (b,), dev)
    _check("dead", dead, torch.int32, (b,), dev)
    _check("key", key, torch.int32, (b, 2), dev)
    _check("ctr", ctr, torch.int32, (b,), dev)
    _check("ctr_hi", ctr_hi, torch.int32, (b,), dev)
    _check("idx", idx, torch.int32, (r, MAX_REACTANTS), dev)
    _check("coef", coef, torch.int32, (r, MAX_REACTANTS), dev)
    _check("delta", delta, torch.float32, (r, s), dev)
    per_lane = rates.ndim == 2
    _check("rates", rates, torch.float32, (b, r) if per_lane else (r,), dev)
    from repro_torch.kernels.build import load

    fn = load().ssa_window_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    outs = (torch.empty_like(x), torch.empty_like(t), torch.empty_like(dead),
            torch.empty_like(dead), torch.empty_like(ctr),
            torch.empty_like(ctr_hi))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(a.data_ptr() for a in (x, t, dead, key, ctr, ctr_hi, idx,
                                          coef, delta, rates)),
                 int(per_lane), float(np.float32(horizon)), int(n_steps),
                 b, s, r, *(o.data_ptr() for o in outs), stream)
    if err != 0:
        raise RuntimeError(f"ssa_window kernel launch failed: CUDA error "
                           f"{err}")
    ssa_window_call.launches += 1
    return outs


ssa_window_call.launches = 0
