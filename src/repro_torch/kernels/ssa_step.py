"""The fused SSA windows: CUDA kernel wrappers and their plain torch
twins.

`ssa_window_call` runs up to `n_steps` dense exact SSA events per lane
toward `horizon` — the port of the Pallas kernel
`repro/kernels/ssa_step.py::ssa_window_call` (`_window_kernel`). For
CUDA tensors it launches the hand-written kernel
`kernels/csrc/ssa_window.cu` or raises; for CPU tensors it runs
`ssa_window_plain`, which loops the port's `gillespie.ssa_step` — the
port of the reference's oracle `repro/kernels/ref.py::ssa_window_ref`.

`sparse_window_call` is the same for the sparse exact step — the port
of `sparse_window_call` (`_sparse_window_kernel`): the CUDA kernel
`kernels/csrc/sparse_window.cu`, or on the CPU `sparse_window_plain`,
which seeds the carried propensities with
`gillespie.initial_propensities` and loops `gillespie.sparse_ssa_step`.

Kernel and twin give the same bits. Each wrapper's `.launches` counts
its kernel launches (CPU calls do not count), so a run can show that
its main path went through the kernel. Both libraries' kernels come
from `kernels/build.py`.
"""
from __future__ import annotations

import ctypes
from functools import partial

import numpy as np
import torch

from repro_torch.core.gillespie import (
    LaneState,
    initial_propensities,
    live,
    resolve_carry,
    sparse_ssa_step,
    ssa_step,
)
from repro_torch.core.reactions import MAX_REACTANTS

#: shape caps of the dense CUDA kernel (per-thread population array,
#: shared memory tables); larger systems raise — run them with
#: sparse=True, whose kernel has no such cap
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


def check_operand(fn, name, tensor, dtype, shape, device):
    """Raise ValueError unless `tensor` has the dtype, shape and device
    the CUDA kernel behind `fn` reads, and is contiguous."""
    if tensor.dtype != dtype:
        raise ValueError(f"{fn}: {name} must be {dtype}, got "
                         f"{tensor.dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(tensor.shape)}")
    if tensor.device != device:
        raise ValueError(f"{fn}: {name} is on {tensor.device}, expected "
                         f"{device}")
    if not tensor.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def launch(fn, device, *args) -> int:
    """Call the C launcher `fn(*args, stream)` with `device` current and
    its current stream; returns the launcher's CUDA error code."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def _check_pool(check, x, t, dead, key, ctr, ctr_hi):
    b, s = x.shape
    check("x", x, torch.float32, (b, s))
    check("t", t, torch.float32, (b,))
    check("dead", dead, torch.int32, (b,))
    check("key", key, torch.int32, (b, 2))
    check("ctr", ctr, torch.int32, (b,))
    check("ctr_hi", ctr_hi, torch.int32, (b,))


def _pool_outputs(x, t, dead, ctr, ctr_hi):
    """Fresh (x, t, dead, steps, ctr, ctr_hi) output tensors."""
    return (torch.empty_like(x), torch.empty_like(t), torch.empty_like(dead),
            torch.empty_like(dead), torch.empty_like(ctr),
            torch.empty_like(ctr_hi))


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
            f"ssa_window_call: the dense CUDA kernel takes 1 <= S <= "
            f"{MAX_S} species and 1 <= R <= {MAX_R} reactions, got S={s}, "
            f"R={r}; run larger systems with sparse=True")
    if not 0 <= n_steps < 2 ** 31:
        raise ValueError(f"ssa_window_call: n_steps={n_steps} out of range")
    dev = x.device
    check = partial(check_operand, "ssa_window_call", device=dev)
    _check_pool(check, x, t, dead, key, ctr, ctr_hi)
    check("idx", idx, torch.int32, (r, MAX_REACTANTS))
    check("coef", coef, torch.int32, (r, MAX_REACTANTS))
    check("delta", delta, torch.float32, (r, s))
    per_lane = rates.ndim == 2
    check("rates", rates, torch.float32, (b, r) if per_lane else (r,))
    from repro_torch.kernels.build import load

    fn = load().ssa_window_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    outs = _pool_outputs(x, t, dead, ctr, ctr_hi)
    err = launch(fn, dev,
                 *(a.data_ptr() for a in (x, t, dead, key, ctr, ctr_hi, idx,
                                          coef, delta, rates)),
                 int(per_lane), float(np.float32(horizon)), int(n_steps),
                 b, s, r, *(o.data_ptr() for o in outs))
    if err != 0:
        raise RuntimeError(f"ssa_window kernel launch failed: CUDA error "
                           f"{err}")
    ssa_window_call.launches += 1
    return outs


ssa_window_call.launches = 0


def sparse_window_plain(x, t, dead, key, ctr, ctr_hi, idx_pad, coef_pad,
                        int_tab, flt_tab, rates_pad, horizon, *,
                        n_steps: int, max_c: int, d: int, k: int,
                        packed_rates: bool):
    """Plain torch twin of the sparse kernel, as the reference's
    `_sparse_window_kernel` runs: the carry seeded by
    `initial_propensities`, then up to n_steps `sparse_ssa_step`s
    (stopping early once no lane is live — later steps are no-ops).
    Same arguments and results as `sparse_window_call`."""
    b, m = x.shape[0], idx_pad.shape[1]
    h = torch.as_tensor(np.float32(horizon), device=x.device)
    a = initial_propensities(x, idx_pad, coef_pad, rates_pad[..., :-1],
                             max_c)
    bound = (int_tab, flt_tab, None if packed_rates else rates_pad, max_c,
             d, k, m)
    zi = torch.zeros((b,), dtype=torch.int32, device=x.device)
    st = LaneState(x=x, t=t, key=key, ctr=ctr, ctr_hi=ctr_hi, steps=zi,
                   leaps=zi, dead=dead > 0,
                   no_leap=torch.zeros_like(dead, dtype=torch.bool))
    aci = resolve_carry(a)
    for _ in range(n_steps):
        if not bool(live(st, h).any()):
            break
        st, aci = sparse_ssa_step(st, aci, bound, h)
    return (st.x, st.t, st.dead.to(torch.int32), st.steps, st.ctr,
            st.ctr_hi)


_SPARSE_ARGTYPES = ([_P] * 11 + [ctypes.c_int, ctypes.c_float]
                    + [ctypes.c_int] * 8 + [_P] * 7 + [_P])


def sparse_window_call(x, t, dead, key, ctr, ctr_hi, idx_pad, coef_pad,
                       int_tab, flt_tab, rates_pad, horizon, *,
                       n_steps: int, max_c: int, d: int, k: int,
                       packed_rates: bool):
    """Run up to n_steps sparse SSA events per lane toward `horizon`.

    Pool operands as `ssa_window_call`. idx_pad / coef_pad: (R+1, M)
    int32 (`gillespie.sparse_system_tensors`, the seed); int_tab
    (R+1, D+K+K·M) int32 and flt_tab (R+1, D+K·M[+K]) float32 from
    `gillespie.bind_sparse_step` (`packed_rates`: its rates2d was None,
    the dep-row rates sit in flt_tab); rates_pad (R+1,) shared or
    (B, R+1) per lane, float32 (`gillespie.pad_rates`).
    Returns (x, t, dead, steps_taken, ctr, ctr_hi) as new tensors. On
    the card the carried propensities live in an (R+1, B) scratch
    tensor that lives for the launch only.
    """
    if x.device.type == "cpu":
        return sparse_window_plain(
            x, t, dead, key, ctr, ctr_hi, idx_pad, coef_pad, int_tab,
            flt_tab, rates_pad, horizon, n_steps=n_steps, max_c=max_c, d=d,
            k=k, packed_rates=packed_rates)
    if x.device.type != "cuda":
        raise ValueError(f"sparse_window_call: unsupported device "
                         f"{x.device}")
    b, s = x.shape
    r1, m = idx_pad.shape
    per_lane = rates_pad.ndim == 2
    if packed_rates == per_lane:
        raise ValueError("sparse_window_call: packed_rates must be True "
                         "exactly when rates_pad is shared (R+1,)")
    if not 0 <= n_steps < 2 ** 31 or max_c < 1 or d < 1 or k < 1:
        raise ValueError(f"sparse_window_call: bad static arguments "
                         f"n_steps={n_steps}, max_c={max_c}, d={d}, k={k}")
    dev = x.device
    check = partial(check_operand, "sparse_window_call", device=dev)
    _check_pool(check, x, t, dead, key, ctr, ctr_hi)
    check("idx_pad", idx_pad, torch.int32, (r1, m))
    check("coef_pad", coef_pad, torch.int32, (r1, m))
    check("int_tab", int_tab, torch.int32, (r1, d + k + k * m))
    check("flt_tab", flt_tab, torch.float32,
          (r1, d + k * m + (0 if per_lane else k)))
    check("rates_pad", rates_pad, torch.float32,
          (b, r1) if per_lane else (r1,))
    from repro_torch.kernels.build import load

    fn = load().sparse_window_launch
    fn.argtypes = _SPARSE_ARGTYPES
    fn.restype = ctypes.c_int
    # freed when this returns; the caching allocator hands the block
    # only to work queued after the launch on the same stream
    carry = torch.empty((r1, b), dtype=torch.float32, device=dev)
    outs = _pool_outputs(x, t, dead, ctr, ctr_hi)
    err = launch(fn, dev,
                 *(a.data_ptr() for a in (x, t, dead, key, ctr, ctr_hi,
                                          idx_pad, coef_pad, int_tab,
                                          flt_tab, rates_pad)),
                 int(per_lane), float(np.float32(horizon)), int(n_steps), b,
                 s, r1 - 1, m, d, k, int(max_c), carry.data_ptr(),
                 *(o.data_ptr() for o in outs))
    if err != 0:
        raise RuntimeError(f"sparse_window kernel launch failed: CUDA "
                           f"error {err}")
    sparse_window_call.launches += 1
    return outs


sparse_window_call.launches = 0
