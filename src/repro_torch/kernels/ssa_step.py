"""The fused SSA windows: CUDA kernel wrappers and their plain torch
twins.

`ssa_window_call` runs up to `n_steps` dense exact SSA events per lane
toward `horizon` — the port of the Pallas kernel
`repro/kernels/ssa_step.py::ssa_window_call` (`_window_kernel`). For
CUDA tensors it launches `ssa_window_generated`, the hand-written
kernel `kernels/netgen.py` writes for the network (or raises); for CPU
tensors it runs `ssa_window_plain`, which loops the port's
`gillespie.ssa_step` — the port of the reference's oracle
`repro/kernels/ref.py::ssa_window_ref`. `ssa_window_tables`
(`kernels/csrc/ssa_window.cu`, which reads the network's tables from
memory) gives the same bits; the card tests and `chip_smoke.py` hold
the generated kernel against it.

`sparse_window_call` is the same for the sparse exact step — the port
of `sparse_window_call` (`_sparse_window_kernel`): the CUDA kernel
`kernels/csrc/sparse_window.cu`, or on the CPU `sparse_window_plain`,
which seeds the carried propensities with
`gillespie.initial_propensities` and loops `gillespie.sparse_ssa_step`.

`tau_window_call` and `sparse_tau_window_call` run up to `n_steps`
adaptive tau-leap iterations per lane — the ports of the reference's
`tau_window_call` (`_tau_window_kernel`) and `sparse_tau_window_call`
(`_sparse_tau_window_kernel`): the CUDA kernels
`kernels/csrc/tau_window.cu` (a thread per lane; S, R <= 64, reactant
coefficients <= 4; tables and the lanes' arrays in shared memory) and
`kernels/csrc/sparse_tau_window.cu` (a warp per lane, its arrays in
shared memory, as many lanes a block as
`sparse_tau_lanes_per_block(S, R)` fits), or on the CPU
`tau_window_plain` / `sparse_tau_window_plain`, which loop
`core.tau_leap.tau_step_core`. The two take the same
operands (`core.tau_leap.TauTables` and the rates) and give the same
bits on a system both accept; they differ in who runs a lane and where
its arrays live, and in the comb unroll (MAX_COEF, or the system's
`max_c`). Besides the pool they return each lane's count of active
iterations, from which the chunk loop recovers the reference's chunk
count (a tau iteration consumes a varying number of counter blocks).

Kernel and twin give the same bits. Each wrapper's `.launches` counts
its kernel launches (CPU calls do not count), so a run can show that
its main path went through the kernel. All the kernels but the
generated ones come from one library built by `kernels/build.py`.
"""
from __future__ import annotations

import ctypes
from functools import partial
from typing import Any, NamedTuple

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
from repro_torch.core.reactions import MAX_COEF, MAX_REACTANTS
from repro_torch.core.stream import from_words, to_words
from repro_torch.core.tau_leap import TauTables, lane_fallback, tau_step_core

#: shape caps of the dense CUDA kernels (the lanes' arrays and the
#: tables in shared memory, dependency masks of 64 bits); larger systems
#: raise — run them with sparse=True
MAX_S = 64
MAX_R = 64

#: dynamic shared memory one block may hold on Hopper (227 KB)
SMEM_BLOCK_BYTES = 232_448
#: a checkpoint of the sparse kernel's a0 fold every CK_ROWS rows
CK_ROWS = 32

_P = ctypes.c_void_p
_ARGTYPES = ([_P] * 11 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int]
             + [_P] * 7 + [_P])


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


def dense_dep_mask(idx, coef, delta) -> torch.Tensor:
    """The dense kernel's dependency graph for the tables idx / coef
    (R, 4) and delta (R, S), R <= 64, on delta's device: (R,) int64 whose
    bit r of entry j is set iff r is in dep(j), i.e. reaction r has a
    reactant (coefficient > 0) that j changes (`reactions.sparse_tables`'
    dep lists). A caller binds it with the tables, not per window."""
    idx, coef, dl = (np.asarray(a.cpu()) for a in (idx, coef, delta))
    r, s = dl.shape
    if r > MAX_R:
        raise ValueError(f"dense_dep_mask: the dense CUDA kernel takes R <= "
                         f"{MAX_R} reactions, got R={r}; run larger systems "
                         f"with sparse=True")
    reads = np.zeros((r, s + 1), bool)  # column S takes the pads
    np.logical_or.at(reads, (np.arange(r)[:, None], idx), coef > 0)
    dep = ((dl != 0).astype(np.int64)
           @ reads[:, :s].T.astype(np.int64)) > 0  # (j, r)
    bits = (dep.astype(np.uint64)
            << np.arange(r, dtype=np.uint64)).sum(axis=1, dtype=np.uint64)
    return torch.from_numpy(bits.view(np.int64)).to(delta.device)


def _check_dense(fn, x, t, dead, key, ctr, ctr_hi, idx, coef, delta, rates,
                 n_steps):
    """Raise ValueError unless the operands are what the dense exact
    kernels read; returns (B, S, R, rates per lane)."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    b, s = x.shape
    r = delta.shape[0]
    if not (1 <= s <= MAX_S and 1 <= r <= MAX_R):
        raise ValueError(
            f"{fn}: the dense CUDA kernel takes 1 <= S <= "
            f"{MAX_S} species and 1 <= R <= {MAX_R} reactions, got S={s}, "
            f"R={r}; run larger systems with sparse=True")
    if not 0 <= n_steps < 2 ** 31:
        raise ValueError(f"{fn}: n_steps={n_steps} out of range")
    check = partial(check_operand, fn, device=x.device)
    _check_pool(check, x, t, dead, key, ctr, ctr_hi)
    check("idx", idx, torch.int32, (r, MAX_REACTANTS))
    check("coef", coef, torch.int32, (r, MAX_REACTANTS))
    check("delta", delta, torch.float32, (r, s))
    per_lane = rates.ndim == 2
    check("rates", rates, torch.float32, (b, r) if per_lane else (r,))
    return b, s, r, per_lane


class NetworkKernel(NamedTuple):
    """A generated window kernel bound to one network's structure
    (`bind_network`): its S and R and its C launcher."""

    n_species: int
    n_reactions: int
    launch: Any


_NET_ARGTYPES = ([_P] * 7 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                             ctypes.c_int] + [_P] * 7 + [_P])


def bind_network(idx, coef, delta) -> NetworkKernel:
    """The generated kernel of the network idx / coef (R, 4), delta
    (R, S): its source from `netgen`, its library built at most once
    (`build.load_network`). Bind it with the tables, not per window: the
    first bind of a structure in a process may run nvcc."""
    from repro_torch.kernels import netgen
    from repro_torch.kernels.build import load_network

    net = netgen.network(idx, coef, delta)
    fn = load_network(netgen.window_source(net)).ssa_window_net_launch
    fn.argtypes = _NET_ARGTYPES
    fn.restype = ctypes.c_int
    return NetworkKernel(net.n_species, net.n_reactions, fn)


def ssa_window_generated(x, t, dead, key, ctr, ctr_hi, idx, coef, delta,
                         rates, horizon, *, n_steps: int, net=None):
    """`ssa_window_call` through the kernel generated for the network
    (CUDA tensors only): net, `bind_network(idx, coef, delta)`, bound
    here when None. The kernel reads the tables from its code, not from
    idx / coef / delta."""
    b, s, r, per_lane = _check_dense("ssa_window_generated", x, t, dead, key,
                                     ctr, ctr_hi, idx, coef, delta, rates,
                                     n_steps)
    if net is None:
        net = bind_network(idx, coef, delta)
    if (net.n_species, net.n_reactions) != (s, r):
        raise ValueError(f"ssa_window_generated: the bound kernel is for "
                         f"S={net.n_species}, R={net.n_reactions}, the "
                         f"operands have S={s}, R={r}")
    outs = _pool_outputs(x, t, dead, ctr, ctr_hi)
    ticket = torch.zeros((1,), dtype=torch.int32, device=x.device)
    err = launch(net.launch, x.device,
                 *(a.data_ptr() for a in (x, t, dead, key, ctr, ctr_hi,
                                          rates)),
                 int(per_lane), float(np.float32(horizon)), int(n_steps), b,
                 ticket.data_ptr(), *(o.data_ptr() for o in outs))
    if err != 0:
        raise RuntimeError(f"generated ssa_window kernel launch failed: "
                           f"CUDA error {err}")
    return outs


def ssa_window_tables(x, t, dead, key, ctr, ctr_hi, idx, coef, delta, rates,
                      horizon, *, n_steps: int, dep_mask=None):
    """`ssa_window_call` through `csrc/ssa_window.cu`, which reads the
    network's tables from memory (CUDA tensors only). dep_mask:
    `dense_dep_mask(idx, coef, delta)`, derived here when None."""
    b, s, r, per_lane = _check_dense("ssa_window_tables", x, t, dead, key,
                                     ctr, ctr_hi, idx, coef, delta, rates,
                                     n_steps)
    if dep_mask is None:
        dep_mask = dense_dep_mask(idx, coef, delta)
    check_operand("ssa_window_tables", "dep_mask", dep_mask, torch.int64,
                  (r,), x.device)
    from repro_torch.kernels.build import load

    fn = load().ssa_window_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    outs = _pool_outputs(x, t, dead, ctr, ctr_hi)
    ticket = torch.zeros((1,), dtype=torch.int32, device=x.device)
    err = launch(fn, x.device,
                 *(a.data_ptr() for a in (x, t, dead, key, ctr, ctr_hi, idx,
                                          coef, delta, rates, dep_mask)),
                 int(per_lane), float(np.float32(horizon)), int(n_steps),
                 b, s, r, ticket.data_ptr(), *(o.data_ptr() for o in outs))
    if err != 0:
        raise RuntimeError(f"ssa_window kernel launch failed: CUDA error "
                           f"{err}")
    return outs


def ssa_window_call(x, t, dead, key, ctr, ctr_hi, idx, coef, delta, rates,
                    horizon, *, n_steps: int, net=None):
    """Run up to n_steps fused SSA events per lane toward `horizon`.

    x: (B, S) float32; t: (B,) float32; dead: (B,) int32; key: (B, 2)
    int32 bits; ctr / ctr_hi: (B,) int32 bits; idx / coef: (R, 4)
    int32 reactant tables; delta: (R, S) float32; rates: (R,) shared or
    (B, R) per lane, float32; horizon: a float (rounded to float32);
    net: `bind_network(idx, coef, delta)`, bound here when None (the
    twin does not read it).
    Returns (x, t, dead, steps_taken, ctr, ctr_hi) as new tensors.

    Every shape the dense kernels take runs the generated kernel: its
    lane holds S populations and R rates and running sums in registers,
    and on an H100 the largest measured, lotka_volterra(63) (S + R =
    127), took 254 registers with no spill and ran a window in 28.2 ms
    against `ssa_window_tables`' 181.9 (PERF.md §6).
    """
    if x.device.type == "cpu":
        return ssa_window_plain(x, t, dead, key, ctr, ctr_hi, idx, coef,
                                delta, rates, horizon, n_steps=n_steps)
    if x.device.type != "cuda":
        raise ValueError(f"ssa_window_call: unsupported device {x.device}")
    outs = ssa_window_generated(x, t, dead, key, ctr, ctr_hi, idx, coef,
                                delta, rates, horizon, n_steps=n_steps,
                                net=net)
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


_SPARSE_ARGTYPES = ([_P] * 10 + [ctypes.c_int, ctypes.c_float]
                    + [ctypes.c_int] * 12 + [_P] * 9 + [_P])


def sparse_lane_rows(r: int) -> int:
    """Floats of one lane's region in the sparse kernel: the
    ceil(R/CK_ROWS) checkpoints padded to a multiple of 4, then the R
    carried propensities padded with zeros to whole blocks of CK_ROWS;
    one more float4 when that makes the count of float4 words even (an
    odd count puts the float4 reads of a quarter-warp's lanes in distinct
    banks)."""
    blocks = -(-r // CK_ROWS)
    rows = (blocks + 3) // 4 * 4 + blocks * CK_ROWS
    return rows + 4 if rows // 4 % 2 == 0 else rows


def _lanes_per_block(rows: int) -> int:
    """The most lanes (a multiple of 32, at most 128) whose regions of
    `rows` floats fit one block's shared memory; 0 if not 32."""
    return min(128, SMEM_BLOCK_BYTES // (4 * rows) // 32 * 32)


def sparse_window_route(r: int) -> tuple[str, int]:
    """Where the sparse kernel keeps each lane's carry (R propensities
    and ceil(R/CK_ROWS) checkpoints of the a0 fold), chosen from the
    number of reactions R: (route, lanes per block).

    "shared": the carry in shared memory, taken whenever 32 lanes'
    carries fit one block (R up to 1,728). "hbm": the carry in an HBM
    scratch tensor, 128 lanes per block: larger systems. The populations
    stay in x_out either way."""
    lanes = _lanes_per_block(sparse_lane_rows(r))
    return ("shared", lanes) if lanes else ("hbm", 128)


def sparse_recipe(idx_pad, coef_pad, int_tab, flt_tab, *, d: int, k: int,
                  packed_rates: bool):
    """The sparse kernel's packed tables, from the twin's: (slot_tab
    (R+1, 4), recipe (R+1, W)) int32, W = 4 ceil(2D/4) + 8K.

    A packed slot is species | coefficient << 24 (0 for an empty slot).
    Recipe row j: j's delta entries as (species, value bits) pairs,
    padded with (S, 0) to a multiple of 4 words (S: the pad row's delta
    species), then per dep row 8 words: the reaction (R at pads), its
    rate's bits (shared rates; 0 per lane), 2 zeros and its 4 packed
    slots. Pure layout: every value is one the twin's tables hold."""
    r1, m = idx_pad.shape
    if (m != MAX_REACTANTS or int(coef_pad.max()) >= 128
            or int(idx_pad.max()) >= 1 << 24):
        raise ValueError(f"sparse_recipe: needs M={MAX_REACTANTS} slots, "
                         f"coefficients < 128 and S < 2^24")
    slot_tab = torch.where(coef_pad > 0, idx_pad | (coef_pad << 24),
                           torch.zeros_like(idx_pad))
    dp = -(-2 * d // 4) * 4
    pairs = torch.full((r1, dp), 0, dtype=torch.int32, device=idx_pad.device)
    pairs[:, 0::2] = int_tab[-1:, :1]  # the pad row: species S
    pairs[:, 0:2 * d:2] = int_tab[:, :d]
    pairs[:, 1:2 * d:2] = flt_tab[:, :d].contiguous().view(torch.int32)
    dep = int_tab[:, d:d + k].long()
    group = torch.zeros((r1, k, 8), dtype=torch.int32, device=idx_pad.device)
    group[:, :, 0] = dep
    if packed_rates:
        group[:, :, 1] = flt_tab[:, d + k * m:].contiguous().view(
            torch.int32)
    group[:, :, 4:] = slot_tab[dep]
    return (slot_tab.contiguous(),
            torch.cat([pairs, group.reshape(r1, 8 * k)], dim=1).contiguous())


def sparse_window_call(x, t, dead, key, ctr, ctr_hi, idx_pad, coef_pad,
                       int_tab, flt_tab, rates_pad, horizon, *,
                       n_steps: int, max_c: int, d: int, k: int,
                       packed_rates: bool, dep_lo=None, packed=None):
    """Run up to n_steps sparse SSA events per lane toward `horizon`.

    Pool operands as `ssa_window_call`. idx_pad / coef_pad: (R+1, M)
    int32 (`gillespie.sparse_system_tensors`, the seed); int_tab
    (R+1, D+K+K·M) int32 and flt_tab (R+1, D+K·M[+K]) float32 from
    `gillespie.bind_sparse_step` (`packed_rates`: its rates2d was None,
    the dep-row rates sit in flt_tab); rates_pad (R+1,) shared or
    (B, R+1) per lane, float32 (`gillespie.pad_rates`). The kernel's own
    bound operands, derived here when None (`ops.bind_sparse_window`
    binds them once per run): dep_lo (R+1,) int32, the lowest row of
    each dep(j); packed, `sparse_recipe`'s (slot_tab, recipe). The twin
    reads neither. The route is `sparse_window_route(R)`'s.
    Returns (x, t, dead, steps_taken, ctr, ctr_hi) as new tensors. On
    the "hbm" route the carried propensities live in a scratch tensor
    that lives for the launch only. After a launch,
    `sparse_window_call.grid_lanes` holds the lanes its grid took first
    (one per thread); the rest came from the ticket.
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
    r = r1 - 1
    per_lane = rates_pad.ndim == 2
    if packed_rates == per_lane:
        raise ValueError("sparse_window_call: packed_rates must be True "
                         "exactly when rates_pad is shared (R+1,)")
    if not (0 <= n_steps < 2 ** 31 and max_c >= 1 and d >= 1 and k >= 1
            and m == MAX_REACTANTS):
        raise ValueError(f"sparse_window_call: bad static arguments "
                         f"n_steps={n_steps}, max_c={max_c}, d={d}, k={k}, "
                         f"M={m} (the kernel takes M={MAX_REACTANTS})")
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
    if dep_lo is None:
        dep_lo = int_tab[:, d:d + k].amin(dim=1).contiguous()
    if packed is None:
        packed = sparse_recipe(idx_pad, coef_pad, int_tab, flt_tab, d=d,
                               k=k, packed_rates=packed_rates)
    slot_tab, recipe = packed
    width = -(-2 * d // 4) * 4 + 8 * k
    check("dep_lo", dep_lo, torch.int32, (r1,))
    check("slot_tab", slot_tab, torch.int32, (r1, MAX_REACTANTS))
    check("recipe", recipe, torch.int32, (r1, width))
    route, threads = sparse_window_route(r)
    rows = sparse_lane_rows(r)
    from repro_torch.kernels.build import load

    fn = load().sparse_window_launch
    fn.argtypes = _SPARSE_ARGTYPES
    fn.restype = ctypes.c_int
    n_slots, scratch = 0, None
    if route == "hbm":
        # one region per thread of the grid, freed when this returns;
        # the caching allocator hands the block only to work queued
        # after the launch on the same stream
        props = torch.cuda.get_device_properties(dev)
        n_slots = min(b, props.multi_processor_count * getattr(
            props, "max_threads_per_multi_processor", 2048))
        scratch = torch.empty((n_slots, rows), dtype=torch.float32,
                              device=dev)
    ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
    grid_lanes = ctypes.c_int(0)
    outs = _pool_outputs(x, t, dead, ctr, ctr_hi)
    err = launch(fn, dev,
                 *(a.data_ptr() for a in (x, t, dead, key, ctr, ctr_hi,
                                          slot_tab, recipe, rates_pad,
                                          dep_lo)),
                 int(per_lane), float(np.float32(horizon)), int(n_steps), b,
                 s, r, width, d, k, int(max_c), int(route == "shared"),
                 threads, rows, n_slots,
                 0 if scratch is None else scratch.data_ptr(),
                 ticket.data_ptr(), ctypes.addressof(grid_lanes),
                 *(o.data_ptr() for o in outs))
    if err != 0:
        raise RuntimeError(f"sparse_window kernel launch failed: CUDA "
                           f"error {err}")
    sparse_window_call.launches += 1
    sparse_window_call.grid_lanes = grid_lanes.value
    return outs


sparse_window_call.launches = 0
sparse_window_call.grid_lanes = 0


def _tau_window_loop(x, t, dead, no_leap, key, ctr, ctr_hi, tables, rates,
                     horizon, n_steps, eps, fallback):
    """The tau twins' loop: up to n_steps `tau_step_core` iterations,
    stopping once no lane is live (later iterations are no-ops)."""
    h = torch.as_tensor(np.float32(horizon), device=x.device)
    fb = lane_fallback(no_leap > 0, fallback)
    k = to_words(key)
    lo, hi = to_words(ctr), to_words(ctr_hi)
    dl = dead > 0
    zi = torch.zeros_like(dead)
    steps, leaps, iters = zi, zi.clone(), zi.clone()
    for _ in range(n_steps):
        live = (t < h) & ~dl
        if not bool(live.any()):
            break
        iters = iters + live.to(torch.int32)
        x, t, dl, lo, hi, steps, leaps = tau_step_core(
            x, t, dl, k[:, 0], k[:, 1], lo, hi, steps, leaps, tables, rates,
            h, eps=eps, fallback=fb)
    return (x, t, dl.to(torch.int32), steps, leaps, from_words(lo),
            from_words(hi), iters)


def tau_window_plain(x, t, dead, no_leap, key, ctr, ctr_hi, idx, coef,
                     col_j, col_v, row_idx, row_val, rates, gi, rmask,
                     horizon, *, n_steps: int, eps: float, fallback: float):
    """Plain torch twin of the dense tau kernel: `tau_step_core` with the
    comb unroll to MAX_COEF, looped up to n_steps times. Same arguments
    and results as `tau_window_call`."""
    tables = TauTables(idx, coef, col_j, col_v, row_idx, row_val, gi, rmask,
                       MAX_COEF)
    return _tau_window_loop(x, t, dead, no_leap, key, ctr, ctr_hi, tables,
                            rates, horizon, n_steps, eps, fallback)


def sparse_tau_window_plain(x, t, dead, no_leap, key, ctr, ctr_hi, idx,
                            coef, col_j, col_v, row_idx, row_val, rates, gi,
                            rmask, horizon, *, n_steps: int, eps: float,
                            fallback: float, max_c: int):
    """Plain torch twin of the sparse tau kernel: `tau_step_core` with
    the comb unroll to `max_c`. Same arguments and results as
    `sparse_tau_window_call`."""
    tables = TauTables(idx, coef, col_j, col_v, row_idx, row_val, gi, rmask,
                       max_c)
    return _tau_window_loop(x, t, dead, no_leap, key, ctr, ctr_hi, tables,
                            rates, horizon, n_steps, eps, fallback)


def sparse_tau_lane_floats(s: int, r: int) -> int:
    """Floats of one lane's region in the sparse tau kernel's shared
    memory: the a0 fold's checkpoints padded to a multiple of 4, the R
    propensities padded with zeros to whole blocks of CK_ROWS, then the
    populations and the leap's increments dx, S each padded to a multiple
    of 4."""
    blocks = -(-r // CK_ROWS)
    return ((blocks + 3) // 4 * 4 + blocks * CK_ROWS
            + 2 * ((s + 3) // 4 * 4))


#: most lanes (warps) a block of the sparse tau kernel (its launch bound
#: in kernels/csrc/sparse_tau_window.cu is 32 threads a lane times this)
TAU_LANES_PER_BLOCK = 16


def sparse_tau_lanes_per_block(s: int, r: int) -> int:
    """Lanes (warps) a block of the sparse tau kernel, chosen from the
    number of species S and reactions R: as many lanes' regions
    (`sparse_tau_lane_floats`) as fit a block's shared memory, at most
    TAU_LANES_PER_BLOCK. Raises ValueError where one lane's region does
    not fit a block: there is no slower route to fall back to."""
    fit = SMEM_BLOCK_BYTES // (4 * sparse_tau_lane_floats(s, r))
    if fit < 1:
        raise ValueError(
            f"sparse_tau_window_call: one lane's arrays (S={s} species, "
            f"R={r} reactions: {4 * sparse_tau_lane_floats(s, r)} bytes) do "
            f"not fit the {SMEM_BLOCK_BYTES} bytes of a block's shared "
            f"memory")
    return min(TAU_LANES_PER_BLOCK, fit)


#: the tau launchers' scalars: rates_per_lane, horizon, n_steps, eps,
#: fallback, then B, S, R, L, D, G, max_c
_TAU_SCALARS = ([ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float,
                 ctypes.c_float] + [ctypes.c_int] * 7)


def _launch_tau(name, fn_name, args, horizon, n_steps, eps, fallback,
                max_c, dep_mask=None):
    """Check the tau kernels' operands, launch `fn_name` and return its
    eight fresh outputs (x, t, dead, steps, leaps, ctr, ctr_hi,
    iterations) and the lanes its grid took first (the rest came from
    the ticket). With `dep_mask` (the dense kernel, its masks already
    checked) the launch takes it after the tables; without it (the sparse
    kernel) `sparse_tau_lanes_per_block` and the floats
    of a lane's region."""
    (x, t, dead, no_leap, key, ctr, ctr_hi, idx, coef, col_j, col_v,
     row_idx, row_val, rates, gi, rmask) = args
    b, s = x.shape
    r = idx.shape[0]
    width, d, n_gi = col_j.shape[1], row_idx.shape[1], gi.shape[0]
    if not 0 <= n_steps < 2 ** 31 or max_c < 1:
        raise ValueError(f"{name}: bad static arguments n_steps={n_steps}, "
                         f"max_c={max_c}")
    if not (eps > 0 and fallback >= 0):
        raise ValueError(f"{name}: need eps > 0 and fallback >= 0, got "
                         f"eps={eps}, fallback={fallback}")
    dev = x.device
    check = partial(check_operand, name, device=dev)
    _check_pool(check, x, t, dead, key, ctr, ctr_hi)
    check("no_leap", no_leap, torch.int32, (b,))
    check("idx", idx, torch.int32, (r, MAX_REACTANTS))
    check("coef", coef, torch.int32, (r, MAX_REACTANTS))
    check("col_j", col_j, torch.int32, (s, width))
    check("col_v", col_v, torch.float32, (s, width))
    check("row_idx", row_idx, torch.int32, (r + 1, d))
    check("row_val", row_val, torch.float32, (r + 1, d))
    per_lane = rates.ndim == 2
    check("rates", rates, torch.float32, (b, r) if per_lane else (r,))
    check("gi", gi, torch.float32, (n_gi, s))
    check("rmask", rmask, torch.float32, (s,))
    if dep_mask is not None:  # the dense kernel
        tab, ints = (dep_mask,), ()
    else:
        tab, ints = (), (sparse_tau_lanes_per_block(s, r),
                         sparse_tau_lane_floats(s, r))
    from repro_torch.kernels.build import load

    fn = getattr(load(), fn_name)
    fn.argtypes = ([_P] * (16 + len(tab)) + _TAU_SCALARS
                   + [ctypes.c_int] * len(ints) + [_P] * 11)
    fn.restype = ctypes.c_int
    outs = (torch.empty_like(x), torch.empty_like(t),
            *(torch.empty_like(dead) for _ in range(3)),
            torch.empty_like(ctr), torch.empty_like(ctr_hi),
            torch.empty_like(dead))
    ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
    grid_lanes = ctypes.c_int(0)
    err = launch(fn, dev, *(a.data_ptr() for a in (*args, *tab)),
                 int(per_lane), float(np.float32(horizon)), int(n_steps),
                 float(np.float32(eps)), float(np.float32(fallback)), b, s, r,
                 width, d, n_gi, int(max_c), *ints, ticket.data_ptr(),
                 ctypes.addressof(grid_lanes), *(o.data_ptr() for o in outs))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return outs, grid_lanes.value


def tau_window_call(x, t, dead, no_leap, key, ctr, ctr_hi, idx, coef, col_j,
                    col_v, row_idx, row_val, rates, gi, rmask, horizon, *,
                    n_steps: int, eps: float, fallback: float,
                    dep_mask=None):
    """Run up to n_steps fused tau-leap iterations per lane toward
    `horizon` through the dense kernel, whose comb unroll stops at
    MAX_COEF (`core.tau_leap.tau_tables(sparse=False)` refuses larger
    reactant coefficients).

    Pool operands as `ssa_window_call`, plus no_leap (B,) int32 (nonzero:
    the lane takes exact steps only). idx / coef (R, 4) int32; col_j /
    col_v (S, L), row_idx / row_val (R+1, D), gi (G, S), rmask (S,):
    `core.tau_leap.TauTables`; rates (R,) or (B, R) float32. dep_mask:
    the kernel's `dense_dep_mask` of the system (`FusedDispatch.set_rates`
    binds it once per run), derived here from the tables when None (the
    twin does not read it).
    Returns (x, t, dead, steps_taken, leaps_taken, ctr, ctr_hi,
    iterations) as new tensors, iterations counting each lane's active
    iterations. After a launch, `tau_window_call.grid_lanes` holds the
    lanes its grid took first (one per thread); the rest came from the
    ticket.
    """
    args = (x, t, dead, no_leap, key, ctr, ctr_hi, idx, coef, col_j, col_v,
            row_idx, row_val, rates, gi, rmask)
    if x.device.type == "cpu":
        return tau_window_plain(*args, horizon, n_steps=n_steps, eps=eps,
                                fallback=fallback)
    if x.device.type != "cuda":
        raise ValueError(f"tau_window_call: unsupported device {x.device}")
    s, r = x.shape[1], idx.shape[0]
    if not (1 <= s <= MAX_S and 1 <= r <= MAX_R):
        raise ValueError(
            f"tau_window_call: the dense CUDA kernel takes 1 <= S <= "
            f"{MAX_S} species and 1 <= R <= {MAX_R} reactions, got S={s}, "
            f"R={r}; run larger systems with sparse=True")
    if dep_mask is None:
        dep_mask = tau_dep_mask(idx, coef, row_idx, row_val, s)
    check_operand("tau_window_call", "dep_mask", dep_mask, torch.int64, (r,),
                  x.device)
    outs, tau_window_call.grid_lanes = _launch_tau(
        "tau_window_call", "tau_window_launch", args, horizon, n_steps, eps,
        fallback, MAX_COEF, dep_mask)
    tau_window_call.launches += 1
    return outs


tau_window_call.launches = 0
tau_window_call.grid_lanes = 0


def tau_dep_mask(idx, coef, row_idx, row_val, s: int) -> torch.Tensor:
    """`dense_dep_mask` from a system's tau tables (the exact sub-step's
    delta rows `row_idx` / `row_val` (R+1, D), pads at species S)."""
    r = idx.shape[0]
    delta = torch.zeros((r, s + 1), dtype=torch.float32,
                        device=row_val.device)
    delta.scatter_(1, row_idx[:r].long(), row_val[:r])
    return dense_dep_mask(idx, coef, delta[:, :s])


def sparse_tau_window_call(x, t, dead, no_leap, key, ctr, ctr_hi, idx, coef,
                           col_j, col_v, row_idx, row_val, rates, gi, rmask,
                           horizon, *, n_steps: int, eps: float,
                           fallback: float, max_c: int):
    """`tau_window_call` through the sparse kernel: a warp per lane, the
    comb unroll to `max_c` (at least the system's largest reactant
    coefficient, as `core.tau_leap.tau_tables(sparse=True)` sets it).
    Each lane's populations, propensities and leap increments live in
    shared memory (`sparse_tau_lanes_per_block(S, R)`, which raises where
    they do not fit). After a launch, `sparse_tau_window_call.grid_lanes`
    holds the lanes its grid took first (one per warp); the rest came
    from the ticket."""
    args = (x, t, dead, no_leap, key, ctr, ctr_hi, idx, coef, col_j, col_v,
            row_idx, row_val, rates, gi, rmask)
    if x.device.type == "cpu":
        return sparse_tau_window_plain(*args, horizon, n_steps=n_steps,
                                       eps=eps, fallback=fallback,
                                       max_c=max_c)
    if x.device.type != "cuda":
        raise ValueError(f"sparse_tau_window_call: unsupported device "
                         f"{x.device}")
    outs, sparse_tau_window_call.grid_lanes = _launch_tau(
        "sparse_tau_window_call", "sparse_tau_window_launch", args, horizon,
        n_steps, eps, fallback, max_c)
    sparse_tau_window_call.launches += 1
    return outs


sparse_tau_window_call.launches = 0
sparse_tau_window_call.grid_lanes = 0
