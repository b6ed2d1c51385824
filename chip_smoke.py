#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. build   — compile the kernel library from every source under
             `src/repro_torch/kernels/csrc` (one `nvcc -shared --threads
             0` call over all of them, `kernels/build.py`); print the
             seconds, ptxas's report and the card's name and power limit.
2. kernels — hold each kernel bitwise against its plain torch twin on the
             card, printing the count of differing elements:
             the dense SSA window on lv8 (65,536 lanes, per-lane sweep
             rates), ecoli, transport, a budget cut and a system with
             reactant coefficients 3 and 4; the sparse SSA window on
             ring80 (shared rates) and lattice8x8 (per-lane rates), both
             with the carry on chip, ring256 (R = 1,792: the carry in
             HBM; more lanes than its one-wave grid holds, so threads
             take lanes from the ticket), ecoli (also against the dense
             kernel), a coefficient-5 system, ring8 with one negative
             rate in a sweep, a system whose propensities are all zero,
             one whose reaction changes six species and a budget cut,
             each naming its route and the lanes taken from the ticket;
             the Match kernel on lv8 and ring80 with shared and per-lane
             rates; the dense
             tau-leap window on lv8 (shared and per-lane rates, the
             latter with half the lanes pinned to exact steps), ecoli and
             transport, and with an unreachable leap threshold against
             the exact kernel on lv8; the sparse tau-leap window on ring8
             and ring80, and against the dense tau kernel on ecoli.
3. main    — the dense main path at full width:
             simulate(Experiment(lv8, 2^20 replicas, use_kernel=True)).
3b. sparse — the sparse main path at full width:
             simulate(Experiment(ring80, 2^18 replicas, sparse=True,
             use_kernel=True)); then one window of ring256 at the same
             width, the HBM route, timed alone (rerun bitwise).
3c. match  — the Match entry point `kernels.ops.propensity` at full
             width on the populations that 3b ends with, shared and
             per-lane rates: launches (counter set to 0 just before),
             kernel against twin, times and bound.
3d. tau dense  — tau-leaping at the width and schedule of 3:
             simulate(Experiment(lv8, 2^20 replicas,
             method=Method.TAU_LEAP, use_kernel=True)).
3e. tau sparse — tau-leaping at the width and schedule of 3b:
             simulate(Experiment(ring80, 2^18 replicas, sparse=True,
             method=Method.TAU_LEAP, use_kernel=True)).
             For each main path (3, 3b, 3d, 3e) the kernel's launch
             counter is set to 0 just before and read just after and
             must equal the window count; the records must be finite, a
             second run must repeat them bit for bit, and every window
             mean must agree with a float64 recomputation from the
             pulled observables (rtol 1e-5: the float32 population sums
             exceed 2^24); a tau path must leap. Prints ms per window
             (CUDA events, after a warm-up window), events (tau: solver
             iterations and the leap share) per window, the longest lane
             and the step-slot efficiency of 32 neighbouring lanes run in
             lockstep; for tau, the iterations
             and the window times against the exact path's. Then times
             one full-width kernel launch against its plain twin on the
             same window, with the bound (and, for the sparse exact
             kernel, its route).
4. report  — one JSON line of per-kernel numbers, the card line, then the
             result line.

Exits non-zero, printing no result, without a CUDA device or without
the `src/repro_torch` package beside this script. Imports nothing from
JAX or from the JAX package `repro`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# phase 2: kernels against their plain twins
CHECK_LANES = 65_536
CHECK_SEED = 11
# phase 3: the dense main path at full width
MAIN_MODEL = "lv8"
MAIN_REPLICAS = 1 << 20
MAIN_T_END = 4.0
MAIN_WINDOWS = 8
MAIN_RTOL = 1e-5
# phase 3b: the sparse main path at full width
SPARSE_MODEL = "ring80"
SPARSE_REPLICAS = 1 << 18
SPARSE_T_END = 4.0
SPARSE_WINDOWS = 8
# H100 SXM peaks (NVIDIA data sheet; Hopper white paper for the lanes):
# float32 instructions at 132 SMs x 128 FP32 lanes x 1.98 GHz, an FMA
# being one instruction (the data sheet's 67 TFLOP/s counts it as two);
# int32 at half the lanes (64 INT32 lanes per SM)
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS = 132 * 128 * 1.98e9
PEAK_I32_OPS = 67e12 / 4
# rows between checkpoints of the sparse kernel's a0 fold
# (kernels/csrc/sparse_step.cuh)
CK_ROWS = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean milliseconds of fn() on the current stream over reps runs
    (after the caller's warm-up), timed with CUDA events."""
    import torch

    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def system_of(name):
    """A `MODELS` entry, or one of the phase-2 systems: "coef5" (the
    coefficient-5 pentamer), "quartic" (reactant coefficients 3 and 4,
    dense-capable), "inert" (every propensity zero from the start),
    "wide" (a reaction that changes six species: the sparse kernel's
    general update) and "ring256" (R = 1,792: the sparse kernel's carry
    too large for shared memory)."""
    from repro_torch.core.cwc.compile import cell_ring_model, compile_model
    from repro_torch.core.cwc.models import MODELS, pentamer_system
    from repro_torch.core.reactions import make_system

    if name == "coef5":
        return pentamer_system()
    if name == "quartic":
        return make_system(
            ["A", "B", "C"],
            [({}, {"A": 1}, 20.0), ({"A": 3}, {"B": 1}, 2e-3),
             ({"B": 4}, {"C": 1}, 1e-3), ({"A": 1, "B": 2}, {"C": 1}, 1e-4),
             ({"C": 1}, {}, 0.1), ({"B": 1}, {}, 0.05)],
            {"A": 50, "B": 20})
    if name == "inert":
        return make_system(["A", "B"], [({"A": 2}, {"B": 1}, 1.0),
                                        ({"B": 1}, {}, 0.5)], {"A": 1})
    if name == "wide":
        return make_system(
            ["A", "B", "C", "D", "E", "F"],
            [({}, {"A": 1}, 5.0),
             ({"A": 1}, {"B": 1, "C": 1, "D": 1, "E": 1, "F": 1}, 1.0),
             ({"B": 1}, {}, 0.3), ({"C": 1, "D": 1}, {}, 0.01),
             ({"E": 2}, {"F": 1}, 0.01), ({"F": 1}, {}, 0.2)], {"A": 10})
    if name == "ring256":
        return compile_model(cell_ring_model(256))[0]
    return compile_model(MODELS[name]())[0]


def negative_sweep(system, n_lanes, seed):
    """`sweep_rates` with the rate of the first "dimerise1" reaction
    negated in every lane: its propensity falls below 0 wherever its
    comb factor is not, and the a0 fold's running sum is no longer
    monotone (the sparse kernel must scan such a lane from row 0)."""
    rates = sweep_rates(system, n_lanes, seed)
    j = next(i for i, n in enumerate(system.reaction_names)
             if n.startswith("dimerise1"))
    rates[:, j] = -rates[:, j]
    return rates


def sweep_rates(system, n_lanes, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return (system.rates[None, :] * rng.uniform(
        0.5, 1.5, (n_lanes, system.n_reactions))).astype(np.float32)


def window_inputs(system, n_lanes, seed, per_lane_rates, device):
    """A fresh pool and tensors for one dense window of `system`: the
    kernel argument tuple minus the horizon."""
    import torch

    from repro_torch.core.gillespie import init_lanes, system_tensors

    rates = sweep_rates(system, n_lanes, seed) if per_lane_rates else None
    idx, coef, delta, r = system_tensors(system, rates, device=device)
    pool = init_lanes(system, n_lanes, seed, device=device)
    return (pool.x, pool.t, pool.dead.to(torch.int32), pool.key, pool.ctr,
            pool.ctr_hi, idx, coef, delta, r)


def sparse_inputs(pool, sp, rates):
    """(sparse kernel argument tuple minus the horizon, static keyword
    arguments, the kernel's own bound operands as keyword arguments) for
    one window of `pool`."""
    import torch

    from repro_torch.kernels.ops import bind_sparse_window

    tb = bind_sparse_window(sp, rates)
    args = (pool.x, pool.t, pool.dead.to(torch.int32), pool.key, pool.ctr,
            pool.ctr_hi, *tb[:5])
    return args, dict(max_c=tb.max_c, d=tb.d, k=tb.k,
                      packed_rates=tb.packed_rates), dict(dep_lo=tb.dep_lo,
                                                          packed=tb.packed)


def tau_inputs(system, n_lanes, seed, per_lane_rates, sparse, device,
               no_leap=False):
    """(tau kernel argument tuple minus the horizon, max_c) for one window
    of a fresh pool of `system`; `no_leap` pins every other lane to exact
    steps."""
    import torch

    from repro_torch.core.gillespie import init_lanes
    from repro_torch.core.tau_leap import tau_tables

    pool = init_lanes(system, n_lanes, seed, device=device)
    tb = tau_tables(system, sparse=sparse, device=device)
    rates = torch.as_tensor(sweep_rates(system, n_lanes, seed)
                            if per_lane_rates else system.rates, device=device)
    nl = (torch.arange(n_lanes, device=device) % 2 if no_leap
          else torch.zeros(n_lanes, device=device)).to(torch.int32)
    return (pool.x, pool.t, pool.dead.to(torch.int32), nl, pool.key,
            pool.ctr, pool.ctr_hi, *tb[:6], rates, tb.gi, tb.rmask), tb.max_c


def bitwise_diff(outs_a, outs_b) -> tuple[int, float]:
    """(number of differing elements, max abs difference) over two
    tuples of tensors of the same shapes."""
    import torch

    n_diff, err = 0, 0.0
    for a, b in zip(outs_a, outs_b):
        if a.dtype == torch.float32:
            n_diff += int((a.view(torch.int32) != b.view(torch.int32)).sum())
            err = max(err, float((a.double() - b.double()).abs().max()))
        else:
            n_diff += int((a != b).sum())
            err = max(err, float((a.long() - b.long()).abs().max()))
    return n_diff, err


def slot_ops(coef_row) -> int:
    """Float instructions of one reaction's rate-times-slots product:
    one multiply for a slot with c = 1; c-1 subtractions, c-1 multiplies,
    the division by c! and the multiply into the product for c > 1."""
    return int(sum(1 if c == 1 else 2 * c for c in coef_row if c > 0))


#: float32 instructions per active lane step besides the Match and a0:
#: log_f32 (11 FMAs and 11 other operations), the uniforms (sub 1 and
#: max U_MIN each), the resolve (negate, max(a0, 1e-30), divide,
#: t + tau, two compares)
F_LOG, F_UNIFORMS, F_RESOLVE = 22, 4, 6
#: int32 per active lane step: threefry's 20 rounds of add, rotate and
#: xor (60), 2 initial key adds and 5 injections of 2 adds (12), the
#: uniforms' bit moves (4), the log's exponent and mantissa bits (4), the
#: counter bump (2). The key schedule is fixed for a lane and hoisted.
I_STEP = 82


def dep_match(system, tables) -> list[int]:
    """Float instructions of the Match of each reaction's dependency rows
    (`slot_ops` of every row of dep(j)), by j."""
    r = system.n_reactions
    coef = system.reactant_coef
    return [sum(slot_ops(coef[q]) for q in deps if q < r)
            for deps in tables.dep_idx[:-1]]


def ops_per_step(system, tables) -> dict:
    """The least work the dense direct-method SSA with dependency-graph
    updates needs, counted from kernels/csrc/ssa_window.cu: float32
    instructions per active lane step (`step`: a0's R-1 adds, the log,
    the uniforms, the resolve), per fired event (`fired`) and per lane
    and launch (`seed`: the Match of every reaction), and int32
    instructions per active lane step (`i_step`). An FMA counts 1.

    The scan and the update depend on the reaction that fires, which the
    run does not record, so each fired event is charged the least over j
    of: the threshold multiply, one compare of the scan, the adds of j's
    nonzero delta entries and the Match of j's dependency rows."""
    nnz = (system.delta != 0).sum(axis=1)
    fired = min(2 + int(n) + m for n, m in zip(nnz, dep_match(system,
                                                              tables)))
    return dict(step=system.n_reactions - 1 + F_LOG + F_UNIFORMS + F_RESOLVE,
                fired=fired,
                seed=sum(slot_ops(row) for row in system.reactant_coef),
                i_step=I_STEP)


def sparse_ops(system, tables) -> dict:
    """The least work of the sparse step, counted from
    kernels/csrc/sparse_step.cuh: float32 instructions per active lane
    step besides a0 (`step`: the log, the uniforms, the resolve), per
    fired event (`fired`: the least over j of the threshold multiply, the
    scan's one add and one compare, the adds of j's nonzero delta entries
    and the Match of j's dependency rows) and per lane and launch
    (`seed`: the Match of every reaction); a0's adds, R-1 for a lane's
    first active step in a launch (`first_fold`) and, for every later
    one, the refold from the checkpoint at or below the lowest row of
    dep(j), least over j (`refold`); int32 per active lane step
    (`i_step`)."""
    import numpy as np

    r = system.n_reactions
    nnz = (system.delta != 0).sum(axis=1)
    fired = min(3 + int(n) + m for n, m in zip(nnz, dep_match(system,
                                                              tables)))
    lo = np.minimum(tables.dep_idx[:-1].min(axis=1), r - 1)
    refold = int((r - lo // CK_ROWS * CK_ROWS).min())
    return dict(step=F_LOG + F_UNIFORMS + F_RESOLVE, fired=fired,
                seed=sum(slot_ops(row) for row in system.reactant_coef),
                first_fold=r - 1, refold=refold, i_step=I_STEP)


#: float32 instructions of exp_f32 (2 clamps, floor, 2 more clamps, 8
#: FMAs, the square, the add of 1, the scaling multiply)
F_EXP = 17
#: int32 instructions per counter block of a leap attempt: threefry (72),
#: the counter add and carry (2), the uniforms' bits (4)
I_BLOCK = 78


def tau_ops(system, tables) -> dict:
    """The least work of one tau-leap iteration, counted from
    kernels/csrc/tau_step.cuh (both tau kernels run it): float32
    instructions per active iteration (`iter`), per accepted leap
    (`leap`), per exact sub-step (`exact`) and per fired exact event
    (`fired`); int32 instructions per accepted leap (`i_leap`) and per
    exact sub-step (`i_exact`). An FMA counts 1.

    Per iteration: the Match, a0's and max a_j's R-1 operations each,
    and per consumed species the Cao sums (mu: multiply and add, sig2:
    the square, multiply and add, per nonzero of its delta column), the
    g_i terms (subtract, max, divide, add per nonzero coefficient row),
    bnd (3), r1 (3), r2 (3) and the two minima; then tau (6). Per
    accepted leap, its least: one attempt (the run does not record
    rejected ones), each reaction's lam, exp_f32 and one cdf compare (the
    Poisson terms past the first depend on the draws, which the run does
    not record), the check and the update of x (an add and a multiply
    per nonzero, an add and a compare per species), the clock (2); and
    ceil(R/2) counter blocks. Per exact sub-step: the log, the uniforms
    and the resolve, and one counter block with its bump; per fired
    event the threshold, one scan add and compare and the fewest
    nonzero entries of a delta row."""
    import numpy as np

    r = system.n_reactions
    coef = system.reactant_coef
    nnz_col = (np.asarray(tables.col_j.cpu()) < r).sum(axis=1)
    gi = np.asarray(tables.gi.cpu())
    consumed = np.asarray(tables.rmask.cpu()) > 0
    cao = sum(5 * int(nnz_col[i]) + 4 * int((gi[1:, i] != 0).sum()) + 11
              for i in np.nonzero(consumed)[0])
    f_iter = (sum(slot_ops(row) for row in coef) + 2 * (r - 1) + cao + 6)
    nnz = int(nnz_col.sum())
    s = system.n_species
    f_leap = r * (1 + F_EXP + 1) + 2 * (2 * nnz + 2 * s) + 2
    n_pairs = (r + 1) // 2
    nnz_row = int((system.delta != 0).sum(axis=1).min())
    return dict(iter=f_iter, leap=f_leap,
                exact=F_LOG + F_UNIFORMS + F_RESOLVE, fired=3 + nnz_row,
                i_leap=n_pairs * I_BLOCK + 2, i_exact=I_STEP)


def pool_bytes(b, s) -> int:
    """Bytes of a window's pool read and written once: x in and out, t,
    dead, ctr, ctr_hi in and out, the key in, the steps out."""
    return b * (2 * 4 * s + 2 * 4 + 2 * 4 + 8 + 2 * 4 + 2 * 4 + 4)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_of(n_bytes, f_ops, i_ops) -> tuple[float, str, str]:
    """(bound ms, "bytes" or "operations", detail) for a kernel's work."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_f = f_ops / PEAK_F32_OPS * 1e3
    t_i = i_ops / PEAK_I32_OPS * 1e3
    bound = max(t_bytes, t_f, t_i)
    detail = (f"bytes {t_bytes:.4f}, f32 ops {t_f:.4f}, int32 ops "
              f"{t_i:.4f} ms")
    return bound, ("bytes" if t_bytes >= max(t_f, t_i)
                   else "operations"), detail


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.build()
    log(f"[build] kernel library from {len(build.sources())} sources built "
        f"in {time.perf_counter() - t0:.2f} s: {lib.name}")
    for line in build.build_log().splitlines():
        if line.startswith("==") or any(
                w in line for w in ("registers", "spill", "error",
                                    "stack frame")):
            log(f"[build] {line.strip()}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_kernels(device) -> dict:
    """Each kernel against its plain twin, bitwise. Returns the max abs
    error per kernel name."""
    import numpy as np
    import torch

    from repro_torch.core.gillespie import (
        init_lanes,
        sparse_system_tensors,
        system_tensors,
    )
    from repro_torch.core.reactions import sparse_tables
    from repro_torch.kernels.ops import propensity, system_kernel_tensors
    from repro_torch.kernels.propensity import propensity_plain
    from repro_torch.kernels.ssa_step import (
        sparse_tau_window_call,
        sparse_tau_window_plain,
        sparse_window_call,
        sparse_window_plain,
        sparse_window_route,
        ssa_window_call,
        ssa_window_plain,
        tau_window_call,
        tau_window_plain,
    )

    budget = 256 * 64
    worst = {"ssa_window": 0.0, "sparse_window": 0.0, "propensity": 0.0,
             "tau_window": 0.0, "sparse_tau_window": 0.0}

    def check(kernel, label, outs_k, outs_p, horizon, n_steps):
        n_diff, err = bitwise_diff(outs_k, outs_p)
        live_k = bool(((outs_k[1] < horizon) & (outs_k[2] == 0)).any())
        live_p = bool(((outs_p[1] < horizon) & (outs_p[2] == 0)).any())
        log(f"[kernels] {kernel} {label} n_steps={n_steps}: "
            f"{int(outs_k[3].sum())} events, truncated={live_k}/{live_p}, "
            f"{n_diff} differing elements, max abs err {err:g}")
        if n_diff or live_k != live_p:
            raise AssertionError(f"{kernel} and its twin disagree: {label}")
        if (n_steps < budget) != live_k:
            raise AssertionError(f"unexpected truncation state: {label}")
        worst[kernel] = max(worst[kernel], err)

    dense_cases = [  # (model, per-lane rates, horizon, n_steps)
        ("lv8", True, 0.5, budget),
        ("ecoli", False, 2.0, budget),
        ("transport", True, 2.0, budget),
        ("lv8", False, 0.5, 48),  # budget cut: lanes still live
        ("quartic", True, 1.0, budget),  # coefficients 3, 4: __fdiv_rn
    ]
    for name, per_lane, horizon, n_steps in dense_cases:
        args = window_inputs(system_of(name), CHECK_LANES, CHECK_SEED,
                             per_lane, device)
        k = ssa_window_call(*args, horizon, n_steps=n_steps)
        p = ssa_window_plain(*args, horizon, n_steps=n_steps)
        check("ssa_window", f"{name} B={CHECK_LANES} rates="
              f"{'(B,R)' if per_lane else '(R,)'}", k, p, horizon, n_steps)

    sparse_cases = [  # (model, rates, horizon, n_steps, lanes)
        ("ring80", "(R,)", 0.25, budget, CHECK_LANES),
        ("lattice8x8", "(B,R)", 0.25, budget, CHECK_LANES),
        ("ring256", "(R,)", 0.05, budget, CHECK_LANES),  # HBM route
        ("ecoli", "(R,)", 2.0, budget, CHECK_LANES),
        ("coef5", "(R,)", 0.5, budget, CHECK_LANES),  # sparse only
        ("ring8", "negative", 0.25, budget, CHECK_LANES),
        ("inert", "(R,)", 1.0, budget, CHECK_LANES),  # every lane dead
        ("wide", "(B,R)", 2.0, budget, CHECK_LANES),  # D = 6 changes
        ("ring80", "(B,R)", 0.25, 48, CHECK_LANES),  # budget cut
    ]
    for name, kind, horizon, n_steps, lanes in sparse_cases:
        system = system_of(name)
        pool = init_lanes(system, lanes, CHECK_SEED, device=device)
        sp = sparse_system_tensors(sparse_tables(system), device=device)
        rates = torch.as_tensor(
            system.rates if kind == "(R,)" else
            sweep_rates(system, lanes, CHECK_SEED) if kind == "(B,R)" else
            negative_sweep(system, lanes, CHECK_SEED), device=device)
        args, static, bound = sparse_inputs(pool, sp, rates)
        k = sparse_window_call(*args, horizon, n_steps=n_steps, **bound,
                               **static)
        p = sparse_window_plain(*args, horizon, n_steps=n_steps, **static)
        ticket = lanes - sparse_window_call.grid_lanes
        route, threads = sparse_window_route(system.n_reactions)
        label = (f"{name} S={system.n_species} R={system.n_reactions} "
                 f"B={lanes} rates={kind} route={route} ({threads} lanes "
                 f"a block, {ticket} lanes from the ticket)")
        check("sparse_window", label, k, p, horizon, n_steps)
        if name == "ring256" and not ticket:  # one wave held every lane
            raise AssertionError("sparse_window: the HBM route's check "
                                 "took no lane from the ticket")
        if name == "inert" and int(k[2].sum()) != lanes:
            raise AssertionError("sparse_window: inert lanes not all dead")
        if name == "ecoli":  # the sparse kernel against the dense one
            d = ssa_window_call(*args[:6], *system_tensors(system,
                                                           device=device),
                                horizon, n_steps=n_steps)
            n_diff, _ = bitwise_diff(k, d)
            log(f"[kernels] sparse_window vs ssa_window {label}: {n_diff} "
                f"differing elements")
            if n_diff:
                raise AssertionError("sparse and dense kernels disagree")

    rng = np.random.default_rng(CHECK_SEED)
    for name in ("lv8", "ring80"):
        system = system_of(name)
        tens = system_kernel_tensors(system, device=device)
        x = torch.as_tensor(rng.integers(0, 300, (
            CHECK_LANES, system.n_species)).astype(np.float32), device=device)
        for per_lane in (False, True):
            rates = torch.as_tensor(
                sweep_rates(system, CHECK_LANES, CHECK_SEED) if per_lane
                else system.rates, device=device)
            k = propensity(x, tens, rates)
            p = propensity_plain(x, tens[0], tens[1], rates)
            n_diff, err = bitwise_diff((k,), (p,))
            log(f"[kernels] propensity {name} B={CHECK_LANES} rates="
                f"{'(B,R)' if per_lane else '(R,)'}: {n_diff} differing "
                f"elements, max abs err {err:g}")
            if n_diff:
                raise AssertionError(f"propensity and its twin disagree: "
                                     f"{name}")
            worst["propensity"] = max(worst["propensity"], err)

    tau_cases = [  # (model, per-lane rates, no_leap half, horizon)
        ("lv8", False, False, 0.5),
        ("lv8", True, True, 0.5),
        ("ecoli", False, False, 50.0),
        ("transport", True, False, 2.0),
    ]
    for name, per_lane, no_leap, horizon in tau_cases:
        system = system_of(name)
        args, _ = tau_inputs(system, CHECK_LANES, CHECK_SEED, per_lane, False,
                             device, no_leap)
        kw = dict(n_steps=budget, eps=0.03, fallback=10.0)
        k = tau_window_call(*args, horizon, **kw)
        p = tau_window_plain(*args, horizon, **kw)
        check("tau_window", f"{name} B={CHECK_LANES} rates="
              f"{'(B,R)' if per_lane else '(R,)'}"
              f"{' no_leap=half' if no_leap else ''}, {int(k[4].sum())} "
              f"leaps,", k, p, horizon, budget)
    # an unreachable leap threshold: the exact kernel's window
    system = system_of("lv8")
    args, _ = tau_inputs(system, CHECK_LANES, CHECK_SEED, False, False,
                         device)
    k = tau_window_call(*args, 0.5, n_steps=budget, eps=0.03,
                        fallback=float("inf"))
    d = ssa_window_call(*args[:3], *args[4:7],
                        *system_tensors(system, device=device), 0.5,
                        n_steps=budget)
    n_diff, _ = bitwise_diff((*k[:4], *k[5:7]), d)
    log(f"[kernels] tau_window fallback=inf vs ssa_window lv8 B="
        f"{CHECK_LANES}: {int(k[4].sum())} leaps, {n_diff} differing "
        f"elements")
    if n_diff or int(k[4].sum()):
        raise AssertionError("tau kernel without leaps and exact kernel "
                             "disagree")

    sparse_tau_cases = [  # (model, fallback, horizon)
        ("ring8", 3.0, 0.5),  # ring8 leaps only below the default 10
        ("ring80", 10.0, 0.5),
        ("ecoli", 10.0, 50.0),
    ]
    for name, fallback, horizon in sparse_tau_cases:
        system = system_of(name)
        args, max_c = tau_inputs(system, CHECK_LANES, CHECK_SEED, False, True,
                                 device)
        kw = dict(n_steps=budget, eps=0.03, fallback=fallback)
        k = sparse_tau_window_call(*args, horizon, max_c=max_c, **kw)
        p = sparse_tau_window_plain(*args, horizon, max_c=max_c, **kw)
        label = (f"{name} S={system.n_species} R={system.n_reactions} "
                 f"B={CHECK_LANES} fallback={fallback:g}, "
                 f"{int(k[4].sum())} leaps,")
        check("sparse_tau_window", label, k, p, horizon, budget)
        if name == "ecoli":  # the sparse tau kernel against the dense one
            d = tau_window_call(*args, horizon, **kw)
            n_diff, _ = bitwise_diff(k, d)
            log(f"[kernels] sparse_tau_window vs tau_window {label}: "
                f"{n_diff} differing elements")
            if n_diff:
                raise AssertionError("sparse and dense tau kernels disagree")
    return worst


def drive_main(exp, counter, label, device) -> tuple[dict, float]:
    """Drive one main path through `simulate` at full width and check
    it. `counter` is the kernel wrapper whose `.launches` the path must
    bump once per window: set to 0 just before the timed run and read
    just after. Returns (numbers for the report, first timed window's
    ms)."""
    import numpy as np

    from repro_torch.api import Method, simulate

    tau = exp.method is Method.TAU_LEAP
    n_windows = exp.schedule.n_windows
    counter.launches = 0
    t0 = time.perf_counter()
    res = simulate(exp, device=device, max_windows=1)  # warm-up window
    eng = res._engine
    win_ms, lane_max, warp_eff = [], [], []
    while not res.completed:
        # an exact step consumes one counter block; a tau lane's solver
        # iterations are its steps
        work0 = eng._pool.steps if tau else eng._pool.ctr
        win_ms.append(cuda_ms(lambda: res.resume(max_windows=1)))
        # per-lane work this window, read outside the timed span: the
        # longest lane, and the share of the step slots that did work if
        # each 32 neighbouring lanes ran as one warp to their longest
        # lane (the tau kernels' mapping; the exact kernels hand lanes to
        # warps dynamically, so for them this is the lockstep they avoid)
        work = eng._pool.steps if tau else eng._pool.ctr
        used = (work.long() - work0.long()) & 0xFFFFFFFF
        lane_max.append(int(used.max()))
        warp_eff.append(float(used.sum()) / float(
            32 * used.view(-1, 32).max(dim=1).values.sum()))
    wall = time.perf_counter() - t0
    launches = counter.launches
    recs = res.records
    steps = res.telemetry.steps_per_window
    leaps = res.telemetry.leaps_per_window
    pool_mb = sum(t.numel() * t.element_size() for t in eng._pool) / 1e6
    n = exp.ensemble.n_instances
    what = "solver iterations" if tau else "events"
    log(f"[{label}] {eng.system.n_species} species, "
        f"{eng.system.n_reactions} reactions x {n} lanes, {n_windows} "
        f"windows to t={exp.schedule.t_end}: {launches} kernel launches, "
        f"{wall:.2f} s wall, pool {pool_mb:.1f} MB on the device")
    log(f"[{label}] {what} per window: {list(steps)}")
    if tau:
        log(f"[{label}] accepted leaps per window: {list(leaps)}; leap "
            f"share {[round(lp / max(st, 1), 4) for lp, st in zip(leaps, steps)]}")
    timed = sum(steps[1:])
    log(f"[{label}] ms per window after warm-up: "
        f"{[round(m, 3) for m in win_ms]}; mean {np.mean(win_ms):.3f} ms, "
        f"{timed / (sum(win_ms) / 1e3):.4g} {what}/s")
    log(f"[{label}] longest lane's {'steps' if tau else 'active steps'} per "
        f"window after warm-up: {lane_max} (budget "
        f"{exp.kernel_chunk_steps * exp.kernel_max_chunks}); warp "
        f"step-slot efficiency of 32 neighbouring lanes "
        f"{[round(e, 4) for e in warp_eff]}")
    if launches != n_windows:
        raise AssertionError(f"{label}: {launches} kernel launches for "
                             f"{n_windows} windows")
    if tau and not sum(leaps) > 0:
        raise AssertionError(f"{label}: the tau-leap path never leaped")
    means = np.stack([r.mean for r in recs])
    if len(recs) != n_windows or not all(
            np.isfinite(v).all() for r in recs
            for v in (r.mean, r.var, r.ci90)):
        raise AssertionError(f"{label}: records missing or not finite")

    # checked run: same seed, observables pulled every window
    res2 = simulate(exp.with_(record_trajectories=True), device=device)
    means2 = np.stack([r.mean for r in res2.records])
    if means.tobytes() != means2.tobytes():
        raise AssertionError(f"{label}: a second run gave different means")
    traj = res2.trajectories()  # (I, T, n_obs)
    ref = traj.astype(np.float64).mean(axis=0)
    rel = float(np.max(np.abs(means2 - ref) / np.maximum(np.abs(ref), 1)))
    log(f"[{label}] record means vs float64 recomputation: max rel err "
        f"{rel:.3g} (tolerance {MAIN_RTOL:g}); rerun bitwise equal")
    if not rel <= MAIN_RTOL:
        raise AssertionError(f"{label}: record means disagree with float64")
    return dict(launches=launches, final_x=res2._engine._pool.x,
                steps=list(steps), win_ms=win_ms), win_ms[0]


def time_against_twin(label, launch, plain, reps=5):
    """(kernel ms, twin ms, kernel outputs, twin outputs) of one
    full-width launch; the kernel is warmed up first."""
    launch()
    k_ms = cuda_ms(launch, reps=reps)
    out = launch()
    p_out = [None]

    def run_plain():
        p_out[0] = plain()

    p_ms = cuda_ms(run_plain)
    n_diff, err = bitwise_diff(out, p_out[0])
    if n_diff:
        raise AssertionError(f"{label}: full-width kernel and plain twin "
                             f"disagree in {n_diff} elements")
    return k_ms, p_ms, out, err


def phase_main(device) -> dict:
    """The dense main path at full width; returns the report numbers."""
    import numpy as np
    import torch

    from repro_torch.api import Ensemble, Experiment, Schedule, build_engine
    from repro_torch.core.cwc.models import MODELS
    from repro_torch.core.reactions import sparse_tables
    from repro_torch.kernels.ssa_step import (
        dense_dep_mask,
        ssa_window_call,
        ssa_window_plain,
    )

    exp = Experiment(model=MODELS[MAIN_MODEL](),
                     ensemble=Ensemble.make(replicas=MAIN_REPLICAS),
                     schedule=Schedule(t_end=MAIN_T_END,
                                       n_windows=MAIN_WINDOWS),
                     n_lanes=1024, use_kernel=True)
    nums, win0_ms = drive_main(exp, ssa_window_call, "main", device)

    # one full-width launch of a main-path window: kernel vs plain twin
    eng = build_engine(exp, device=device)
    eng.run_window()
    pool = eng._pool
    idx, coef, delta, _ = eng._tensors_base
    args = (pool.x, pool.t, pool.dead.to(torch.int32), pool.key, pool.ctr,
            pool.ctr_hi, idx, coef, delta, eng._rates_dev)
    horizon = float(np.float32(eng.grid[1]))
    n_steps = exp.kernel_chunk_steps * exp.kernel_max_chunks
    k_ms, p_ms, out, err = time_against_twin(
        "main", lambda: ssa_window_call(*args, horizon, n_steps=n_steps),
        lambda: ssa_window_plain(*args, horizon, n_steps=n_steps))
    active = int(((out[4].long() - pool.ctr.long()) & 0xFFFFFFFF).sum())
    fired = int(out[3].sum())
    ops = ops_per_step(eng.system, sparse_tables(eng.system))
    b, s = pool.x.shape
    n_bytes = pool_bytes(b, s) + nbytes(idx, coef, delta, eng._rates_dev,
                                        dense_dep_mask(idx, coef, delta))
    bound, by, detail = bound_of(
        n_bytes, active * ops["step"] + fired * ops["fired"]
        + b * ops["seed"], active * ops["i_step"])
    log(f"[main] one window at full width: kernel {k_ms:.3f} ms, plain "
        f"twin {p_ms:.1f} ms, 0 differing elements; {active} active lane "
        f"steps, {fired} events; bound {bound:.4f} ms ({detail}); the "
        f"same window took {win0_ms:.3f} ms end to end, kernel share "
        f"{k_ms / win0_ms:.4f}")
    return dict(launches=nums["launches"], ms=k_ms, plain_ms=p_ms,
                bound_ms=bound, bound_by=by, err=err, steps=nums["steps"],
                win_ms=nums["win_ms"])


def sparse_experiment(model):
    """The sparse main path's experiment (phase 3b) for `model`."""
    from repro_torch.api import Ensemble, Experiment, Schedule

    return Experiment(model=model,
                      ensemble=Ensemble.make(replicas=SPARSE_REPLICAS),
                      schedule=Schedule(t_end=SPARSE_T_END,
                                        n_windows=SPARSE_WINDOWS),
                      n_lanes=1024, sparse=True, use_kernel=True)


def sparse_full_width(exp, label, device, twin: bool) -> dict:
    """One full-width launch of the sparse kernel on window 2 of `exp`,
    timed after a warm-up launch, with its bound, its route and the lanes
    its grid took from the ticket; with `twin`, against its plain twin
    (else against the warm-up launch, bit for bit)."""
    import numpy as np

    from repro_torch.api import build_engine
    from repro_torch.core.reactions import sparse_tables
    from repro_torch.kernels.ssa_step import (
        sparse_window_call,
        sparse_window_plain,
        sparse_window_route,
    )

    eng = build_engine(exp, device=device)
    eng.run_window()
    pool = eng._pool
    args, static, bound = sparse_inputs(pool, eng._sparse_tensors,
                                        eng._rates_dev)
    horizon = float(np.float32(eng.grid[1]))
    n_steps = exp.kernel_chunk_steps * exp.kernel_max_chunks

    def launch():
        return sparse_window_call(*args, horizon, n_steps=n_steps, **bound,
                                  **static)

    if twin:
        k_ms, p_ms, out, err = time_against_twin(
            label, launch, lambda: sparse_window_plain(
                *args, horizon, n_steps=n_steps, **static), reps=3)
        against = f"plain twin {p_ms:.1f} ms"
    else:
        first = launch()
        k_ms = cuda_ms(launch)
        out = launch()
        n_diff, err = bitwise_diff(out, first)
        if n_diff:
            raise AssertionError(f"{label}: reruns of one window differ")
        p_ms, against = None, "rerun"
    ticket = pool.x.shape[0] - sparse_window_call.grid_lanes
    used = (out[4].long() - pool.ctr.long()) & 0xFFFFFFFF
    active, lanes_active = int(used.sum()), int((used > 0).sum())
    fired = int(out[3].sum())
    system = eng.system
    ops = sparse_ops(system, sparse_tables(system))
    b, s = pool.x.shape
    r = system.n_reactions
    # the tables the kernel reads: rates, dep_lo, slots and recipes
    n_bytes = pool_bytes(b, s) + nbytes(args[10], bound["dep_lo"],
                                        *bound["packed"])
    folds = (lanes_active * ops["first_fold"]
             + (active - lanes_active) * ops["refold"])
    bound_ms, by, detail = bound_of(
        n_bytes, active * ops["step"] + folds + fired * ops["fired"]
        + b * ops["seed"], active * ops["i_step"])
    route, threads = sparse_window_route(r)
    log(f"[{label}] S={s} R={r} B={b}, one window at full width: kernel "
        f"{k_ms:.3f} ms, {against}, 0 differing elements; {active} active "
        f"lane steps, {fired} events; bound {bound_ms:.4f} ms ({detail})")
    log(f"[{label}] route {route}: {threads} lanes a block, each lane's "
        f"carry ({r} propensities, {-(-r // CK_ROWS)} checkpoints) "
        f"{'in shared memory' if route != 'hbm' else 'in HBM scratch'}; "
        f"{ticket} of {b} lanes from the ticket; a0 refolds at least "
        f"{ops['refold']} of {r} rows after an event")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=by,
                err=err, system=system)


def phase_sparse(device) -> dict:
    """The sparse main path at full width; returns the report numbers.
    Then one full-width window of ring256, whose carry takes the HBM
    route, timed alone."""
    from repro_torch.core.cwc.compile import cell_ring_model
    from repro_torch.core.cwc.models import MODELS
    from repro_torch.kernels.ssa_step import sparse_window_call

    exp = sparse_experiment(MODELS[SPARSE_MODEL]())
    nums, win0_ms = drive_main(exp, sparse_window_call, "sparse", device)
    one = sparse_full_width(exp, "sparse", device, twin=True)
    log(f"[sparse] the same window took {win0_ms:.3f} ms end to end, "
        f"kernel share {one['ms'] / win0_ms:.4f}")
    sparse_full_width(sparse_experiment(cell_ring_model(256)),
                      "sparse ring256", device, twin=False)
    return dict(one, launches=nums["launches"], final_x=nums["final_x"],
                steps=nums["steps"], win_ms=nums["win_ms"])


def phase_match(device, x, system) -> dict:
    """The Match entry point at full width on the populations `x` of the
    sparse main path's last window, shared and per-lane rates."""
    import torch

    from repro_torch.kernels.ops import propensity, system_kernel_tensors
    from repro_torch.kernels.propensity import (
        propensity_call,
        propensity_plain,
    )

    tens = system_kernel_tensors(system, device=device)
    b, s = x.shape
    r = system.n_reactions
    shared = torch.as_tensor(system.rates, device=device)
    per_lane = torch.as_tensor(sweep_rates(system, b, CHECK_SEED),
                               device=device)
    propensity_call.launches = 0
    outs = [propensity(x, tens, rates) for rates in (shared, per_lane)]
    launches = propensity_call.launches
    if launches != 2:
        raise AssertionError(f"match: {launches} launches for 2 calls")
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError("match: propensities not finite")
    f_ops = b * sum(slot_ops(row) + 1 for row in system.reactant_coef)
    nums = {}
    for label, rates in (("(R,)", shared), ("(B,R)", per_lane)):
        k_ms, p_ms, _, err = time_against_twin(
            f"match {label}", lambda: (propensity(x, tens, rates),),
            lambda: (propensity_plain(x, tens[0], tens[1], rates),))
        n_bytes = nbytes(x, rates, tens[0], tens[1]) + b * r * 4
        bound, by, detail = bound_of(n_bytes, f_ops, 0)
        log(f"[match] propensity {SPARSE_MODEL} B={b} S={s} R={r} rates="
            f"{label}: kernel {k_ms:.4f} ms, plain twin {p_ms:.3f} ms, 0 "
            f"differing elements; bound {bound:.4f} ms ({detail})")
        nums[label] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                           bound_by=by, err=err)
    out = dict(nums["(R,)"], launches=launches)
    out["err"] = max(v["err"] for v in nums.values())
    return out


def phase_tau(device, sparse: bool, exact: dict) -> dict:
    """Tau-leaping at full width, the model, width and schedule of the
    exact path `exact` (phase 3 or 3b): launches, checks, the iterations
    and window times against the exact path's, and one full-width window
    of the kernel against its plain twin with the bound."""
    import numpy as np
    import torch

    from repro_torch.api import (
        Ensemble,
        Experiment,
        Method,
        Schedule,
        build_engine,
    )
    from repro_torch.core.cwc.models import MODELS
    from repro_torch.kernels import ssa_step

    name, replicas, t_end, n_windows = (
        (SPARSE_MODEL, SPARSE_REPLICAS, SPARSE_T_END, SPARSE_WINDOWS)
        if sparse else (MAIN_MODEL, MAIN_REPLICAS, MAIN_T_END, MAIN_WINDOWS))
    label = "tau sparse" if sparse else "tau dense"
    call, plain = ((ssa_step.sparse_tau_window_call,
                    ssa_step.sparse_tau_window_plain) if sparse else
                   (ssa_step.tau_window_call, ssa_step.tau_window_plain))
    exp = Experiment(model=MODELS[name](),
                     ensemble=Ensemble.make(replicas=replicas),
                     schedule=Schedule(t_end=t_end, n_windows=n_windows),
                     n_lanes=1024, sparse=sparse, use_kernel=True,
                     method=Method.TAU_LEAP)
    nums, win0_ms = drive_main(exp, call, label, device)
    ratio = [round(a / max(b, 1), 4) for a, b in zip(nums["steps"],
                                                      exact["steps"])]
    t_ratio = [round(a / b, 4) for a, b in zip(nums["win_ms"],
                                               exact["win_ms"])]
    log(f"[{label}] solver iterations / the exact path's events per "
        f"window: {ratio}; window ms / the exact path's (windows 2-"
        f"{n_windows}): {t_ratio}")

    # one full-width launch of a main-path window: kernel vs plain twin
    eng = build_engine(exp, device=device)
    eng.run_window()
    pool, tb = eng._pool, eng._tau_tables
    args = (pool.x, pool.t, pool.dead.to(torch.int32),
            pool.no_leap.to(torch.int32), pool.key, pool.ctr,
            pool.ctr_hi, *tb[:6], eng._rates_dev, tb.gi, tb.rmask)
    horizon = float(np.float32(eng.grid[1]))
    kw = dict(n_steps=exp.kernel_chunk_steps * exp.kernel_max_chunks,
              eps=exp.tau_eps, fallback=exp.tau_fallback,
              **({"max_c": tb.max_c} if sparse else {}))
    k_ms, p_ms, out, err = time_against_twin(
        label, lambda: call(*args, horizon, **kw),
        lambda: plain(*args, horizon, **kw), reps=3)
    iters, leaps = int(out[7].sum()), int(out[4].sum())
    fired = int(out[3].sum()) - leaps
    ops = tau_ops(eng.system, tb)
    b, s = pool.x.shape
    # the pool in and out, no_leap in, leaps and iterations out, tables
    n_bytes = pool_bytes(b, s) + b * 12 + nbytes(*args[7:])
    bound, by, detail = bound_of(
        n_bytes, iters * ops["iter"] + leaps * ops["leap"]
        + (iters - leaps) * ops["exact"] + fired * ops["fired"],
        leaps * ops["i_leap"] + (iters - leaps) * ops["i_exact"])
    log(f"[{label}] one window at full width: kernel {k_ms:.3f} ms, plain "
        f"twin {p_ms:.1f} ms, 0 differing elements; {iters} active lane "
        f"iterations, {leaps} leaps, {fired} exact events; bound "
        f"{bound:.4f} ms ({detail}); the same window took {win0_ms:.3f} ms "
        f"end to end, kernel share {k_ms / win0_ms:.4f}")
    return dict(launches=nums["launches"], ms=k_ms, plain_ms=p_ms,
                bound_ms=bound, bound_by=by, err=err)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the "
              "card only", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the repro_torch package is missing under "
              f"{SRC}; run this script from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phase_build()
    card = card_line()
    log(card)  # name and power limit, as nvidia-smi prints them
    worst = phase_kernels(device)
    dense = phase_main(device)
    sparse = phase_sparse(device)
    match = phase_match(device, sparse.pop("final_x"), sparse.pop("system"))
    tau_dense = phase_tau(device, False, dense)
    tau_sparse = phase_tau(device, True, sparse)
    entries = [
        ("ssa_window", "ssa_window.cu", "src/repro/kernels/ssa_step.py:64",
         dense),
        ("sparse_window", "sparse_window.cu",
         "src/repro/kernels/ssa_step.py:291", sparse),
        ("propensity", "propensity.cu", "src/repro/kernels/propensity.py:72",
         match),
        ("tau_window", "tau_window.cu", "src/repro/kernels/ssa_step.py:178",
         tau_dense),
        ("sparse_tau_window", "sparse_tau_window.cu",
         "src/repro/kernels/ssa_step.py:423", tau_sparse),
    ]
    report = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": replaces,
        "launches": nums["launches"],
        "max_abs_err": max(worst[name], nums["err"]),
        "ms": nums["ms"],
        "plain_ms": nums["plain_ms"],
        "bound_ms": nums["bound_ms"],
        "bound_by": nums["bound_by"],
        "library_ms": None,
    } for name, src, replaces, nums in entries]}
    log("[report] library_ms is null for all five: no single PyTorch call "
        "computes an SSA or tau-leap window (a loop of draws, sums, Poisson "
        "inversions and data-dependent updates), and none computes a "
        "mass-action Match (a product of binomial factors over gathered "
        "populations)")
    log(f"[done] all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps(report))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
