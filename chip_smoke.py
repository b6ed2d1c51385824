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
             rates, on a ragged last tile, fewer lanes than a tile, R = 9,
             populations that are negative, NaN, 2^24 and above or
             infinite, coefficients 3 to 7, operands off 16 bytes, and
             on the "global" route M = 6 and a 70,000-species table, each
             naming its route and tile; the dense
             tau-leap window on lv8 (shared and per-lane rates, the
             latter with half the lanes pinned to exact steps), ecoli,
             transport, a budget cut, ring8 with a negative rate in a
             sweep and 2^19 lanes (more than one wave: lanes from the
             ticket), and with an unreachable leap threshold against the
             exact kernel on lv8; the sparse tau-leap window on ring8
             (also with the negative rate), ring80 (shared rates; per-lane
             rates with half the lanes pinned to exact steps; a budget
             cut), lattice8x8, ring256 and the coefficient-5 system, and
             against the dense tau kernel on ecoli; each tau case names
             the lanes a block and the lanes taken from the ticket.
3. main    — the dense main path at full width:
             simulate(Experiment(lv8, 2^20 replicas, use_kernel=True)).
3b. sparse — the sparse main path at full width:
             simulate(Experiment(ring80, 2^18 replicas, sparse=True,
             use_kernel=True)); then one window of ring256 at the same
             width, the HBM route, timed alone (rerun bitwise).
3c. match  — the Match entry point `kernels.ops.propensity` at full
             width on the populations that 3b ends with, shared and
             per-lane rates: launches (counter set to 0 just before),
             kernel against twin, route, tile, times and bound.
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
4. supersteps — the main path of 3 with window_block=4,
             pipeline_depth=2 and a checkpoint after every block:
             launches = windows, dispatches = host syncs = blocks, no
             checkpoint flushes the pipeline, records bitwise equal to
             phase 3's. A save at window 4 while block 1 is in flight is
             served from its entry snapshot, and block 1 is still
             running when the save's copy is in; runs resumed from that
             file and from a max_windows=4 run's save end with phase 3's
             pool (x, t, ctr, ctr_hi) and records bit for bit. Wall per
             window, host syncs per window and each block's dispatch and
             collect walls at (W, K) = (1, 1), (4, 1), (4, 2), (8,
             "auto"), each run twice in turns. The path of 3e with window_block=8 and depth "auto":
             records bitwise equal to phase 3e's, the resolved depth and
             its probe. One checkpoint's save time, size and restore
             time at each of the two widths (files in a temporary
             directory, removed at the end). host_loop=True on lv8 at
             2^14 lanes: records and pool bitwise equal to the fused
             path's, dispatches = launches = groups x windows.
5. sketches and steering — 5a: lv8 at the width of 3 as a sweep of 8
             points x 2^17 replicas over `die`, PER_POINT, window_block=4,
             a SketchSpec: each window's histogram and rare counts equal a
             numpy recount of the pulled observables (the reciprocal-multiply
             rule), each group's total its lanes; then steered
             (early stop at a tolerance between the smallest and the largest
             point's relative CI at the first decision point, reallocation,
             bimodality): a point stops and its lanes move, a rerun repeats
             the decision log, records and sketches bit for bit,
             `Steering()` gives the unsteered records, and a run dropped
             after its first decision and restored into a new engine ends
             as the uninterrupted one. 5b: the cell of 3d with
             `Steering(tau_switch=True)` (lanes pinned per decision, ms per
             window against 3d's), and with tau_fallback=1e6 every lane
             pinned with records equal to the unpinned run's. 5c: the cell
             of 3b with a SketchSpec: records equal to 3b's, totals = lanes.
             Launches = windows in every run; ms per window steered and
             unsteered, the decision point's wall and the sketch's own ms
             per window (CUDA events).
6. shards and recovery — 6a: the path of 3 (lv8 x 2^20, exact) with
             Partitioning(n_shards=4, stat_blocks=8), shard k on cuda:k
             when four cards are visible, else all four on cuda:0 (printed),
             against the unsharded run at stat_blocks=8, at window_block 1
             and 4 with depth "auto", in turns: records bitwise equal,
             launches = windows x 4, dispatches = windows or blocks, host
             syncs per window 1 and 1/4, wall per window of each. 6b: the
             dense tau kernel on the same cell at 4 shards, the sparse exact
             and sparse tau kernels on ring80 x 2^18 at 2 shards (2
             windows), each bitwise against its unsharded run, launches =
             windows x shards. 6c: a 4-shard save at window 4 restored at
             1 and at 2 shards, each ending bitwise equal to 6a, with the
             save and restore times. 6d: supervised runs of 6a's cell
             (cadence 2): crash and corrupt-newest-file (2 restarts), two
             device losses (4 -> 2 -> 1 shards) and a NaN-poisoned pool
             caught by the engine's guard, each bitwise equal to 6a, with
             each recovery's teardown, rebuild and restore walls.
7. farm    — the multi-process farm (`Recovery(workers=4)`), every
             worker a process on cuda:0 (its own CUDA context). 7a: the
             cell of 6a (lv8 x 2^20, exact, stat_blocks=8, a checkpoint
             every window): records bitwise equal to 6a's unsharded run,
             no restart, each worker's own launch counter at 8 (one per
             window) and one dispatch and host sync per window; the
             farm's wall against the single-process run's, each worker's
             start-up (its lifetime less its engine's wall) and the
             merge's ms. 7b: 5a's steered, sketched sweep (tolerance of
             5a, bimodality, no reallocation) at 4 workers: records,
             per-point stats, sketches and the steering report bitwise
             equal to its single-process run, one host sync per block.
             7c: SIGKILL, SIGSTOP, a corrupt newest checkpoint and a
             retired worker's shard reassigned, each on 7a's cell,
             bitwise equal to 6a, with each drill's detection, relaunch
             and the faulted shard's end. 7d: `python -m
             repro_torch.launch.simulate --workers 4` at 7a's size: its
             CSV equals 7a's records as CsvSink writes them.
8. report  — one JSON line of per-kernel numbers (launches: the main
             paths', phase 6's counted sharded runs' and the workers' of
             7a and 7b, each from its own counter), the card line, then
             the result line.

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
# phase 5a: the dense main path as a sweep of STEER_POINTS points
STEER_RATE = "die"
STEER_VALUES = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
SKETCH_BINS = 32
SKETCH_THRESHOLDS = (500.0, 2000.0)
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


def match_inputs(name, b, extreme, offset, rng, device):
    """(x, idx, coef, shared rates, per-lane rates) of a Match case: a
    system's tables (`system_of`), or raw ones, both on the "global"
    route ("raw6": M = 6 slots, coefficients up to 7; "table70000":
    70,000 species, R = 300, coefficients up to 6). Populations are counts
    in [0, 300); `extreme` adds negatives, NaN, 2^24 and more, 1e30 and
    +-inf. `offset` floats before x and the per-lane rates put them off
    16 bytes."""
    import numpy as np
    import torch

    if name in ("raw6", "table70000"):
        s, r, m, c = ((50, 33, 6, 7) if name == "raw6"
                      else (70_000, 300, 4, 6))
        idx = rng.integers(0, s, (r, m)).astype(np.int32)
        coef = rng.integers(1, c + 1, (r, m)).astype(np.int32)
        coef[rng.random((r, m)) < 0.3] = 0
        shared = rng.uniform(0.1, 2.0, r).astype(np.float32)
    else:
        system = system_of(name)
        s, r = system.n_species, system.n_reactions
        idx = system.reactant_idx.astype(np.int32)
        coef = system.reactant_coef.astype(np.int32)
        shared = system.rates
    x = rng.integers(0, 300, (b, s)).astype(np.float32)
    if extreme:
        u = rng.random((b, s))
        x[u < 0.05] = -rng.integers(1, 6, int((u < 0.05).sum()))
        x[(u >= 0.05) & (u < 0.08)] = np.nan
        big = (u >= 0.08) & (u < 0.14)
        x[big] = rng.choice(np.float32([2**24, 2**24 + 2, 3e7, 1e30, np.inf,
                                        -np.inf]), int(big.sum()))
    per_lane = (shared[None] * rng.uniform(0.5, 1.5, (b, r))).astype(
        np.float32)

    def on_card(a):
        flat = np.concatenate([np.zeros(offset, np.float32), a.reshape(-1)])
        return torch.as_tensor(flat, device=device)[offset:].view(a.shape)

    return (on_card(x), torch.as_tensor(idx, device=device),
            torch.as_tensor(coef, device=device),
            torch.as_tensor(shared, device=device), on_card(per_lane))


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
               no_leap=False, rates=None):
    """(tau kernel argument tuple minus the horizon, max_c) for one window
    of a fresh pool of `system`; `no_leap` pins every other lane to exact
    steps; `rates` (B, R), when given, replaces the sweep of
    `per_lane_rates`."""
    import torch

    from repro_torch.core.gillespie import init_lanes
    from repro_torch.core.tau_leap import tau_tables

    pool = init_lanes(system, n_lanes, seed, device=device)
    tb = tau_tables(system, sparse=sparse, device=device)
    if rates is None:
        rates = (sweep_rates(system, n_lanes, seed) if per_lane_rates
                 else system.rates)
    rates = torch.as_tensor(rates, device=device)
    nl = (torch.arange(n_lanes, device=device) % 2 if no_leap
          else torch.zeros(n_lanes, device=device)).to(torch.int32)
    return (pool.x, pool.t, pool.dead.to(torch.int32), nl, pool.key,
            pool.ctr, pool.ctr_hi, *tb[:6], rates, tb.gi, tb.rmask), tb.max_c


def bitwise_diff(outs_a, outs_b) -> tuple[int, float]:
    """(number of differing elements, max abs difference where both are
    finite) over two tuples of tensors of the same shapes."""
    import torch

    n_diff, err = 0, 0.0
    for a, b in zip(outs_a, outs_b):
        if a.dtype == torch.float32:
            n_diff += int((a.view(torch.int32) != b.view(torch.int32)).sum())
            both = torch.isfinite(a) & torch.isfinite(b)
            if bool(both.any()):
                err = max(err, float((a.double() - b.double())[both].abs()
                                     .max()))
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
    """The least work of the tau-leap step, counted from
    kernels/csrc/tau_step.cuh and the two tau kernels: float32
    instructions per active iteration (`iter`: a0's and max a_j's R-1
    operations each, and the gate that decides whether a leap is possible:
    horizon - t, the LAM_MAX cap's max and divide, a min, a multiply and a
    compare), per accepted leap (`leap`), per exact sub-step (`exact`),
    per fired exact event (`fired`) and per lane and launch (`seed`: the
    Match of every reaction); int32 instructions per accepted leap
    (`i_leap`) and per exact sub-step (`i_exact`). An FMA counts 1.

    The Cao bound (per consumed species: mu's multiply and add and sig2's
    square, multiply and add per nonzero of its delta column, the g_i terms'
    subtract, max, divide and add per nonzero coefficient row, bnd (3), r1
    (3), r2 (3) and the two minima) and tau (4) are charged to accepted
    leaps only: the run does not count the iterations that pass the gate
    and then do not leap. Per accepted leap also the Match of every
    reaction it makes due (a leap may change every population) and its
    own least: one attempt (the run does not record rejected ones), each
    reaction's lam, exp_f32 and one cdf compare (the Poisson terms past the
    first depend on the draws, which the run does not record), the check
    and the update of x (an add and a multiply per nonzero, an add and a
    compare per species), the clock (2); and ceil(R/2) counter blocks. Per
    exact sub-step: the log, the uniforms and the resolve, and one counter
    block with its bump; per fired event, least over j: the threshold, one
    scan add and compare, j's nonzero delta entries and the Match of j's
    dependency rows. `iter_full`, `leap_full` and `fired_full` are the
    earlier count, which charged the Match and the Cao bound to every
    iteration."""
    import numpy as np

    from repro_torch.core.reactions import sparse_tables

    r = system.n_reactions
    coef = system.reactant_coef
    nnz_col = (np.asarray(tables.col_j.cpu()) < r).sum(axis=1)
    gi = np.asarray(tables.gi.cpu())
    consumed = np.asarray(tables.rmask.cpu()) > 0
    cao = sum(5 * int(nnz_col[i]) + 4 * int((gi[1:, i] != 0).sum()) + 11
              for i in np.nonzero(consumed)[0])
    match = sum(slot_ops(row) for row in coef)
    nnz = int(nnz_col.sum())
    s = system.n_species
    f_leap = r * (1 + F_EXP + 1) + 2 * (2 * nnz + 2 * s) + 2
    n_pairs = (r + 1) // 2
    nnz_row = (system.delta != 0).sum(axis=1)
    fired = min(3 + int(n) + m for n, m in zip(
        nnz_row, dep_match(system, sparse_tables(system))))
    return dict(iter=2 * (r - 1) + 6, leap=cao + 4 + match + f_leap,
                exact=F_LOG + F_UNIFORMS + F_RESOLVE, fired=fired,
                seed=match, i_leap=n_pairs * I_BLOCK + 2, i_exact=I_STEP,
                iter_full=match + 2 * (r - 1) + cao + 6, leap_full=f_leap,
                fired_full=3 + int(nnz_row.min()))


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
                                    "stack frame", "entry function")):
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
    from repro_torch.kernels.propensity import (
        propensity_call,
        propensity_plain,
    )
    from repro_torch.kernels.ssa_step import (
        sparse_tau_window_call,
        sparse_tau_window_plain,
        sparse_window_call,
        sparse_window_plain,
        sparse_tau_lanes_per_block,
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
                f"{'(B,R)' if per_lane else '(R,)'} route "
                f"{propensity_call.route}, tile {propensity_call.tile}: "
                f"{n_diff} differing elements, max abs err {err:g}")
            if n_diff:
                raise AssertionError(f"propensity and its twin disagree: "
                                     f"{name}")
            worst["propensity"] = max(worst["propensity"], err)
    # the Match's edges: ragged and short tiles, R = 9, populations that
    # are negative, NaN, huge or infinite, coefficients 3, 4 and above,
    # operands off 16 bytes, and the "global" route (M = 6, S = 70,000)
    for name, b, extreme, offset, route in (
            ("ring80", CHECK_LANES + 5, False, 0, "shared"),
            ("ring80", 7, False, 0, "shared"),
            ("lv8", 1001, False, 0, "shared"),
            ("ring80", 3000, True, 0, "shared"),
            ("ring80", 3000, True, 3, "shared"),
            ("quartic", 3000, True, 0, "shared"),
            ("raw6", 777, True, 0, "global"),
            ("table70000", 300, True, 0, "global")):
        x, idx, coef, shared, per_lane = match_inputs(
            name, b, extreme, offset, rng, device)
        for rates in (shared, per_lane):
            k = propensity_call(x, idx, coef, rates)
            p = propensity_plain(x, idx, coef, rates)
            n_diff, err = bitwise_diff((k,), (p,))
            log(f"[kernels] propensity {name} B={b} S={x.shape[1]} "
                f"R={idx.shape[0]} M={idx.shape[1]} rates="
                f"{'(B,R)' if rates.ndim == 2 else '(R,)'}"
                f"{' extreme' if extreme else ''}"
                f"{f' offset {offset}' if offset else ''} route "
                f"{propensity_call.route}, tile {propensity_call.tile}: "
                f"{n_diff} differing elements, max abs err {err:g}")
            if n_diff or propensity_call.route != route:
                raise AssertionError(f"propensity {name} B={b}: {n_diff} "
                                     f"differing elements, route "
                                     f"{propensity_call.route}")
            if extreme and not (bool(torch.isnan(p).any())
                                and bool(torch.isinf(p).any())):
                raise AssertionError(f"propensity {name}: the extreme "
                                     f"populations reach no NaN or inf")
            worst["propensity"] = max(worst["propensity"], err)

    def tau_case(sparse, name, rates, no_leap, horizon, n_steps, fallback,
                 lanes, wave=False):
        """One tau kernel against its twin; `wave`: the lanes must exceed
        what the one-wave grid holds (some come from the ticket)."""
        system = system_of(name)
        args, max_c = tau_inputs(system, lanes, CHECK_SEED, rates != "(R,)",
                                 sparse, device, no_leap,
                                 negative_sweep(system, lanes, CHECK_SEED)
                                 if rates == "negative" else None)
        kw = dict(n_steps=n_steps, eps=0.03, fallback=fallback)
        call, plain = ((sparse_tau_window_call, sparse_tau_window_plain)
                       if sparse else (tau_window_call, tau_window_plain))
        if sparse:
            kw["max_c"] = max_c
        k = call(*args, horizon, **kw)
        ticket = lanes - call.grid_lanes
        p = plain(*args, horizon, **kw)
        s, r = system.n_species, system.n_reactions
        route = (f"{sparse_tau_lanes_per_block(s, r)} lanes a block"
                 if sparse else "128 lanes a block")
        label = (f"{name} S={s} R={r} B={lanes} rates={rates}"
                 f"{' no_leap=half' if no_leap else ''} fallback={fallback:g}"
                 f" {route}, {ticket} lanes from the ticket, "
                 f"{int(k[4].sum())} leaps,")
        kernel = "sparse_tau_window" if sparse else "tau_window"
        check(kernel, label, k, p, horizon, n_steps)
        if wave and not ticket:
            raise AssertionError(f"{kernel}: {name} took no lane from the "
                                 f"ticket")
        return args, k, label

    # (sparse, model, rates, no_leap half, horizon, n_steps, fallback,
    # lanes, more lanes than one wave)
    tau_cases = [
        (False, "lv8", "(R,)", False, 0.5, budget, 10.0, CHECK_LANES),
        (False, "lv8", "(B,R)", True, 0.5, budget, 10.0, CHECK_LANES),
        (False, "ecoli", "(R,)", False, 50.0, budget, 10.0, CHECK_LANES),
        (False, "transport", "(B,R)", False, 2.0, budget, 10.0, CHECK_LANES),
        (False, "lv8", "(R,)", False, 0.5, 48, 10.0, CHECK_LANES),
        (False, "ring8", "negative", False, 0.5, budget, 3.0, CHECK_LANES),
        (False, "lv8", "(B,R)", False, 0.1, budget, 10.0, 8 * CHECK_LANES,
         True),
        (True, "ring8", "(R,)", False, 0.5, budget, 3.0, CHECK_LANES),
        (True, "ring8", "negative", False, 0.5, budget, 3.0, CHECK_LANES),
        (True, "ring80", "(R,)", False, 0.5, budget, 10.0, CHECK_LANES,
         True),
        (True, "ring80", "(B,R)", True, 0.5, budget, 10.0, CHECK_LANES,
         True),
        (True, "ring80", "(B,R)", False, 0.5, 6, 10.0, CHECK_LANES),
        (True, "lattice8x8", "(B,R)", False, 0.25, budget, 10.0,
         CHECK_LANES, True),
        (True, "ring256", "(R,)", False, 0.1, budget, 10.0,
         CHECK_LANES // 8, True),
        (True, "coef5", "(R,)", False, 0.5, budget, 3.0, CHECK_LANES),
    ]
    for case in tau_cases:
        tau_case(*case)
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
    # the sparse tau kernel against the dense one
    args, k, label = tau_case(True, "ecoli", "(R,)", False, 50.0, budget,
                              10.0, CHECK_LANES)
    d = tau_window_call(*args, 50.0, n_steps=budget, eps=0.03, fallback=10.0)
    n_diff, _ = bitwise_diff(k, d)
    log(f"[kernels] sparse_tau_window vs tau_window {label}: {n_diff} "
        f"differing elements")
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
    if res.steering_report() != res2.steering_report():
        raise AssertionError(f"{label}: a second run decided otherwise")
    traj = res2.trajectories()  # (I, T, n_obs)
    ref = traj.astype(np.float64).mean(axis=0)
    rel = float(np.max(np.abs(means2 - ref) / np.maximum(np.abs(ref), 1)))
    log(f"[{label}] record means vs float64 recomputation: max rel err "
        f"{rel:.3g} (tolerance {MAIN_RTOL:g}); rerun bitwise equal")
    if not rel <= MAIN_RTOL:
        raise AssertionError(f"{label}: record means disagree with float64")
    return dict(launches=launches, final_x=res2._engine._pool.x,
                steps=list(steps), win_ms=win_ms, records=recs,
                report=res.steering_report()), win_ms[0]


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
                win_ms=nums["win_ms"], records=nums["records"])


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
                steps=nums["steps"], win_ms=nums["win_ms"],
                records=nums["records"])


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
            f"{label} route {propensity_call.route}, tile "
            f"{propensity_call.tile} lanes: kernel {k_ms:.4f} ms, plain "
            f"twin {p_ms:.3f} ms, 0 differing elements; bound {bound:.4f} ms "
            f"({detail}), {bound / k_ms:.3f} of it")
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
              eps=exp.tau_eps, fallback=exp.tau_fallback)
    # the kernel's bound operands, as FusedDispatch binds them once per run
    bound_kw = ({"max_c": tb.max_c} if sparse else
                {"dep_mask": ssa_step.dense_dep_mask(*eng._tensors_base[:3])})
    k_ms, p_ms, out, err = time_against_twin(
        label, lambda: call(*args, horizon, **kw, **bound_kw),
        lambda: plain(*args, horizon, **kw,
                      **({"max_c": tb.max_c} if sparse else {})), reps=3)
    ticket = pool.x.shape[0] - call.grid_lanes
    iters, leaps = int(out[7].sum()), int(out[4].sum())
    fired = int(out[3].sum()) - leaps
    lanes_active = int((out[7] > 0).sum())
    ops = tau_ops(eng.system, tb)
    b, s = pool.x.shape
    # the pool in and out, no_leap in, leaps and iterations out, tables
    n_bytes = pool_bytes(b, s) + b * 12 + nbytes(*args[7:])
    i_ops = leaps * ops["i_leap"] + (iters - leaps) * ops["i_exact"]
    f_exact = (iters - leaps) * ops["exact"]
    bound, by, detail = bound_of(
        n_bytes, iters * ops["iter"] + leaps * ops["leap"] + f_exact
        + fired * ops["fired"] + lanes_active * ops["seed"], i_ops)
    bound_full, _, _ = bound_of(
        n_bytes, iters * ops["iter_full"] + leaps * ops["leap_full"]
        + f_exact + fired * ops["fired_full"], i_ops)
    where = (f"{ssa_step.sparse_tau_lanes_per_block(s, eng.system.n_reactions)}"
             f" lanes a block" if sparse else "128 lanes a block")
    log(f"[{label}] one window at full width: kernel {k_ms:.3f} ms, plain "
        f"twin {p_ms:.1f} ms, 0 differing elements; {iters} active lane "
        f"iterations, {leaps} leaps, {fired} exact events; bound "
        f"{bound:.4f} ms ({detail}; charging the Match and the Cao bound "
        f"to every iteration {bound_full:.4f} ms); "
        f"{where}, {ticket} of {b} lanes from the ticket; the same window "
        f"took {win0_ms:.3f} ms end to end, kernel share "
        f"{k_ms / win0_ms:.4f}")
    return dict(launches=nums["launches"], ms=k_ms, plain_ms=p_ms,
                bound_ms=bound, bound_by=by, err=err,
                records=nums["records"], win_ms=nums["win_ms"])


def records_equal(a, b) -> bool:
    """Two record lists bit for bit: t, window, n, mean, var, ci90."""
    return len(a) == len(b) and all(
        (ra.t, ra.window, ra.n) == (rb.t, rb.window, rb.n)
        and all(getattr(ra, f).tobytes() == getattr(rb, f).tobytes()
                for f in ("mean", "var", "ci90"))
        for ra, rb in zip(a, b))


def timed_checkpoint(res, path) -> tuple[float, float, float]:
    """(save s, file MB, restore s into a fresh engine of the same
    experiment) for one checkpoint of a finished run `res`; the
    restored pool must equal the saved one bit for bit."""
    import os

    import torch

    from repro_torch.api import build_engine

    eng = res._engine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.checkpoint(path)
    save_s = time.perf_counter() - t0
    mb = os.path.getsize(path + ".npz") / 1e6
    fresh = build_engine(res.experiment, device=eng.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.restore(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for a, b in zip(eng._pool, fresh._pool):
        if not torch.equal(a, b):
            raise AssertionError("checkpoint: the restored pool differs")
    return save_s, mb, restore_s


def phase_supersteps(device, main_recs, tau_sparse_recs, card) -> None:
    """Phase 4: supersteps, the depth-K collector, checkpoints and the
    host loop at full width, held bit for bit against phases 3 and 3e."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.api import (
        Ensemble,
        Experiment,
        Method,
        Schedule,
        build_engine,
        simulate,
    )
    from repro_torch.core.cwc.models import MODELS
    from repro_torch.kernels.ssa_step import ssa_window_call

    main = Experiment(model=MODELS[MAIN_MODEL](),
                      ensemble=Ensemble.make(replicas=MAIN_REPLICAS),
                      schedule=Schedule(t_end=MAIN_T_END,
                                        n_windows=MAIN_WINDOWS),
                      n_lanes=1024, use_kernel=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # the main path in supersteps of 4 at depth 2, checkpointing
        exp = main.with_(window_block=4, pipeline_depth=2)
        n_blocks = MAIN_WINDOWS // 4
        ck = f"{tmp}/main"
        ssa_window_call.launches = 0
        res = simulate(exp, device=device, checkpoint_path=ck)
        launches = ssa_window_call.launches
        t = res.telemetry
        log(f"[supersteps] lv8 x {MAIN_REPLICAS}, window_block=4, "
            f"pipeline_depth=2, checkpointing: {launches} kernel launches, "
            f"{t.dispatches} dispatches, {t.host_syncs} host syncs, "
            f"peak {t.peak_inflight_blocks} blocks in flight, "
            f"{t.snapshot_saves} snapshot saves, {t.ckpt_flushes} flushes")
        if launches != MAIN_WINDOWS:
            raise AssertionError(f"supersteps: {launches} launches for "
                                 f"{MAIN_WINDOWS} windows")
        if not t.dispatches == t.host_syncs == n_blocks:
            raise AssertionError("supersteps: dispatches or host syncs "
                                 "differ from the blocks")
        # every save but the last (after the final block, when nothing
        # is in flight) is served from the next block's ring snapshot
        if t.ckpt_flushes != 0 or t.snapshot_saves != n_blocks - 1:
            raise AssertionError("supersteps: a checkpoint flushed")
        if not records_equal(res.records, main_recs):
            raise AssertionError("supersteps: records differ from the "
                                 "per-window run's")
        # a save at window 4 while block 1 (windows 4-7) is in flight:
        # served from that block's entry snapshot, copied on a side
        # stream, so block 1 must still be running when the copy is in
        snap = f"{tmp}/snap"
        eng = build_engine(exp, device=device)
        eng.enable_snapshots()
        eng.run_block()
        eng.run_block()  # dispatches block 1, collects block 0
        if not (len(eng._pending) == 1 and eng._window == 4):
            raise AssertionError("supersteps: block 1 is not in flight")
        eng.checkpoint(snap)
        pull_s, running = eng.ckpt_pulls[-1]
        log(f"[supersteps] a save at window 4 with block 1 in flight: "
            f"{eng.n_snapshot_saves} snapshot save, {eng.n_ckpt_flushes} "
            f"flushes, the pool's copy waited {pull_s * 1e3:.3f} ms and "
            f"left {running} block running; {card}")
        if eng.n_snapshot_saves != 1 or eng.n_ckpt_flushes != 0:
            raise AssertionError("supersteps: the in-flight save was not "
                                 "served from the snapshot")
        if running != 1:
            raise AssertionError("supersteps: the snapshot's copy waited "
                                 "for the block in flight")
        eng.flush()
        if not records_equal(eng.stream.records(), main_recs):
            raise AssertionError("supersteps: records differ after the "
                                 "in-flight save")
        pool = res._engine._pool
        for label, path in (("the in-flight snapshot save", snap),
                            ("a max_windows=4 run's save", f"{tmp}/cut")):
            if path != snap:
                simulate(exp, device=device, max_windows=4,
                         checkpoint_path=path)
            if int(np.load(path + ".npz")["window"]) != 4:
                raise AssertionError(f"supersteps: {label} is not at "
                                     "window 4")
            rpool = simulate(exp, device=device, checkpoint_path=path,
                             resume=True)
            for f in ("x", "t", "ctr", "ctr_hi"):
                if not bool((getattr(pool, f)
                             == getattr(rpool._engine._pool, f)).all()):
                    raise AssertionError(f"supersteps: pool {f} resumed "
                                         f"from {label} differs")
            if not records_equal(rpool.records, main_recs):
                raise AssertionError(f"supersteps: records resumed from "
                                     f"{label} differ")
        log("[supersteps] records bitwise equal to phase 3's; runs "
            "resumed from the in-flight snapshot save and from a "
            "max_windows=4 run's save end with pool x, t, ctr, ctr_hi and "
            "records bitwise equal")

        # wall per window for each (W, K), in turns, no checkpoints
        walls = {}
        for wb, depth in ((1, 1), (4, 1), (4, 2), (8, "auto"),
                          (8, "auto"), (4, 2), (4, 1), (1, 1)):
            r = simulate(main.with_(window_block=wb, pipeline_depth=depth),
                         device=device)
            if not records_equal(r.records, main_recs):
                raise AssertionError(f"supersteps: ({wb}, {depth}) records "
                                     "differ")
            t = r.telemetry
            walls.setdefault((wb, depth), []).append(
                (t.wall_time_s / MAIN_WINDOWS * 1e3,
                 t.host_syncs / MAIN_WINDOWS, t.pipeline_depth,
                 r._engine.depth_probe, t.block_walls))
        for (wb, depth), runs in walls.items():
            probe = runs[0][3]
            log(f"[supersteps] (W, K) = ({wb}, {depth}): wall per window "
                f"{[round(x[0], 3) for x in runs]} ms, host syncs per "
                f"window {runs[0][1]:g}, depth {runs[0][2]}"
                + (f", probe dispatch {probe['dispatch_s'] * 1e3:.3f} ms "
                   f"pull {probe['pull_s'] * 1e3:.3f} ms host "
                   f"{probe['host_s'] * 1e3:.3f} ms" if probe else "")
                + f"; {card}")
            for i, (_, _, _, _, bw) in enumerate(runs):
                log(f"[supersteps]   run {i + 1} blocks (first window, "
                    f"windows, dispatch ms, collect ms): "
                    + ", ".join(f"({w0}, {n}, {d * 1e3:.3f}, "
                                f"{c * 1e3:.3f})" for w0, n, d, c in bw))

        # the sparse tau path in supersteps of 8 at depth "auto"
        sp = Experiment(model=MODELS[SPARSE_MODEL](),
                        ensemble=Ensemble.make(replicas=SPARSE_REPLICAS),
                        schedule=Schedule(t_end=SPARSE_T_END,
                                          n_windows=SPARSE_WINDOWS),
                        n_lanes=1024, sparse=True, use_kernel=True,
                        method=Method.TAU_LEAP, window_block=8,
                        pipeline_depth="auto")
        rs = simulate(sp, device=device)
        if not records_equal(rs.records, tau_sparse_recs):
            raise AssertionError("supersteps: ring80 tau records differ "
                                 "from phase 3e's")
        probe = rs._engine.depth_probe
        log(f"[supersteps] ring80 x {SPARSE_REPLICAS} sparse tau, "
            f"window_block=8, depth auto: records bitwise equal to phase "
            f"3e's; resolved depth {rs.telemetry.pipeline_depth}, probe "
            f"dispatch {probe['dispatch_s'] * 1e3:.3f} ms, pull "
            f"{probe['pull_s'] * 1e3:.3f} ms, host "
            f"{probe['host_s'] * 1e3:.3f} ms")

        # one checkpoint's save, size and restore at each width
        for label, r in (("lv8", res), ("ring80 tau", rs)):
            save_s, mb, restore_s = timed_checkpoint(
                r, f"{tmp}/{label.replace(' ', '_')}")
            log(f"[supersteps] checkpoint {label}: save {save_s:.3f} s, "
                f"{mb:.1f} MB, restore {restore_s:.3f} s; {card}")

        # the host loop at 2^14 lanes against the fused path
        small = main.with_(ensemble=Ensemble.make(replicas=1 << 14))
        fused = simulate(small, device=device)
        ssa_window_call.launches = 0
        hl = simulate(small.with_(host_loop=True), device=device)
        groups = (1 << 14) // small.n_lanes
        if not records_equal(hl.records, fused.records):
            raise AssertionError("host loop: records differ from fused")
        if not (hl.telemetry.dispatches == ssa_window_call.launches
                == groups * MAIN_WINDOWS):
            raise AssertionError("host loop: dispatches differ from "
                                 "groups x windows")
        if not bool((hl._engine._pool.x == fused._engine._pool.x).all()):
            raise AssertionError("host loop: final pool differs")
        log(f"[supersteps] host_loop lv8 x {1 << 14}: {groups} groups x "
            f"{MAIN_WINDOWS} windows = {hl.telemetry.dispatches} "
            f"dispatches and launches; records and pool bitwise equal to "
            f"the fused path's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def steer_experiment(**kw):
    """Phase 5a's experiment: the dense main path as a sweep of
    len(STEER_VALUES) points over STEER_RATE at the width of phase 3,
    per-point statistics, supersteps of 4, a sketch."""
    from repro_torch.api import (
        Ensemble,
        Experiment,
        Reduction,
        Schedule,
        SketchSpec,
    )
    from repro_torch.core.cwc.models import MODELS

    return Experiment(
        model=MODELS[MAIN_MODEL](),
        ensemble=Ensemble.make(
            replicas=MAIN_REPLICAS // len(STEER_VALUES),
            sweep={STEER_RATE: list(STEER_VALUES)}),
        schedule=Schedule(t_end=MAIN_T_END, n_windows=MAIN_WINDOWS),
        reduction=Reduction.PER_POINT, n_lanes=1024, use_kernel=True,
        window_block=4,
        sketch=SketchSpec(n_bins=SKETCH_BINS, thresholds=SKETCH_THRESHOLDS),
        **kw)


def sketches_equal(a, b) -> bool:
    """Two WindowSketch lists bit for bit."""
    return len(a) == len(b) and all(
        x.hist.tobytes() == y.hist.tobytes()
        and (x.rare is None) == (y.rare is None)
        and (x.rare is None or x.rare.tobytes() == y.rare.tobytes())
        for x, y in zip(a, b))


def recount_sketches(res) -> None:
    """Hold each window's sketch against a numpy recount of the pulled
    observables: bin = clamp(floor((obs - lo) * inv_width)), the
    reference engine's reciprocal multiply; each group's histogram
    total is its lane count."""
    import numpy as np

    eng = res._engine
    sk = eng._sketch
    gids = eng._group_ids.astype(np.int64)
    n_groups = int(gids.max()) + 1
    traj = res.trajectories()  # (I, T, n_obs)
    n_obs = traj.shape[2]
    row = gids[:, None] * n_obs + np.arange(n_obs)
    lanes = np.bincount(gids, minlength=n_groups)
    for w, got in enumerate(res.sketches()):
        obs = traj[:, w, :]
        b = np.clip(np.floor((obs - sk.lo) * sk.inv_width), 0,
                    sk.n_bins - 1).astype(np.int64)
        hist = np.bincount((row * sk.n_bins + b).ravel(),
                           minlength=n_groups * n_obs * sk.n_bins)
        if not (got.hist.reshape(-1) == hist).all():
            raise AssertionError(f"sketch: window {w}'s histogram differs "
                                 "from the numpy recount")
        for k, level in enumerate(sk.thresholds):
            rare = np.bincount(row.ravel(), weights=(obs >= level).ravel(),
                               minlength=n_groups * n_obs)
            if not (got.rare[..., k].reshape(-1) == rare).all():
                raise AssertionError(f"sketch: window {w}'s count at or "
                                     f"above {level} differs")
        if not (got.hist.sum(axis=-1) == lanes[:, None]).all():
            raise AssertionError(f"sketch: window {w}'s totals differ from "
                                 "the groups' lanes")


def phase_steering(device, card) -> float:
    """Phase 5a: sketches and steering on the dense main path as a
    sweep, at full width. Returns the steering tolerance it chose."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.api import (
        SimulationResult,
        Steering,
        build_engine,
        simulate,
    )
    from repro_torch.kernels.ssa_step import ssa_window_call

    exp = steer_experiment()
    n_points = len(STEER_VALUES)
    label = "steer"

    def timed(e):
        ssa_window_call.launches = 0
        r = simulate(e, device=device)
        if ssa_window_call.launches != MAIN_WINDOWS:
            raise AssertionError(f"{label}: {ssa_window_call.launches} "
                                 f"launches for {MAIN_WINDOWS} windows")
        if len(r.records) != MAIN_WINDOWS or not all(
                np.isfinite(v).all() for x in r.records
                for v in (x.mean, x.var, x.ci90)):
            raise AssertionError(f"{label}: records missing or not finite")
        return r, r.telemetry.wall_time_s / MAIN_WINDOWS * 1e3

    base, base_ms = timed(exp)
    chk = simulate(exp.with_(record_trajectories=True), device=device)
    if not (records_equal(chk.records, base.records)
            and sketches_equal(chk.sketches(), base.sketches())):
        raise AssertionError(f"{label}: a rerun gave other records or "
                             "sketches")
    recount_sketches(chk)
    del chk
    eng = base._engine
    sk = eng._sketch
    obs = eng._observe()
    sketch_ms = cuda_ms(lambda: eng._sketch_eval(obs), reps=10)
    log(f"[{label}] lv8 x {MAIN_REPLICAS} as {n_points} points x "
        f"{MAIN_REPLICAS // n_points} over {STEER_RATE}={list(STEER_VALUES)},"
        f" window_block=4, {sk.n_bins} bins, thresholds "
        f"{list(SKETCH_THRESHOLDS)}: {MAIN_WINDOWS} launches; every window's "
        f"histogram and rare counts equal the numpy recount, totals = lanes;"
        f" unsteered {base_ms:.3f} ms per window; the sketch alone "
        f"{sketch_ms:.4f} ms per window ({obs.shape[0]} x {obs.shape[1]} "
        f"observables); {card}")

    # the tolerance: between the smallest and the largest point's
    # relative CI at the first decision point (window 4's boundary)
    pp = base.per_point()
    rel = (pp["ci90"][3].astype(np.float64) / np.maximum(
        np.abs(pp["mean"][3].astype(np.float64)), 1.0)).max(axis=1)
    tol = float(np.sqrt(rel.min() * rel.max()))
    margins = [round(float(abs(r - tol) / tol), 4) for r in rel]
    log(f"[{label}] relative CI per point at window 4: "
        f"{[round(float(r), 6) for r in rel]}; ci_rel_tol {tol:.6g}; "
        f"margins |rel - tol| / tol {margins}")
    steer = Steering(ci_rel_tol=tol, min_windows=4, reallocate=True,
                     bimodality=True)
    sexp = exp.with_(steering=steer)
    steered, steered_ms = timed(sexp)
    rep = steered.steering_report()
    moved = [d for d in rep["decisions"] if d["action"] == "reallocate"]
    if not rep["stopped_points"] or not moved:
        raise AssertionError(f"{label}: no point stopped or no lanes moved "
                             f"({rep['decisions']})")
    # the rerun, with the decision point's wall (device work included)
    # and the policy's own host time within it
    walls, decide_walls = [], []
    eng2 = build_engine(sexp, device=device)
    boundary, decide = eng2._steer_boundary, eng2._steer.decide

    def timed_boundary():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        boundary()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    def timed_decide(*args):
        t0 = time.perf_counter()
        out = decide(*args)
        decide_walls.append(time.perf_counter() - t0)
        return out

    eng2._steer_boundary = timed_boundary
    eng2._steer.decide = timed_decide
    again = SimulationResult(sexp, eng2).resume()
    if not (again.steering_report() == rep
            and records_equal(again.records, steered.records)
            and sketches_equal(again.sketches(), steered.sketches())):
        raise AssertionError(f"{label}: a steered rerun differs")
    log(f"[{label}] steered: stopped points {rep['stopped_points']} at "
        f"windows {rep['stop_windows']}, decisions {rep['decisions']}, "
        f"{len(rep['bimodal_flags'])} bimodal flags, point-windows "
        f"simulated {rep['point_windows_simulated']} of "
        f"{rep['point_windows_total']}; {MAIN_WINDOWS} launches, "
        f"{steered.telemetry.host_syncs} host syncs for "
        f"{steered.telemetry.dispatches} blocks; {steered_ms:.3f} ms per "
        f"window against {base_ms:.3f} unsteered; decision points' wall "
        f"{[round(w * 1e3, 3) for w in walls]} ms (the policy's decide "
        f"{[round(w * 1e3, 3) for w in decide_walls]} ms); a rerun repeats "
        f"the decision log, records and sketches bit for bit; {card}")
    if steered.telemetry.host_syncs != steered.telemetry.dispatches:
        raise AssertionError(f"{label}: a decision point added host syncs")

    off = simulate(exp.with_(steering=Steering()), device=device)
    if not records_equal(off.records, base.records):
        raise AssertionError(f"{label}: Steering() changed the records")

    # the drill: checkpoint per collected block, drop the engine after
    # the first decision, build a new one and restore the file
    tmp = tempfile.mkdtemp(prefix="chip_smoke_steer_")
    try:
        ck = f"{tmp}/steer"
        eng3 = build_engine(sexp, device=device)
        dropped = False
        while eng3._window < len(eng3.grid):
            if eng3.run_block():
                eng3.checkpoint(ck)
            if eng3._steer.decisions and not dropped:
                dropped = True
                eng3 = build_engine(sexp, device=device)
                eng3.restore(ck)
        if not (dropped and eng3.steering_report() == rep
                and records_equal(eng3.stream.records(), steered.records)
                and sketches_equal(eng3.sketches(), steered.sketches())):
            raise AssertionError(f"{label}: the restored run differs from "
                                 "the uninterrupted one")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[{label}] Steering() with every lever off: records bitwise equal "
        f"to the unsteered run's; dropped after its first decision and "
        f"restored into a new engine, the run ends with the uninterrupted "
        f"run's report, records and sketches bit for bit")
    return tol


def phase_steer_tau(device, tau_win_ms, card) -> None:
    """Phase 5b: the tau switch on phase 3d's cell."""
    import numpy as np

    from repro_torch.api import (
        Ensemble,
        Experiment,
        Method,
        Schedule,
        Steering,
        simulate,
    )
    from repro_torch.core.cwc.models import MODELS
    from repro_torch.kernels.ssa_step import tau_window_call

    exp = Experiment(model=MODELS[MAIN_MODEL](),
                     ensemble=Ensemble.make(replicas=MAIN_REPLICAS),
                     schedule=Schedule(t_end=MAIN_T_END,
                                       n_windows=MAIN_WINDOWS),
                     n_lanes=1024, use_kernel=True, method=Method.TAU_LEAP)
    label = "steer tau"
    nums, _ = drive_main(exp.with_(steering=Steering(tau_switch=True)),
                         tau_window_call, label, device)
    ratio = [round(a / b, 4) for a, b in zip(nums["win_ms"], tau_win_ms)]
    pins = [(d["window"], d["n_lanes"], d["total_pinned"])
            for d in nums["report"]["decisions"] if d["action"] == "no_leap"]
    log(f"[{label}] lanes pinned to exact steps per decision (window, "
        f"newly, in all): {pins}; window ms / phase 3d's (windows 2-"
        f"{MAIN_WINDOWS}): {ratio}; {card}")

    fb = exp.with_(tau_fallback=1e6)
    tau_window_call.launches = 0
    pinned = simulate(fb.with_(steering=Steering(
        tau_switch=True, tau_switch_min_steps=8)), device=device)
    if tau_window_call.launches != MAIN_WINDOWS:
        raise AssertionError(f"{label}: {tau_window_call.launches} launches "
                             f"for {MAIN_WINDOWS} windows")
    plain = simulate(fb, device=device)
    n_pinned = pinned.steering_report()["lanes_pinned_exact"]
    if not (n_pinned == MAIN_REPLICAS
            and bool(pinned._engine._pool.no_leap.all())):
        raise AssertionError(f"{label}: {n_pinned} lanes pinned with no "
                             "leap worth taking")
    if not records_equal(pinned.records, plain.records):
        raise AssertionError(f"{label}: pinning changed the records")
    if not (np.asarray(pinned.telemetry.leaps_per_window) == 0).all():
        raise AssertionError(f"{label}: a lane leaped at tau_fallback=1e6")
    log(f"[{label}] tau_fallback=1e6, tau_switch_min_steps=8: all "
        f"{n_pinned} lanes pinned at window "
        f"{pinned.steering_report()['decisions'][0]['window']}, records "
        f"bitwise equal to the unpinned run's")


def phase_sketch_sparse(device, sparse_records, sparse_win_ms, card) -> None:
    """Phase 5c: phase 3b's experiment with a sketch attached."""
    import numpy as np

    from repro_torch.api import SketchSpec, simulate
    from repro_torch.core.cwc.models import MODELS
    from repro_torch.kernels.ssa_step import sparse_window_call

    exp = sparse_experiment(MODELS[SPARSE_MODEL]()).with_(
        sketch=SketchSpec(n_bins=SKETCH_BINS, thresholds=(20.0,)))
    sparse_window_call.launches = 0
    res = simulate(exp, device=device)
    if sparse_window_call.launches != SPARSE_WINDOWS:
        raise AssertionError(f"sketch sparse: {sparse_window_call.launches} "
                             f"launches for {SPARSE_WINDOWS} windows")
    if not records_equal(res.records, sparse_records):
        raise AssertionError("sketch sparse: records differ from phase 3b's")
    sks = res.sketches()
    if len(sks) != SPARSE_WINDOWS or not all(
            (s.hist.sum(axis=-1) == SPARSE_REPLICAS).all() for s in sks):
        raise AssertionError("sketch sparse: histogram totals differ from "
                             "the lanes")
    ms = res.telemetry.wall_time_s / SPARSE_WINDOWS * 1e3
    log(f"[sketch sparse] ring80 x {SPARSE_REPLICAS} with a sketch of "
        f"{len(res.obs_names)} observables: records bitwise equal to phase "
        f"3b's, totals = lanes, {SPARSE_WINDOWS} launches; {ms:.3f} ms per "
        f"window (phase 3b, timed per window: mean "
        f"{np.mean(sparse_win_ms):.3f}); {card}")


SHARDS = 4
SPARSE_SHARDS = 2
SHARD_BLOCKS = 8


def shard_devices(n: int, device):
    """The device argument of an n-shard run: shard k on cuda:k when n
    cards are visible, else every shard on `device`."""
    import torch

    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", k) for k in range(n)]
    return device


def sharded(exp, n_shards: int):
    """`exp` over n_shards shards (1: unsharded) at SHARD_BLOCKS stat
    blocks, the block count every phase-6 comparison pins."""
    from repro_torch.api import Partitioning

    return exp.with_(partitioning=Partitioning(n_shards=n_shards,
                                               stat_blocks=SHARD_BLOCKS))


def run_counted(exp, counter, device, **kw):
    """(result, launches of `counter` in this run): the count is set to 0
    just before and read just after."""
    from repro_torch.api import simulate

    counter.launches = 0
    res = simulate(exp, device=device, **kw)
    return res, counter.launches


def shard_kernel_split(exp, device, card) -> None:
    """Where a sharded window's time goes on one card: each window's
    dense kernel over the whole pool in one launch against the same
    window in SHARDS launches of its contiguous quarters, back to back
    (CUDA events, one of each a window after a warm-up), with window 2's
    longest lane per quarter; the outputs must agree. The engine
    advances the pool between windows."""
    import numpy as np
    import torch

    from repro_torch.api import build_engine
    from repro_torch.kernels.ssa_step import dense_dep_mask, ssa_window_call

    eng = build_engine(exp, device=device)
    idx, coef, delta, rates = eng._tensors_base
    mask = dense_dep_mask(idx, coef, delta)
    n_steps = exp.kernel_chunk_steps * exp.kernel_max_chunks
    whole_ms, quarter_ms = [], []
    for w in range(len(eng.grid)):
        pool = eng._pool
        horizon = float(np.float32(eng.grid[w]))
        per = pool.x.shape[0] // SHARDS

        def call(lo, hi):
            return ssa_window_call(
                pool.x[lo:hi], pool.t[lo:hi],
                pool.dead[lo:hi].to(torch.int32), pool.key[lo:hi],
                pool.ctr[lo:hi], pool.ctr_hi[lo:hi], idx, coef, delta,
                rates, horizon, n_steps=n_steps, dep_mask=mask)

        def whole():
            return call(0, pool.x.shape[0])

        def quarters():
            return [call(k * per, (k + 1) * per) for k in range(SHARDS)]

        if w == 0:
            whole()
            quarters()
        whole_ms.append(cuda_ms(whole))
        quarter_ms.append(cuda_ms(quarters))
        one = whole()
        parts = quarters()
        for i in range(len(one)):
            if not torch.equal(one[i], torch.cat([p[i] for p in parts])):
                raise AssertionError("6a: quarter launches disagree with "
                                     "the whole-pool launch")
        if w == 1:
            used = (one[4].long() - pool.ctr.long()) & 0xFFFFFFFF
            longest = [int(used[k * per:(k + 1) * per].max())
                       for k in range(SHARDS)]
            mean_used = float(used.double().mean())
        eng.run_window()
    extra = [q - o for q, o in zip(quarter_ms, whole_ms)]
    log(f"[sharded] 6a each window's kernel: one launch over "
        f"{eng.cfg.n_instances} lanes {[round(m, 3) for m in whole_ms]} ms, "
        f"{SHARDS} quarter launches back to back "
        f"{[round(m, 3) for m in quarter_ms]} ms, outputs equal; the "
        f"quarters' extra {[round(m, 3) for m in extra]} ms, mean "
        f"{float(np.mean(extra)):.3f} ms a window; window 2's longest "
        f"lane's active steps per quarter {longest} (mean {mean_used:.1f})"
        f"; {card}")


def shard_fold_split(exp, devs, device, card) -> None:
    """What a window queues besides its kernels, unsharded and at SHARDS
    shards (stat_blocks SHARD_BLOCKS): the ops of the observables, the
    per-shard block folds, the gather and the totals (`_products`),
    counted once and timed with CUDA events after a warm-up, and the
    gather alone."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.api import build_engine
    from repro_torch.core import reduction

    class CountOps(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func not in VIEW_OPS:
                CountOps.n += 1
            return func(*args, **(kwargs or {}))

    aten = torch.ops.aten
    VIEW_OPS = {aten.view.default, aten.reshape.default, aten.select.int,
                aten.slice.Tensor, aten.unbind.int, aten.expand.default,
                aten.alias.default, aten.detach.default}
    out = []
    for k in (1, SHARDS):
        eng = build_engine(sharded(exp, k), device=devs if k > 1 else device)
        eng.run_window()
        disp = eng._dispatch

        def products():
            return disp._products(eng._pools, disp.extract_obs(eng._pools),
                                  None, [None] * k)

        products()
        fold_ms = cuda_ms(products, reps=10)
        CountOps.n = 0
        with CountOps():
            products()
        n_ops = CountOps.n
        v_loc = SHARD_BLOCKS // k
        parts = [reduction.blocked_welford(o, v_loc)
                 for o in disp.extract_obs(eng._pools)]
        gather_ms = cuda_ms(
            lambda: reduction.gather_blocks_over_axis(parts, eng.device),
            reps=10)
        out.append(f"{k} shard(s) {fold_ms:.4f} ms in {n_ops} ops (the "
                   f"gather alone {gather_ms:.4f} ms)")
        del eng, disp, parts
    log(f"[sharded] 6a a window's products besides its kernels "
        f"(observables, block folds, gather, totals; CUDA events): "
        + "; ".join(out) + f"; {card}")


def phase_sharded(device, main_recs, card) -> tuple[dict, list]:
    """Phase 6: the sharded farm and supervised recovery at full width,
    each sharded run bitwise against its unsharded run at the same
    stat_blocks. Returns each engine kernel's launches in its counted
    sharded runs, and 6a's records (unsharded, stat_blocks 8)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.api import (
        Ensemble,
        Experiment,
        FailurePlan,
        Method,
        Recovery,
        Schedule,
        build_engine,
    )
    from repro_torch.api.result import SimulationResult
    from repro_torch.core.cwc.models import MODELS
    from repro_torch.kernels.ssa_step import (
        sparse_tau_window_call,
        sparse_window_call,
        ssa_window_call,
        tau_window_call,
    )
    from repro_torch.runtime.supervisor import RunSupervisor

    main = Experiment(model=MODELS[MAIN_MODEL](),
                      ensemble=Ensemble.make(replicas=MAIN_REPLICAS),
                      schedule=Schedule(t_end=MAIN_T_END,
                                        n_windows=MAIN_WINDOWS),
                      n_lanes=1024, use_kernel=True)
    devs = shard_devices(SHARDS, device)
    launches = dict(ssa_window=0, tau_window=0, sparse_window=0,
                    sparse_tau_window=0)
    eng = build_engine(sharded(main, SHARDS), device=devs)
    log(f"[sharded] {SHARDS} shards of {MAIN_REPLICAS // SHARDS} lanes on "
        f"{[str(d) for d in eng.devices]} ({torch.cuda.device_count()} "
        f"card(s) visible), stat_blocks={SHARD_BLOCKS}; {card}")
    del eng

    # 6a: the dense exact path, sharded against unsharded, in turns
    ref = None
    walls = {}
    for wb in (1, 4):
        exp = main.with_(window_block=wb, pipeline_depth="auto")
        n_disp = MAIN_WINDOWS // wb
        for k in (1, SHARDS, SHARDS, 1):
            res, n = run_counted(sharded(exp, k), ssa_window_call,
                                 devs if k > 1 else device)
            t = res.telemetry
            if ref is None:
                ref = res.records
                if not all(np.isfinite(v).all() for r in ref
                           for v in (r.mean, r.var, r.ci90)):
                    raise AssertionError("6a: records not finite")
                means = np.stack([r.mean for r in ref]).astype(np.float64)
                m3 = np.stack([r.mean for r in main_recs])
                rel = float(np.max(np.abs(means - m3)
                                   / np.maximum(np.abs(m3), 1)))
                if not rel <= MAIN_RTOL:
                    raise AssertionError("6a: means disagree with phase 3")
            elif not records_equal(res.records, ref):
                raise AssertionError(f"6a: records of ({k} shards, W={wb}) "
                                     "differ from the unsharded run's")
            if n != MAIN_WINDOWS * k:
                raise AssertionError(f"6a: {n} launches for {MAIN_WINDOWS} "
                                     f"windows x {k} shards")
            if not t.dispatches == t.host_syncs == n_disp:
                raise AssertionError(
                    f"6a: ({k} shards, W={wb}) {t.dispatches} dispatches, "
                    f"{t.host_syncs} host syncs for {n_disp}")
            if k > 1:
                launches["ssa_window"] += n
            walls.setdefault((wb, k), []).append(
                (t.wall_time_s / MAIN_WINDOWS * 1e3, t.pipeline_depth,
                 res._engine.depth_probe,
                 [b[2] * 1e3 for b in res._engine.block_walls]))
    for wb in (1, 4):
        log(f"[sharded] 6a lv8 x {MAIN_REPLICAS} exact, W={wb}, depth "
            f"auto (resolved {walls[(wb, SHARDS)][0][1]}): wall per window "
            f"{SHARDS} shards "
            f"{[round(w[0], 3) for w in walls[(wb, SHARDS)]]} ms, unsharded "
            f"{[round(w[0], 3) for w in walls[(wb, 1)]]} ms; "
            f"{MAIN_WINDOWS * SHARDS} launches, {MAIN_WINDOWS // wb} "
            f"dispatches, host syncs per window {1 / wb:g}; {card}")
    for (wb, k), runs in sorted(walls.items()):
        # the probe reads the first block's pull; each block's enqueue
        # wall shows whether a later dispatch waited for the device
        if wb > 1:
            log(f"[sharded] 6a W={wb}, {k} shard(s): depth probes "
                + "; ".join(f"dispatch {p['dispatch_s'] * 1e3:.3f} ms, pull "
                            f"{p['pull_s'] * 1e3:.3f} ms, host "
                            f"{p['host_s'] * 1e3:.3f} ms -> depth "
                            f"{p['depth']}, each block's dispatch "
                            f"{[round(d, 3) for d in disp]} ms"
                            for _, _, p, disp in runs))
    shard_fold_split(main, devs, device, card)
    log(f"[sharded] 6a records of {SHARDS} shards bitwise equal to the "
        f"unsharded run's at W = 1 and 4; means within {MAIN_RTOL:g} of "
        f"phase 3's (stat_blocks 1)")
    shard_kernel_split(main, device, card)

    # 6b: the other three engine kernels, sharded
    sparse = Experiment(model=MODELS[SPARSE_MODEL](),
                        ensemble=Ensemble.make(replicas=SPARSE_REPLICAS),
                        schedule=Schedule(t_end=SPARSE_T_END,
                                          n_windows=SPARSE_WINDOWS),
                        n_lanes=1024, sparse=True, use_kernel=True)
    cases = (
        ("tau_window", "lv8 tau", main.with_(method=Method.TAU_LEAP),
         SHARDS, tau_window_call, None),
        ("sparse_window", "ring80 sparse exact", sparse, SPARSE_SHARDS,
         sparse_window_call, 2),
        ("sparse_tau_window", "ring80 sparse tau",
         sparse.with_(method=Method.TAU_LEAP), SPARSE_SHARDS,
         sparse_tau_window_call, 2))
    for name, label, exp, k, counter, cut in cases:
        kw = {} if cut is None else {"max_windows": cut}
        n_win = cut or exp.schedule.n_windows
        base, _ = run_counted(sharded(exp, 1), counter, device, **kw)
        res, n = run_counted(sharded(exp, k), counter,
                             shard_devices(k, device), **kw)
        if n != n_win * k:
            raise AssertionError(f"6b {label}: {n} launches for {n_win} "
                                 f"windows x {k} shards")
        if not records_equal(res.records, base.records):
            raise AssertionError(f"6b {label}: records of {k} shards "
                                 "differ from the unsharded run's")
        if res.telemetry.dispatches != n_win:
            raise AssertionError(f"6b {label}: dispatches differ")
        launches[name] += n
        log(f"[sharded] 6b {label}, {k} shards, {n_win} windows: {n} "
            f"launches, records bitwise equal to the unsharded run's; "
            f"wall per window {res.telemetry.wall_time_s / n_win * 1e3:.3f}"
            f" ms against {base.telemetry.wall_time_s / n_win * 1e3:.3f} "
            f"unsharded; {card}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    try:
        # 6c: reshard-on-restore, a 4-shard save at window 4 resumed at
        # 1 and at 2 shards
        from repro_torch.api import simulate

        path = f"{tmp}/four"
        part = simulate(sharded(main, SHARDS), device=devs, max_windows=4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        part.checkpoint(path)
        save_s = time.perf_counter() - t0
        for k in (1, 2):
            exp = sharded(main, k)
            eng = build_engine(exp, device=shard_devices(k, device))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.restore(path)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            res = SimulationResult(exp, eng).resume()
            if not records_equal(res.records, ref):
                raise AssertionError(f"6c: the run resumed at {k} shards "
                                     "differs from 6a's")
            log(f"[sharded] 6c a {SHARDS}-shard save at window 4: "
                f"{save_s:.3f} s; restored at {k} shard(s) in "
                f"{restore_s:.3f} s, records bitwise equal to 6a's; {card}")

        # 6d: supervised runs on 6a's cell
        drills = (("crash", {2: "crash", 5: "ckpt_corrupt"}),
                  ("shard loss", {3: "device_lost", 6: "device_lost"}),
                  ("nan pool", {4: "nan_pool"}))
        for label, plan in drills:
            rec = Recovery(ckpt_dir=f"{tmp}/{label.replace(' ', '_')}",
                           cadence=2, keep_last=2,
                           inject=FailurePlan(schedule=plan))
            exp = sharded(main, SHARDS).with_(recovery=rec)
            sup = RunSupervisor(exp, rec, device=devs)
            t0 = time.perf_counter()
            res = sup.run()
            wall = time.perf_counter() - t0
            rep = res.recovery_report()
            if not records_equal(res.records, ref):
                raise AssertionError(f"6d {label}: records differ from "
                                     "6a's clean run")
            shrinks = [(e["from_shards"], e["to_shards"])
                       for e in rep["events"] if e["event"] == "degraded"]
            if label == "crash" and rep["restarts"] != 2:
                raise AssertionError("6d crash: restarts != 2")
            if label == "shard loss" and (
                    shrinks != [(4, 2), (2, 1)]
                    or rep["final_n_shards"] != 1):
                raise AssertionError(f"6d shard loss: degraded {shrinks}")
            if label == "nan pool" and \
                    rep["faults_by_kind"].get("nan_pool", 0) < 1:
                raise AssertionError("6d nan pool: the guard caught nothing")
            log(f"[sharded] 6d drill {label} {plan}: {rep['restarts']} "
                f"restarts, faults {rep['faults_by_kind']}"
                + (f", shards {shrinks}" if shrinks else "")
                + f", records bitwise equal to 6a's; run wall {wall:.3f} s; "
                "recoveries (teardown, rebuild, restore s): "
                + ", ".join(f"({a:.4f}, {b:.3f}, {c:.3f})"
                            for a, b, c in sup.recovery_walls) + f"; {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, ref


# phase 7: the multi-process farm
FARM_WORKERS = 4
FARM_HEARTBEAT_S = 0.5


def farm_recovery(path, schedule=None, **kw):
    """Phase 7's Recovery: FARM_WORKERS worker processes, a checkpoint
    every window, a heartbeat every FARM_HEARTBEAT_S / 2 s, no backoff;
    `schedule` drills process faults."""
    from repro_torch.api import FailurePlan, Recovery

    kw.setdefault("cadence", 1)
    return Recovery(ckpt_dir=path, workers=FARM_WORKERS,
                    heartbeat_s=FARM_HEARTBEAT_S, keep_last=3,
                    backoff_base_s=0.0,
                    inject=(FailurePlan(schedule=schedule)
                            if schedule else None), **kw)


def timed_simulate(exp, device):
    """(result, host wall s of the whole simulate() call, the engine's
    build and, for a farm, its processes included)."""
    import torch

    from repro_torch.api import simulate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate(exp, device=device)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def farm_launches(res, n_blocks, label, device) -> int:
    """Check a farm run's workers: each launched the window kernel once
    per window (its own counter, in its bundle; set to 0 by the fresh
    process), and all together dispatched and synced once per block.
    Returns the launches."""
    import torch

    rep = res.recovery_report()
    want = MAIN_WINDOWS if torch.device(device).type == "cuda" else 0
    got = [rep["kernel_launches"][k]["ssa_window"]
           for k in range(FARM_WORKERS)]
    if got != [want] * FARM_WORKERS:
        raise AssertionError(f"{label}: the workers' kernel launches {got} "
                             f"for {MAIN_WINDOWS} windows each")
    t = res.telemetry
    if not t.dispatches == t.host_syncs == FARM_WORKERS * n_blocks:
        raise AssertionError(
            f"{label}: {t.dispatches} dispatches, {t.host_syncs} host syncs "
            f"over {FARM_WORKERS} workers for {n_blocks} blocks each")
    return sum(got)


def drill_times(rep) -> str:
    """A drill's recovery from its event log: the fault's detection after
    the injection, the relaunch after the detection, and the faulted
    shard's end after its relaunch (host clock, s)."""
    ev = rep["events"]
    inj = next(e for e in ev if e["event"] == "fault_injected")
    fault = next(e for e in ev if e["event"] == "fault")
    relaunch = next(e for e in ev if e["event"] == "worker_launched"
                    and e["shard"] == fault["shard"] and e["t"] >= fault["t"])
    done = [e for e in ev if e["event"] == "worker_done"
            and e["shard"] == fault["shard"]][-1]
    return (f"detected {fault['t'] - inj['t']:.3f} s after the injection, "
            f"relaunched {relaunch['t'] - fault['t']:.3f} s later, the shard "
            f"done {done['t'] - relaunch['t']:.3f} s after that")


def phase_farm(device, ref_recs, tol, card) -> int:
    """Phase 7: the multi-process farm on the card, every worker on
    `device`, each run bitwise against its single-process run at the
    same stat_blocks. Returns the workers' window-kernel launches in
    7a and 7b."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.api import (
        CsvSink,
        Ensemble,
        Experiment,
        Partitioning,
        Schedule,
        Steering,
    )
    from repro_torch.core.cwc.models import MODELS

    main = Experiment(model=MODELS[MAIN_MODEL](),
                      ensemble=Ensemble.make(replicas=MAIN_REPLICAS),
                      schedule=Schedule(t_end=MAIN_T_END,
                                        n_windows=MAIN_WINDOWS),
                      n_lanes=1024, use_kernel=True,
                      partitioning=Partitioning(n_shards=1,
                                                stat_blocks=SHARD_BLOCKS))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_farm_")
    launches = 0
    try:
        # 7a: phase 3's cell at FARM_WORKERS workers
        single, single_s = timed_simulate(main, device)
        if not records_equal(single.records, ref_recs):
            raise AssertionError("7a: the single-process run differs from "
                                 "6a's")
        farm, farm_s = timed_simulate(
            main.with_(recovery=farm_recovery(f"{tmp}/a")), device)
        rep = farm.recovery_report()
        if not records_equal(farm.records, ref_recs):
            raise AssertionError("7a: the farm's records differ from 6a's")
        if rep["restarts"] or rep["faults_by_kind"]:
            raise AssertionError(f"7a: a fault-free farm restarted "
                                 f"({rep['faults_by_kind']})")
        if sorted({w["device"] for w in rep["per_worker"].values()}) \
                != [str(device)]:
            raise AssertionError(f"7a: workers ran on {rep['per_worker']}")
        launches += farm_launches(farm, MAIN_WINDOWS, "7a", device)
        startup = [rep["worker_lifetimes"][k] - rep["worker_walls"][k]
                   for k in range(FARM_WORKERS)]
        phases = [(round(rep["worker_startup"][k]["imports_s"], 3),
                   round(rep["worker_startup"][k]["device_s"], 3))
                  for k in range(FARM_WORKERS)]
        log(f"[farm] 7a lv8 x {MAIN_REPLICAS} exact at {FARM_WORKERS} "
            f"worker processes on {device}, stat_blocks={SHARD_BLOCKS}, a "
            f"checkpoint every window: records bitwise equal to 6a's; "
            f"{MAIN_WINDOWS} launches and {MAIN_WINDOWS} host syncs in "
            f"every worker; wall {farm_s:.3f} s against {single_s:.3f} s "
            f"in one process; each worker's lifetime "
            f"{[round(rep['worker_lifetimes'][k], 3) for k in range(FARM_WORKERS)]}"
            f" s, run wall (build, windows, saves) "
            f"{[round(rep['worker_walls'][k], 3) for k in range(FARM_WORKERS)]}"
            f" s, start-up {[round(x, 3) for x in startup]} s (of which "
            f"the interpreter and imports, then the spec and the CUDA "
            f"context: {phases} s); merge "
            f"{rep['merge_s'] * 1e3:.3f} ms; {card}")

        # 7b: phase 5a's steered, sketched sweep at FARM_WORKERS workers
        sexp = steer_experiment(
            steering=Steering(ci_rel_tol=tol, min_windows=4,
                              bimodality=True),
            partitioning=Partitioning(n_shards=1, stat_blocks=SHARD_BLOCKS))
        s_single, s_single_s = timed_simulate(sexp, device)
        s_farm, s_farm_s = timed_simulate(
            sexp.with_(recovery=farm_recovery(f"{tmp}/b", cadence=4)),
            device)
        rep_b = s_farm.steering_report()
        pa, pb = s_single.per_point(), s_farm.per_point()
        if not (records_equal(s_farm.records, s_single.records)
                and all(pa[f].tobytes() == pb[f].tobytes()
                        for f in ("n", "mean", "var", "ci90"))
                and sketches_equal(s_farm.sketches(), s_single.sketches())
                and rep_b == s_single.steering_report()):
            raise AssertionError("7b: the steered farm differs from its "
                                 "single-process run")
        if not rep_b["stopped_points"]:
            raise AssertionError("7b: no point stopped")
        if s_farm.recovery_report()["restarts"]:
            raise AssertionError("7b: a fault-free farm restarted")
        launches += farm_launches(s_farm, MAIN_WINDOWS // 4, "7b", device)
        log(f"[farm] 7b the steered, sketched sweep of 5a ({len(STEER_VALUES)}"
            f" points, PER_POINT, window_block 4, tolerance {tol:.6g}, "
            f"bimodality) at {FARM_WORKERS} workers: records, per-point "
            f"stats, sketches and the steering report bitwise equal to the "
            f"single-process run's (stopped {rep_b['stopped_points']} at "
            f"{rep_b['stop_windows']}); one host sync per block in every "
            f"worker; wall {s_farm_s:.3f} s against {s_single_s:.3f} s; "
            f"merge {s_farm.recovery_report()['merge_s'] * 1e3:.3f} ms; "
            f"{card}")

        # 7c: the process drills on 7a's cell
        drills = (("kill", {2: "host_lost"}, {}),
                  ("stop", {2: "worker_stall"}, {}),
                  ("corrupt", {3: "ckpt_corrupt"}, {}),
                  ("reassign", {2: "host_lost"},
                   {"max_worker_restarts": 0}))
        for label, plan, kw in drills:
            res, wall = timed_simulate(main.with_(recovery=farm_recovery(
                f"{tmp}/{label}", plan, **kw)), device)
            rep = res.recovery_report()
            if not records_equal(res.records, ref_recs):
                raise AssertionError(f"7c {label}: records differ from 6a's")
            inj = [e for e in rep["events"] if e["event"] == "fault_injected"]
            if not inj or rep["restarts"] < 1:
                raise AssertionError(f"7c {label}: the fault did not land "
                                     f"({rep['events']})")
            if label == "stop" and not rep["faults_by_kind"].get(
                    "worker_stall"):
                raise AssertionError("7c stop: no stall was seen")
            if label == "corrupt" and not any(
                    e["event"] == "corrupt_checkpoint_skipped"
                    for e in rep["worker_reports"][inj[0]["shard"]]["events"]):
                raise AssertionError("7c corrupt: no corrupt file skipped")
            if label == "reassign" and rep["reassignments"] < 1:
                raise AssertionError("7c reassign: no shard moved")
            log(f"[farm] 7c drill {label} {plan}: {rep['restarts']} "
                f"restart(s), faults {rep['faults_by_kind']}, "
                f"{rep['reassignments']} reassignment(s), records bitwise "
                f"equal to 6a's; wall {wall:.3f} s ({wall - farm_s:+.3f} s "
                f"against 7a); {drill_times(rep)}; {card}")

        # 7d: the command line at 7a's size
        csv = f"{tmp}/cli.csv"
        cmd = [sys.executable, "-m", "repro_torch.launch.simulate",
               "--model", MAIN_MODEL, "--replicas", str(MAIN_REPLICAS),
               "--t-end", str(MAIN_T_END), "--windows", str(MAIN_WINDOWS),
               "--lanes", "1024", "--kernel", "--devices", "1",
               "--stat-blocks", str(SHARD_BLOCKS), "--workers",
               str(FARM_WORKERS), "--recover-dir", f"{tmp}/cli",
               "--device", str(device), "--out", csv]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True,
                              text=True, timeout=600, env=dict(
                                  os.environ, PYTHONPATH=str(SRC)))
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"7d: the command line exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        want = f"{tmp}/want.csv"
        sink = CsvSink(want, single.obs_names)
        for r in ref_recs:
            sink(r)
        sink.close()
        with open(csv) as a, open(want) as b:
            if a.read() != b.read():
                raise AssertionError("7d: the command line's CSV differs "
                                     "from 7a's records")
        log(f"[farm] 7d python -m repro_torch.launch.simulate --workers "
            f"{FARM_WORKERS} at 7a's size: CSV equal to 7a's records as "
            f"CsvSink writes them; {cli_s:.3f} s; its summary: "
            f"{proc.stdout.splitlines()[0]}; {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


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
    phase_supersteps(device, dense["records"], tau_sparse["records"], card)
    tol = phase_steering(device, card)
    phase_steer_tau(device, tau_dense["win_ms"], card)
    phase_sketch_sparse(device, sparse["records"], sparse["win_ms"], card)
    shard_launches, shard_ref = phase_sharded(device, dense["records"], card)
    shard_launches["ssa_window"] += phase_farm(device, shard_ref, tol, card)
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
        "launches": nums["launches"] + shard_launches.get(name, 0),
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
