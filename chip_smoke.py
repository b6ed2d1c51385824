#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. build   — compile the kernel library from every source under
             `src/repro_torch/kernels/csrc` (one `nvcc -shared --threads
             0` call over all of them, `kernels/build.py`) and the dense
             SSA window generated for lv8 (`kernels/netgen.py`); print
             the seconds, ptxas's reports and the card's name and power
             limit.
2. kernels — hold each kernel bitwise against its plain torch twin on the
             card, printing the count of differing elements:
             the dense SSA window, generated and table-driven, on lv8
             (65,536 lanes, per-lane sweep rates), ecoli, transport, a
             budget cut and a system with reactant coefficients 3 and 4;
             the sparse SSA window on
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
             kernel, its route); on 3, the generated kernel against the
             table kernel too, timed in turns, each with its operand
             bound once outside the timing.
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
8. examples — each `examples/torch_*.py` through its main() on the
             card, as written (use_kernel=False) and with use_kernel=True
             (the window kernel at each example's own shapes: R = 2,
             per-lane sweep rates, 100 lanes): the pool and the record
             means bit for bit, var and ci90 bit for bit or within the
             API tests' ulp tier (each differing field, window and ulps
             printed), per-point means bit for bit, the E. coli CSV's text
             the same; then one seed of the sequential oracle on the host
             against `run_reference_trajectory` on the card (walls only).
9. llm     — llama3-8b at full width (32 layers, d_model 4096, bf16)
             from a seeded torch.Generator on the card: 4 prompts of 512
             tokens prefilled into a 544-slot cache, 32 greedy decode
             steps; every logit finite; the first decode step against
             forward on the 513 tokens (at full depth, whose random
             weights are chaotic, the logits spread is printed and layer
             0's decoded K/V are gated; the logits are gated on the same
             config cut to 2 layers) and a 4,096-token prompt's chunked
             layer-0 attention against full attention, each within its
             stated bound; prefill ms and tokens/s, decode ms a step,
             each beside its bound, and the peak memory.
9b. llm parity — each dense, VLM and MoE config at its smoke size in
             float32, the same weights on the card and the CPU: the MoE
             configs' expert ids first (equal in every layer), then
             forward, prefill (cache, last logits) and a decode step
             within rtol = atol = 2e-4; gemma's smoke size in bf16 (tied
             embeddings) within 2^-5 of the largest logit.
10. moe    — olmoe-1b-7b, then deepseek-moe-16b (the first freed
             before the second is built), at full width from seeded
             weights with phase 9's requests: one MoE layer through
             apply_moe against moe_dense_oracle at a capacity where
             nothing drops; prefill timed and rerun bit for bit, the
             share of routed entries dropped and the aux loss layer by
             layer; 32 greedy decode steps; layer 0's decoded K/V at full
             depth and decode against forward on the config cut to 2
             layers (expert ids compared); prefill ms and tokens/s
             against 2 x the parameters a token runs (the experts at E x
             capacity slots) at the bf16 peak, decode ms against all
             weights and against the routed experts' alone at 3.35 TB/s,
             and the peak memory.
11. train  — olmoe-1b-7b at full width cut to 4 of its 16 layers: 10
             AdamW steps of synth_batch 8 x 1024 at grad_accum 2 over 4
             repeated batches (the loss must fall), step ms and tokens/s
             against 6 x active parameters x tokens at the bf16 peak,
             the peak memory; the trained state saved and restored
             through the pytree store (bitwise, with the times and the
             size); accum 2 against accum 1 on one batch; the crash
             drill of tests/test_train.py on the olmoe smoke config.
             Prints the two phases' total.
12. mesh   — the multi-device pieces, one process over a mesh of
             cuda:0..3 when four cards are visible, else of repeated
             entries of cuda:0 (printed), each shard's body in mesh
             order. 12a: olmoe-1b-7b at full width on a (1, 4) (data,
             model) mesh with experts split over model: one MoE layer on
             phase 10's 2,048-token prefill input (the EP path) and on a
             4-token decode input (EP-small), each against the one-device
             apply_moe and moe_dense_oracle at capacity factor E/k
             (nothing drops); phase 10's requests served on the mesh at
             the config's capacity (prefill rerun bitwise, drops by model
             shard, 32 greedy decode steps, logits finite); the config cut
             to 2 layers at factor E/k against the one-device model
             (expert sets compared by layer: a changed set only at a
             near-tie or downstream of an earlier change in its
             sequence; rank swaps counted; logits within phase 9's
             bound). 12b:
             deepseek-moe-16b the same on (2, 2) with expert_parallel off
             (TP-in-expert, shared experts split over model, the batch
             over data). 12c: llama3-8b decoding with its 544-slot cache
             split 4 x 136 over model on (1, 4) and over data on (4, 1),
             fed the one-device greedy run's tokens: layer 0's decoded K/V
             bitwise, the 2-layer cut's logits within phase 9's bound.
             12d: make_dp_train_step on olmoe-1b-7b cut to 2 layers over
             2 shards: 5 steps of synth_batch 8 x 1024 with int8 error
             feedback (the loss falls, a rerun bitwise), compress=False
             against make_train_step on the whole batch in float32, the
             step's ms beside phase 11's and the one device's at
             grad_accum 2, the compression's own ms. 12e: merge_over_axis
             of phase 3's observables over 8 shards, bitwise against
             merge_blocks. Each sub-phase's wall and peak memory, and the
             phase's total.
13. the dense layers placed by their specs (tensor-parallel attention,
             MLP, embedding and logits, FSDP parameters) over four entries
             of cuda:0, or cuda:0..3 where four cards are visible. 13a:
             llama3-8b at full width (32 layers, bf16, phase 9's seed)
             served on (1, 4) under dp_tp and on (2, 2) under fsdp_tp:
             phase 9's 4 x 512 prompts and 32 decode steps fed the
             one-device greedy run's tokens, the cache split by
             cache_shardings; layer 0's K/V against the one-device run
             (bitwise or within one bf16 rounding, printed which), a
             rerun bitwise, the full-depth spread printed; prefill and
             decode ms and peak memory beside phases 9 and 12c; the
             2-layer float32 cut against one device within 4 times the
             one-device model's own distance from its float64
             evaluation (f64_llama; a bf16 model's printed beside it).
             13b: the fsdp_tp train step of llama3-8b cut to 4 layers on
             (2, 2): 10 steps of synth_batch 8 x 1024 at grad_accum 4
             (the loss falls, a rerun bitwise), the step's ms beside the
             same cut's one-device step, peak memory; the 2-layer
             float32 cut: each parameter's gradient on one microbatch
             against one device within 4 times the leaf's float32
             control (one device against float64; bf16 printed), 3 steps'
             losses against make_train_step, and its placed state saved
             and restored (bitwise).
14. report — one JSON line of per-kernel numbers (launches: the main
             paths', phase 6's counted sharded runs', the workers' of
             7a and 7b and phase 8's use_kernel=True runs, each from its
             own counter), the card line, then the result line.

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
    # the dense exact kernel generated for the main path's network
    from repro_torch.core.gillespie import system_tensors
    from repro_torch.kernels import netgen

    system = system_of(MAIN_MODEL)
    src = netgen.window_source(netgen.network(*system_tensors(system)[:3]))
    t0 = time.perf_counter()
    build.load_network(src)
    lib = build.network_library_path(src)
    log(f"[build] the ssa_window kernel generated for {MAIN_MODEL} (S="
        f"{system.n_species}, R={system.n_reactions}) built in "
        f"{time.perf_counter() - t0:.2f} s: {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if any(w in line for w in ("registers", "spill", "stack frame")):
            log(f"[build] {MAIN_MODEL} generated: {line.strip()}")


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
        ssa_window_tables,
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
        t = ssa_window_tables(*args, horizon, n_steps=n_steps)
        p = ssa_window_plain(*args, horizon, n_steps=n_steps)
        label = (f"{name} B={CHECK_LANES} rates="
                 f"{'(B,R)' if per_lane else '(R,)'}")
        check("ssa_window", f"{label} generated", k, p, horizon, n_steps)
        check("ssa_window", f"{label} table kernel", t, p, horizon, n_steps)

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
        bind_network,
        dense_dep_mask,
        ssa_window_call,
        ssa_window_plain,
        ssa_window_tables,
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
    # each kernel's bound operand, bound once as FusedDispatch binds it
    net = bind_network(idx, coef, delta)
    dep_mask = dense_dep_mask(idx, coef, delta)
    generated = lambda: ssa_window_call(*args, horizon, n_steps=n_steps,
                                        net=net)
    k_ms, p_ms, out, err = time_against_twin(
        "main", generated,
        lambda: ssa_window_plain(*args, horizon, n_steps=n_steps))
    # the table kernel on the same window, timed in turns with the
    # generated one (tables, generated, tables)
    tables = lambda: ssa_window_tables(*args, horizon, n_steps=n_steps,
                                       dep_mask=dep_mask)
    n_diff, _ = bitwise_diff(tables(), out)
    if n_diff:
        raise AssertionError(f"main: the table kernel and the generated "
                             f"kernel disagree in {n_diff} elements")
    t_ms = cuda_ms(tables, reps=5)
    k_ms = (k_ms + cuda_ms(generated, reps=5)) / 2
    t_ms = (t_ms + cuda_ms(tables, reps=5)) / 2
    active = int(((out[4].long() - pool.ctr.long()) & 0xFFFFFFFF).sum())
    fired = int(out[3].sum())
    ops = ops_per_step(eng.system, sparse_tables(eng.system))
    b, s = pool.x.shape
    n_bytes = pool_bytes(b, s) + nbytes(idx, coef, delta, eng._rates_dev,
                                        dep_mask)
    bound, by, detail = bound_of(
        n_bytes, active * ops["step"] + fired * ops["fired"]
        + b * ops["seed"], active * ops["i_step"])
    log(f"[main] one window at full width: generated kernel {k_ms:.3f} "
        f"ms, table kernel {t_ms:.3f} ms (0 differing elements), plain "
        f"twin {p_ms:.1f} ms, 0 differing elements; {active} active lane "
        f"steps, {fired} events; bound {bound:.4f} ms ({detail}); the "
        f"same window took {win0_ms:.3f} ms end to end, kernel share "
        f"{k_ms / win0_ms:.4f}")
    return dict(launches=nums["launches"], ms=k_ms, tables_ms=t_ms,
                plain_ms=p_ms, bound_ms=bound, bound_by=by, err=err,
                steps=nums["steps"], win_ms=nums["win_ms"],
                records=nums["records"],
                final_x=nums["final_x"])


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
                    f"windows, dispatch ms): "
                    + ", ".join(f"({w0}, {n}, {d * 1e3:.3f})"
                                for w0, n, d in bw))

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
    from repro_torch.kernels.ssa_step import bind_network, ssa_window_call

    eng = build_engine(exp, device=device)
    idx, coef, delta, rates = eng._tensors_base
    net = bind_network(idx, coef, delta)
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
                rates, horizon, n_steps=n_steps, net=net)

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


def fault_events(rep) -> str:
    """A farm report's faults by kind and each fault event's worker,
    window and error, for a gate's message."""
    faults = [(e["kind"], e["worker"], e["window"], e["error"])
              for e in rep["events"] if e["event"] == "fault"]
    return f"{rep['faults_by_kind']}: {faults}"


def quiet_spans(rep) -> list:
    """Each worker's span from its last heartbeat to the coordinator's
    poll that saw it exit (its bundle's write and its exit), s."""
    return [e["quiet_s"] for e in rep["events"]
            if e["event"] == "worker_done"]


def heartbeat_spans(rep) -> list:
    """Each worker's longest span between two heartbeat writes while
    running and its longest write, s (the staleness limit is 3 x
    FARM_HEARTBEAT_S)."""
    return [(round(h["max_gap_s"].get("run", 0.0), 3),
             round(h["max_write_s"], 4))
            for _, h in sorted(rep["heartbeats"].items())]


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
                                 f"({fault_events(rep)})")
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
            f"context: {phases} s); each worker's longest span between "
            f"heartbeats while running and longest heartbeat write "
            f"{heartbeat_spans(rep)} s (limit {3 * FARM_HEARTBEAT_S} s); "
            f"from each worker's last heartbeat to the poll that saw it "
            f"exit {quiet_spans(rep)} s; merge "
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
        rep_fb = s_farm.recovery_report()
        if rep_fb["restarts"] or rep_fb["faults_by_kind"]:
            raise AssertionError(f"7b: a fault-free farm restarted "
                                 f"({fault_events(rep_fb)})")
        launches += farm_launches(s_farm, MAIN_WINDOWS // 4, "7b", device)
        log(f"[farm] 7b the steered, sketched sweep of 5a ({len(STEER_VALUES)}"
            f" points, PER_POINT, window_block 4, tolerance {tol:.6g}, "
            f"bimodality) at {FARM_WORKERS} workers: records, per-point "
            f"stats, sketches and the steering report bitwise equal to the "
            f"single-process run's (stopped {rep_b['stopped_points']} at "
            f"{rep_b['stop_windows']}); one host sync per block in every "
            f"worker; wall {s_farm_s:.3f} s against {s_single_s:.3f} s; "
            f"heartbeat spans while running and writes "
            f"{heartbeat_spans(rep_fb)} s; from each worker's last "
            f"heartbeat to its exit {quiet_spans(rep_fb)} s; merge "
            f"{rep_fb['merge_s'] * 1e3:.3f} ms; {card}")

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


# phase 8: the examples, as written and with the window kernel
EXAMPLES = ("quickstart", "lotka_volterra_sweep", "ecoli_gene_regulation")
# tests/test_torch_api.py's tier for record var and ci90 against the
# reference, should the kernel path's differ from the unfused one's
EXAMPLE_VAR_ULP = 12
EXAMPLE_CI90_ULP = 8
# phase 9: llama3-8b serving at full width
LLM_ARCH = "llama3-8b"
LLM_SEED = 0
LLM_BATCH = 4
LLM_PROMPT = 512
LLM_CACHE = 544
LLM_DECODE = 32
LLM_LONG = 4096
# dense bf16 tensor-core peak of the H100 SXM (data sheet, no sparsity)
PEAK_BF16_OPS = 989e12
# Decode against forward, each as max |difference| over max |forward's|.
# With the reference's init (fan_in of wq is n_heads: attention scores
# of std ~250, softmax one-hot) the 32 layers are chaotic: a rounding
# difference grows e-fold a layer, to O(1) by layer 8 in bf16 and in
# float32 alike (measured on an H100). So the full-depth
# logits spread is printed, the full-depth gate is the first decode
# step's layer-0 K and V against forward's (bf16: 3.2e-4, 7.6e-4), and
# the logits gate runs on the same full-width config cut to
# LLM_CHECK_LAYERS layers, at the reference's test's 2e-2.
LLM_LAYER0_TOL = 2 ** -7
LLM_CHECK_LAYERS = 2
LLM_DECODE_TOL = 2e-2
# layer 0's chunked attention against full attention on the same q, k, v
LLM_CHUNK_TOL = 2 ** -6
# phase 9b: the module on the card against the same module on the CPU
LLM_DENSE = ("llama3-8b", "gemma-7b", "command-r-35b", "starcoder2-7b",
             "internvl2-1b")
LLM_F32_TOL = 2e-4  # rtol and atol, as tests/test_torch_models.py
LLM_BF16_TOL = 2 ** -5  # max |difference| over max |logit|
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-moe-16b")
# phase 10: the mixture-of-experts configs serving at full width, with
# phase 9's requests. One MoE layer through apply_moe against
# moe_dense_oracle at a capacity where nothing drops: the two products
# accumulate in float32 and round the layer's output to bf16 once, in
# other orders, so they may differ by a bf16 rounding of the output:
# max |diff| over max |y| within MOE_LAYER_TOL.
MOE_LAYER_TOL = 2 ** -7
# phase 11: the one-card trainer on olmoe-1b-7b at full width, cut to
# TRAIN_LAYERS of its 16 layers (the full model's state does not fit one
# card), synth_batch TRAIN_BATCH x TRAIN_SEQ at the registry's
# grad_accum, TRAIN_STEPS steps over TRAIN_DATA repeated batches
TRAIN_ARCH = "olmoe-1b-7b"
TRAIN_LAYERS = 4
TRAIN_BATCH = 8
TRAIN_SEQ = 1024
TRAIN_STEPS = 10
TRAIN_DATA = 4
TRAIN_LR = 1e-3
TRAIN_WARMUP = 2
# accum 2 against accum 1 on one batch, in float32 without the
# per-microbatch aux loss and drops: the parameters after one step
# within tests/test_train.py's 2e-5 (bf16 gradients near zero change
# sign between the two, and Adam's first step moves each entry by about
# lr·sign(g), so a bf16 comparison would measure rounding, not the
# accumulation)
TRAIN_ACCUM_ATOL = 2e-5
# ...on the config cut to TRAIN_ACCUM_LAYERS layers: in float32 the
# 4-layer state, a copy of its params and two microbatches' float32
# activations do not fit the card
TRAIN_ACCUM_LAYERS = 2
# the crash drill (tests/test_train.py's case on the olmoe smoke config,
# float32, on the card): losses within its rtol and atol
DRILL_RTOL, DRILL_ATOL = 1e-4, 1e-5


class MoeProbe:
    """Records each routed MoE call in order while it is open: the kept
    share of the dispatch, the aux loss, and the router's (probs, expert
    ids), by wrapping `models.moe._dispatch`, `_aux_loss` and `route`,
    which `moe_routed_local` looks up at each call. Appends only: no
    host sync."""

    def __enter__(self):
        from repro_torch.models import moe

        self.keep, self.aux, self.routes = [], [], []
        self._saved = dispatch, aux_loss, route = (
            moe._dispatch, moe._aux_loss, moe.route)

        def rec_dispatch(*args, **kw):
            out = dispatch(*args, **kw)
            self.keep.append(out[3].float().mean())
            return out

        def rec_aux(probs, ids, cfg):
            a = aux_loss(probs, ids, cfg)
            self.aux.append(a)
            return a

        def rec_route(params, x, cfg):
            out = route(params, x, cfg)
            self.routes.append((out[0], out[2]))
            return out

        moe._dispatch, moe._aux_loss, moe.route = (rec_dispatch, rec_aux,
                                                   rec_route)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._dispatch, moe._aux_loss, moe.route = self._saved


def route_margin(probs, k):
    """Per token: the k-th largest router probability less the
    (k+1)-th (how near the top-k choice is to a tie)."""
    import torch

    top = torch.topk(probs.float(), k + 1, dim=-1).values
    return top[..., k - 1] - top[..., k]


def compare_routes(a, b, k, rows=None) -> tuple[int, float]:
    """(differing expert ids, the smallest margin among the tokens that
    differ, else -1) of two probes' routes, layer by layer; `rows`
    picks b's rows that a's rows stand for."""
    n, worst = 0, -1.0
    for (pa, ia), (pb, ib) in zip(a.routes, b.routes):
        ib_sel = ib if rows is None else ib[rows]
        bad = (ia.cpu() != ib_sel.cpu()).any(dim=-1)
        if bool(bad.any()):
            n += int(bad.sum())
            m = float(route_margin(pa.cpu(), k)[bad].min())
            worst = m if worst < 0 else min(worst, m)
    return n, worst


def layer_kvs(cache, kv) -> list:
    """The cache's `kv` leaf of every layer, in layer order."""
    out = [whole_leaf(c[kv]) for c in cache["prefix"]]
    stack = cache.get("stack", {})
    stack = {name: {k: whole_leaf(t) for k, t in e.items()}
             for name, e in stack.items()}
    n_rep = next(iter(stack.values()))[kv].shape[0] if stack else 0
    for r in range(n_rep):
        out.extend(stack[name][kv][r]
                   for name in sorted(stack, key=lambda n: int(n[1:])))
    return out


def max_ulp(a, b) -> int:
    import numpy as np

    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def run_example(name, device, **kw):
    """(result, wall s, window-kernel launches) of one
    examples/torch_<name>.py main() on `device`, its printing
    swallowed."""
    import contextlib
    import io
    import runpy

    import torch

    from repro_torch.kernels.ssa_step import ssa_window_call

    main = runpy.run_path(str(ROOT / "examples" / f"torch_{name}.py"))[
        "main"]
    ssa_window_call.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = main(device=device, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, ssa_window_call.launches


def phase_examples(device, card) -> int:
    """Phase 8: each examples/torch_*.py through its main() on the card,
    as written (use_kernel=False) and with use_kernel=True: pool state
    and record means bit for bit, var and ci90 bit for bit or at the API
    tests' tier (each differing field, window and ulps printed), the
    E. coli CSV's text the same; then one seed of the sequential oracle
    on the host against `run_reference_trajectory` on the card (walls
    only: the two agree statistically, not bit for bit). Returns the
    window kernel's launches in the use_kernel=True runs."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.cwc import reference
    from repro_torch.core.cwc.compile import compile_model
    from repro_torch.core.cwc.models import ecoli_gene_regulation
    from repro_torch.core.gillespie import LaneState, run_reference_trajectory

    launches = 0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    try:
        for name in EXAMPLES:
            runs = []
            for use_kernel in (False, True):
                kw = {"use_kernel": use_kernel}
                if name == "ecoli_gene_regulation":
                    kw["out"] = f"{tmp}/ecoli_{int(use_kernel)}.csv"
                runs.append(run_example(name, device, **kw))
            (plain, p_s, p_l), (fused, f_s, f_l) = runs
            n_win = len(plain.records)
            eng = fused._engine
            if p_l != 0 or f_l < n_win:
                raise AssertionError(
                    f"8 {name}: {p_l} kernel launches as written, {f_l} "
                    f"with use_kernel=True for {n_win} windows")
            launches += f_l
            differ = [f for f in LaneState._fields if not torch.equal(
                getattr(plain._engine._pool, f), getattr(eng._pool, f))]
            if differ:
                raise AssertionError(f"8 {name}: the kernel path's pool "
                                     f"differs from the unfused one's in "
                                     f"{differ}")
            if plain.means().tobytes() != fused.means().tobytes() or [
                    (r.t, r.window, r.n) for r in plain.records] != [
                    (r.t, r.window, r.n) for r in fused.records]:
                raise AssertionError(f"8 {name}: record means differ")
            notes = []
            for field, tier in (("var", EXAMPLE_VAR_ULP),
                                ("ci90", EXAMPLE_CI90_ULP)):
                for a, b in zip(plain.records, fused.records):
                    u = max_ulp(getattr(a, field), getattr(b, field))
                    if u:
                        notes.append(f"{field} window {a.window} {u} ulp")
                    if u > tier:
                        raise AssertionError(
                            f"8 {name}: {field} of window {a.window} "
                            f"differs by {u} ulp (tier {tier})")
            if plain.per_point() is not None:
                pp, fp = plain.per_point(), fused.per_point()
                if pp["mean"].tobytes() != fp["mean"].tobytes():
                    raise AssertionError(f"8 {name}: per-point means "
                                         "differ")
            if name == "ecoli_gene_regulation":
                with open(f"{tmp}/ecoli_0.csv") as a, \
                        open(f"{tmp}/ecoli_1.csv") as b:
                    text = a.read()
                    if text != b.read() or len(text.splitlines()) != 101:
                        raise AssertionError("8 ecoli: the CSV's text "
                                             "differs between the runs")
            rates = ("per-lane sweep rates" if fused.experiment.ensemble.sweep
                     else "shared rates")
            log(f"[examples] 8 {name}: {eng.system.n_species} species, "
                f"{eng.system.n_reactions} reactions, "
                f"{fused.experiment.ensemble.n_instances} instances on "
                f"{fused.experiment.n_lanes} lanes, {rates}, {n_win} "
                f"windows: as written {p_s:.3f} s, use_kernel=True "
                f"{f_s:.3f} s with {f_l} window-kernel launches; pool and "
                f"record means bitwise"
                + (f"; per-point means bitwise" if plain.per_point()
                   is not None else "")
                + (f"; CSV text equal" if name == "ecoli_gene_regulation"
                   else "")
                + ("; var and ci90 bitwise" if not notes else
                   f"; within the tier: {notes}") + f"; {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    model = ecoli_gene_regulation()
    grid = np.linspace(1.0, 100.0, 100)  # the E. coli example's grid
    t0 = time.perf_counter()
    oracle = reference.simulate(model, grid, seed=0)
    host_s = time.perf_counter() - t0
    system, _ = compile_model(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lane = run_reference_trajectory(system, grid, seed=0, device=device)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    if oracle.shape != (100, 2) or tuple(lane.shape) != (
            100, system.n_species) or not (np.isfinite(oracle).all() and
                                           bool(torch.isfinite(lane).all())):
        raise AssertionError("8: the oracle's or the lane's trajectory is "
                             "malformed")
    log(f"[examples] 8 oracle (core/cwc/reference.py, the paper's Fig. 3 "
        f"Match on the host) seed 0, E. coli to t=100 on 100 grid points: "
        f"{host_s:.4f} s; run_reference_trajectory (one lane, the dense "
        f"exact SSA step by step on the card) {card_s:.4f} s; final "
        f"species {oracle[-1].tolist()} (observables) and "
        f"{lane[-1].tolist()} (all species; statistical agreement only)")
    return launches


def _stack_slice(tree, i):
    if isinstance(tree, dict):
        return {k: _stack_slice(v, i) for k, v in tree.items()}
    return tree[i]


def logits_spread(got, ref) -> tuple[float, float]:
    """(max |got - ref| over max |ref|, share of rows whose argmax
    agrees)."""
    d = float((got - ref).abs().max()) / float(ref.abs().max())
    return d, float((got.argmax(-1) == ref.argmax(-1)).float().mean())


def decode_against_forward(cfg, device) -> float:
    """The first decode step after a LLM_PROMPT-token prefill against
    forward on the LLM_PROMPT + 1 tokens, on seeded weights: max |diff|
    over max |logit|."""
    import torch

    from repro_torch.models import build_model

    gen = torch.Generator(device=device)
    gen.manual_seed(LLM_SEED)
    model = build_model(cfg, device=device).init(gen)
    b, p, v = LLM_BATCH, LLM_PROMPT, cfg.vocab_size
    prompts = torch.randint(0, v, (b, p + 1), generator=gen, device=device)
    cache, _ = model.prefill({"tokens": prompts[:, :p]}, cache_len=LLM_CACHE)
    step, _ = model.decode_step(cache, prompts[:, p:],
                                torch.full((b,), p, device=device))
    full, _, _ = model.forward({"tokens": prompts})
    return logits_spread(step[:, 0, :v], full[:, p, :v])[0]


def phase_llm(device, card) -> dict:
    """Phase 9: llama3-8b at full width from seeded weights: 4 requests
    of 512 prompt tokens prefilled into a 544-slot cache, 32 greedy
    decode steps; gates on finite logits, the first decode step against
    forward on the 513 tokens (layer 0's K/V at full depth, the logits on
    the config cut to LLM_CHECK_LAYERS layers), and a 4,096-token prompt's
    chunked layer-0 attention against full attention."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model
    from repro_torch.models.norms import apply_norm

    # the reference's products accumulate in float32: no bf16 partial
    # sums in cuBLAS's split reductions (set here, by the caller)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    cfg = get_config(LLM_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    # the peak from here on counts the weights, which stay allocated
    torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(LLM_SEED)
    model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[llm] 9 {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model},"
        f" {cfg.n_heads} heads ({cfg.n_kv_heads} KV), d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), {cfg.dtype}: "
        f"{n_params:,} parameters, {w_bytes / 1e9:.3f} GB, initialised "
        f"from torch.Generator seed {LLM_SEED} on the card in "
        f"{init_s:.2f} s; bf16 reduced-precision reductions "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    b, p = LLM_BATCH, LLM_PROMPT
    prompts = torch.randint(0, cfg.vocab_size, (b, p + 1), generator=gen,
                            device=device)
    batch = {"tokens": prompts[:, :p]}
    model.prefill(batch, cache_len=LLM_CACHE)  # warm-up: cuBLAS, allocator
    out = [None]

    def prefill():
        out[0] = model.prefill(batch, cache_len=LLM_CACHE)

    pre_ms = cuda_ms(prefill)
    cache, last = out[0]
    token = prompts[:, p:p + 1]  # the 513th token, then greedy
    step_ms, step_logits = [], []
    for i in range(LLM_DECODE):
        pos = torch.full((b,), p + i, dtype=torch.long, device=device)

        def step():
            out[0] = model.decode_step(cache, token, pos)

        step_ms.append(cuda_ms(step))
        logits, cache = out[0]
        step_logits.append(logits)
        token = logits[:, :, :cfg.vocab_size].argmax(dim=-1)
    logits = torch.cat(step_logits, dim=1)  # (B, 32, V)
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(last).all())):
        raise AssertionError("9: a prefill or decode logit is not finite")
    full, fcache, _ = model.forward({"tokens": prompts}, mode="prefill")
    v = cfg.vocab_size
    spread, agree = logits_spread(logits[:, 0, :v], full[:, p, :v])
    d_pre, _ = logits_spread(last[:, 0, :v], full[:, p - 1, :v])
    growth = []  # per layer: the decoded position's K/V against forward's
    for kv in ("k", "v"):
        a = cache["stack"]["l0"][kv][:, :, p].float()
        r = fcache["stack"]["l0"][kv][:, :, p].float()
        growth.append((a - r).abs().amax(dim=(1, 2, 3))
                      / r.abs().amax(dim=(1, 2, 3)))
    growth = torch.maximum(*growth).tolist()
    log(f"[llm] 9 first decode step against forward on the {p + 1} tokens "
        f"at full depth: max |diff| over max |logit| {spread:.4g}, argmax "
        f"equal on {agree:.2f} of the rows (chaotic depth: printed, not "
        f"gated); prefill's last logits against forward's position "
        f"{p - 1}: {d_pre:.4g}; the decoded position's K/V against "
        f"forward's, layer by layer: {[f'{g:.3g}' for g in growth]} "
        f"(layer 0 bound {LLM_LAYER0_TOL:.4g})")
    if not growth[0] <= LLM_LAYER0_TOL:
        raise AssertionError("9: layer 0's decoded K/V disagree with "
                             "forward's")
    del full, fcache
    cut = decode_against_forward(
        dataclasses.replace(cfg, n_layers=LLM_CHECK_LAYERS), device)
    log(f"[llm] 9 the same full-width config cut to {LLM_CHECK_LAYERS} "
        f"layers: first decode step against forward, max |diff| over max "
        f"|logit| {cut:.4g} (bound {LLM_DECODE_TOL})")
    if not cut <= LLM_DECODE_TOL:
        raise AssertionError("9: decode disagrees with forward")

    long = torch.randint(0, cfg.vocab_size, (1, LLM_LONG), generator=gen,
                         device=device)
    def prefill_long():
        out[0] = model.prefill({"tokens": long})

    prefill_long()  # warm-up
    long_ms = cuda_ms(prefill_long)
    if not bool(torch.isfinite(out[0][1]).all()):
        raise AssertionError("9: the long prompt's logits are not finite")
    params = model.params()
    p0 = _stack_slice(params["blocks"]["stack"]["l0"], 0)
    with torch.no_grad():
        h = apply_norm(p0["norm1"], params["embed"][long], cfg.norm)
        pos = torch.arange(LLM_LONG, dtype=torch.int32, device=device)[None]
        q, k, vv = attn.project_qkv(p0["mixer"], h, cfg, pos)
        hd_scale = cfg.resolved_head_dim ** -0.5
        if not LLM_LONG > attn.FULL_ATTN_MAX_SEQ:
            raise AssertionError("9: the long prompt takes the full path")
        o_c = attn.attention(q, k, vv, causal=True)
        o_f = attn.full_attention(q, k, vv, causal=True)
        # how sharp layer 0's attention is under the reference's init
        scores = torch.einsum(
            "bqhk,bshk->bhqs", q.float(),
            attn._expand_kv(k, cfg.n_heads).float()) * hd_scale
        causal = torch.ones(LLM_LONG, LLM_LONG, dtype=torch.bool,
                            device=device).tril()
        s_std = float(scores[..., causal].std())
        p_max = float(torch.softmax(scores.masked_fill(
            ~causal, attn.NEG_INF), dim=-1).amax(dim=-1).mean())
        del scores
        c_ms = cuda_ms(lambda: attn.attention(q, k, vv, causal=True))
        f_ms = cuda_ms(lambda: attn.full_attention(q, k, vv, causal=True))
    d_ch = float((o_c.float() - o_f.float()).abs().max())
    s_ch = float(o_f.float().abs().max())
    log(f"[llm] 9 a {LLM_LONG}-token prompt (B=1) prefilled through the "
        f"chunked path ({attn.Q_CHUNK} x {attn.KV_CHUNK} chunks) in "
        f"{long_ms:.3f} ms; layer 0's chunked attention {c_ms:.3f} ms "
        f"against full attention {f_ms:.3f} ms on the same q, k, v: max "
        f"|diff| {d_ch:.5g} over max |o| {s_ch:.5g} = {d_ch / s_ch:.4g} "
        f"(bound {LLM_CHUNK_TOL:.4g}); its causal scores' std {s_std:.5g}, "
        f"mean largest softmax weight {p_max:.4f}")
    if not d_ch <= LLM_CHUNK_TOL * s_ch:
        raise AssertionError("9: chunked attention disagrees with full")

    tokens = b * p
    kv_bytes = sum(t.numel() * t.element_size() for layer in
                   cache["stack"].values() for t in layer.values())
    dec_bound = (w_bytes + kv_bytes) / PEAK_BYTES_S * 1e3
    pre_bound = 2 * n_params * tokens / PEAK_BF16_OPS * 1e3
    dec = step_ms[1:]
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log(f"[llm] 9 prefill {b} x {p} tokens: {pre_ms:.3f} ms, "
        f"{tokens / (pre_ms / 1e3):.5g} tokens/s; bound {pre_bound:.3f} ms "
        f"(2 x parameters x tokens at {PEAK_BF16_OPS / 1e12:g} TFLOP/s "
        f"bf16), {pre_bound / pre_ms:.3f} of it")
    log(f"[llm] 9 decode {LLM_DECODE} greedy steps at batch {b}: first "
        f"{step_ms[0]:.3f} ms, then mean {np.mean(dec):.3f} ms (min "
        f"{min(dec):.3f}, max {max(dec):.3f}); bound {dec_bound:.3f} ms a "
        f"step (weights {w_bytes / 1e9:.3f} GB + KV cache "
        f"{kv_bytes / 1e9:.4f} GB at {PEAK_BYTES_S / 1e12:g} TB/s), "
        f"{dec_bound / np.mean(dec):.3f} of it; "
        f"{b * 1e3 / np.mean(dec):.5g} tokens/s")
    log(f"[llm] 9 peak memory (torch.cuda.max_memory_allocated) "
        f"{peak_gb:.3f} GB; {card}")
    del model, params, p0, cache, out, logits, step_logits
    torch.cuda.empty_cache()
    return {"prefill_ms": pre_ms, "decode_ms": float(np.mean(dec)),
            "peak_gb": peak_gb}


def moe_serve(arch, device, card) -> None:
    """One MoE config of phase 10 at full width: init, one MoE layer
    against the dense oracle, prefill (timed, rerun bitwise, drops and
    aux by layer), 32 greedy decode steps, layer 0's K/V at full depth
    and decode against forward on the config cut to LLM_CHECK_LAYERS
    layers, each beside its bound, and the peak memory."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.base import FFN_MOE
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model
    from repro_torch.models.blocks import layer_groups
    from repro_torch.models.moe import _capacity, apply_moe, moe_dense_oracle
    from repro_torch.models.norms import apply_norm

    cfg = get_config(arch)
    e, k = cfg.n_experts, cfg.n_experts_per_token
    f = cfg.moe_d_ff or cfg.d_ff
    nodrop = dataclasses.replace(cfg, capacity_factor=e / k + 1)
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(LLM_SEED)
    model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(device) / 1e9
    named = dict(model.named_parameters())
    n_params = sum(t.numel() for t in named.values())
    w_bytes = sum(t.numel() * t.element_size() for t in named.values())
    expert_bytes = sum(t.numel() * t.element_size()
                       for n, t in named.items() if ".ffn.w_" in n
                       and t.ndim == (4 if ".stack." in n else 3))
    groups = layer_groups(model.specs)
    n_moe = sum(sp.ffn == FFN_MOE for sp in model.specs)
    log(f"[moe] 10 {arch}: {cfg.n_layers} layers ({len(groups.prefix)} "
        f"prefix + {len(groups.pattern)} x {groups.n_repeat} stacked), "
        f"d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, {e} experts top-{k}, "
        f"{cfg.n_shared_experts} shared, expert d_ff {f}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}: {n_params:,} parameters "
        f"({cfg.active_param_count():,} active a token), "
        f"{w_bytes / 1e9:.3f} GB, initialised from torch.Generator seed "
        f"{LLM_SEED} on the card in {init_s:.2f} s (peak {init_peak:.3f} "
        f"GB: the weights and one leaf's float32 draw)")

    b, p = LLM_BATCH, LLM_PROMPT
    prompts = torch.randint(0, cfg.vocab_size, (b, p + 1), generator=gen,
                            device=device)
    batch = {"tokens": prompts[:, :p]}

    # one MoE layer at full width against the dense oracle, no drops
    params = model.params()
    j = next(i for i, sp in enumerate(groups.pattern) if sp.ffn == FFN_MOE)
    layer = _stack_slice(params["blocks"]["stack"][f"l{j}"], 0)
    with torch.no_grad():
        h = apply_norm(layer["norm2"], params["embed"][prompts[:, :p]],
                       cfg.norm)
        with MoeProbe() as probe:
            y, aux = apply_moe(layer["ffn"], h, nodrop)
        y_ref, aux_ref = moe_dense_oracle(layer["ffn"], h, nodrop)
        kept = float(probe.keep[0])
        rel = float((y.float() - y_ref.float()).abs().max()
                    / y_ref.float().abs().max())
        moe_ms = cuda_ms(lambda: apply_moe(layer["ffn"], h, nodrop))
        oracle_ms = cuda_ms(lambda: moe_dense_oracle(layer["ffn"], h,
                                                     nodrop))
    log(f"[moe] 10 {arch} one MoE layer ({b * p} tokens, capacity "
        f"{_capacity(nodrop, b * p)} a expert: kept {kept:.4f}) through "
        f"apply_moe {moe_ms:.3f} ms against moe_dense_oracle "
        f"{oracle_ms:.3f} ms: max |diff| over max |y| {rel:.4g} (bound "
        f"{MOE_LAYER_TOL:.4g}); aux {float(aux):.6f} and "
        f"{float(aux_ref):.6f}, bitwise {bool(torch.equal(aux, aux_ref))}")
    if not (kept == 1.0 and rel <= MOE_LAYER_TOL):
        raise AssertionError(f"10 {arch}: apply_moe disagrees with the "
                             "dense oracle")
    del y, y_ref, h, layer

    model.prefill(batch, cache_len=LLM_CACHE)  # warm-up
    out = [None]

    def prefill():
        out[0] = model.prefill(batch, cache_len=LLM_CACHE)

    pre_ms = cuda_ms(prefill)
    cache, last = out[0]
    cache2, last2 = model.prefill(batch, cache_len=LLM_CACHE)
    same = torch.equal(last, last2) and all(
        torch.equal(a, c) for kv in ("k", "v")
        for a, c in zip(layer_kvs(cache, kv), layer_kvs(cache2, kv)))
    del cache2, last2
    if not same:
        raise AssertionError(f"10 {arch}: a rerun of prefill differs")
    with MoeProbe() as probe:
        model.prefill(batch, cache_len=LLM_CACHE)
    drops = [round(1 - float(x), 4) for x in probe.keep]
    auxes = [round(float(x), 4) for x in probe.aux]
    log(f"[moe] 10 {arch} prefill {b} x {p}: a rerun bitwise equal (logits "
        f"and cache); capacity {_capacity(cfg, b * p)} a expert (factor "
        f"{cfg.capacity_factor}); share of routed entries dropped, layer by "
        f"layer: {drops}; aux by layer: {auxes}")

    token = prompts[:, p:p + 1]
    step_ms, step_logits, routed = [], [], []
    for i in range(LLM_DECODE):
        pos = torch.full((b,), p + i, dtype=torch.long, device=device)

        def step():
            out[0] = model.decode_step(cache, token, pos)

        if i == 0:
            with MoeProbe() as probe:
                step_ms.append(cuda_ms(step))
            routed = [int(ids.unique().numel()) for _, ids in probe.routes]
        else:
            step_ms.append(cuda_ms(step))
        logits, cache = out[0]
        step_logits.append(logits)
        token = logits[:, :, :cfg.vocab_size].argmax(dim=-1)
    logits = torch.cat(step_logits, dim=1)
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(last).all())):
        raise AssertionError(f"10 {arch}: a prefill or decode logit is not "
                             "finite")
    full, fcache, _ = model.forward({"tokens": prompts}, mode="prefill")
    v = cfg.vocab_size
    spread, agree = logits_spread(logits[:, 0, :v], full[:, p, :v])
    growth = []
    for kv in ("k", "v"):
        growth.append([float((a[:, p].float() - r[:, p].float()).abs().max()
                             / r[:, p].float().abs().max())
                       for a, r in zip(layer_kvs(cache, kv),
                                       layer_kvs(fcache, kv))])
    growth = [max(a, c) for a, c in zip(*growth)]
    log(f"[moe] 10 {arch} first decode step against forward on the {p + 1} "
        f"tokens at full depth: max |diff| over max |logit| {spread:.4g}, "
        f"argmax equal on {agree:.2f} of the rows (chaotic depth, and "
        f"forward drops other entries than prefill: printed, not gated); "
        f"the decoded position's K/V against forward's, layer by layer: "
        f"{[f'{g:.3g}' for g in growth]} (layer 0 bound "
        f"{LLM_LAYER0_TOL:.4g})")
    if not growth[0] <= LLM_LAYER0_TOL:
        raise AssertionError(f"10 {arch}: layer 0's decoded K/V disagree "
                             "with forward's")
    del full, fcache
    cut, flips, margin = moe_decode_against_forward(
        dataclasses.replace(nodrop, n_layers=LLM_CHECK_LAYERS), device)
    log(f"[moe] 10 {arch} cut to {LLM_CHECK_LAYERS} layers, capacity factor "
        f"{nodrop.capacity_factor:.4g} (nothing drops): first decode step "
        f"against forward, expert ids differing on {flips} token-layers "
        f"(smallest top-k margin among them {margin:.3g}), max |diff| over "
        f"max |logit| {cut:.4g} (bound {LLM_DECODE_TOL})")
    if not cut <= LLM_DECODE_TOL:
        raise AssertionError(f"10 {arch}: decode disagrees with forward")

    tokens = b * p
    per_expert = 3 * cfg.d_model * f
    cap = _capacity(cfg, tokens)
    pre_ops = (2 * tokens * (cfg.active_param_count() - n_moe * k * per_expert)
               + n_moe * 2 * per_expert * e * cap)
    pre_bound = pre_ops / PEAK_BF16_OPS * 1e3
    kv_bytes = sum(t.numel() * t.element_size() for kv in ("k", "v")
                   for t in layer_kvs(cache, kv))
    one_expert = expert_bytes // (n_moe * e)
    routed_bytes = w_bytes - expert_bytes + sum(routed) * one_expert
    dec_all = (w_bytes + kv_bytes) / PEAK_BYTES_S * 1e3
    dec_routed = (routed_bytes + kv_bytes) / PEAK_BYTES_S * 1e3
    dec = step_ms[1:]
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log(f"[moe] 10 {arch} prefill {b} x {p} tokens: {pre_ms:.3f} ms, "
        f"{tokens / (pre_ms / 1e3):.5g} tokens/s; bound {pre_bound:.3f} ms "
        f"(2 x {pre_ops / 2 / tokens:.4g} parameters a token, the experts "
        f"at {e} x {cap} slots, at {PEAK_BF16_OPS / 1e12:g} TFLOP/s bf16), "
        f"{pre_bound / pre_ms:.3f} of it")
    log(f"[moe] 10 {arch} decode {LLM_DECODE} greedy steps at batch {b}: "
        f"first {step_ms[0]:.3f} ms, then mean {np.mean(dec):.3f} ms (min "
        f"{min(dec):.3f}, max {max(dec):.3f}); bounds at "
        f"{PEAK_BYTES_S / 1e12:g} TB/s: all weights and the KV cache "
        f"{dec_all:.3f} ms ({dec_all / np.mean(dec):.3f} of it), the routed "
        f"experts alone ({routed} of {e} experts by layer at the first "
        f"step) {dec_routed:.3f} ms; {b * 1e3 / np.mean(dec):.5g} tokens/s")
    log(f"[moe] 10 {arch} peak memory (torch.cuda.max_memory_allocated) "
        f"{peak_gb:.3f} GB; {card}")
    if not peak_gb < 80:
        raise AssertionError(f"10 {arch}: peak memory {peak_gb:.1f} GB")
    del model, params, cache, out, logits, step_logits, named
    torch.cuda.empty_cache()


def moe_decode_against_forward(cfg, device) -> tuple[float, int, float]:
    """decode_against_forward for a MoE config, with the expert ids of
    the decoded token compared against forward's at its position:
    (max |diff| over max |logit|, differing token-layers, the smallest
    margin among them or -1)."""
    import torch

    from repro_torch.models import build_model

    gen = torch.Generator(device=device)
    gen.manual_seed(LLM_SEED)
    model = build_model(cfg, device=device).init(gen)
    b, p, v = LLM_BATCH, LLM_PROMPT, cfg.vocab_size
    prompts = torch.randint(0, v, (b, p + 1), generator=gen, device=device)
    cache, _ = model.prefill({"tokens": prompts[:, :p]}, cache_len=LLM_CACHE)
    with MoeProbe() as dec:
        step, _ = model.decode_step(cache, prompts[:, p:],
                                    torch.full((b,), p, device=device))
    with MoeProbe() as fwd:
        full, _, _ = model.forward({"tokens": prompts})
    rows = torch.arange(b) * (p + 1) + p
    flips, margin = compare_routes(dec, fwd, cfg.n_experts_per_token, rows)
    return logits_spread(step[:, 0, :v], full[:, p, :v])[0], flips, margin


def phase_moe(device, card) -> None:
    """Phase 10: olmoe-1b-7b, then deepseek-moe-16b, at full width (the
    first freed before the second is built)."""
    import torch

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    for arch in MOE_ARCHS:
        moe_serve(arch, device, card)


def train_accum_check(cfg, ocfg, scfg, batch, device) -> str:
    """accum 2 against accum 1 on one batch from one initial state, on
    `cfg` in float32 with router_aux_loss 0 and a capacity where nothing
    drops (the aux loss and the drops are per-microbatch statistics, so
    with either the two steps optimise different objectives): the
    parameters after one step within TRAIN_ACCUM_ATOL."""
    import dataclasses

    import torch

    from repro_torch.models import build_model
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    check = dataclasses.replace(
        cfg, dtype="float32", router_aux_loss=0.0,
        capacity_factor=cfg.n_experts / cfg.n_experts_per_token + 1,
        n_layers=TRAIN_ACCUM_LAYERS)
    model = build_model(check, device=device)

    def one_step(accum):
        gen = torch.Generator(device=device)
        gen.manual_seed(LLM_SEED)
        state = init_train_state(model, gen, ocfg)
        step = make_train_step(model, ocfg, dataclasses.replace(
            scfg, grad_accum=accum))
        state, metrics = step(state, batch)
        return state, float(metrics["grad_norm"])

    state, norm2 = one_step(2)
    after2 = [t.clone() for t in tree_leaves(state["params"])]
    del state
    state, norm1 = one_step(1)
    worst = max(float((a - c).abs().max())
                for a, c in zip(tree_leaves(state["params"]), after2))
    n = sum(t.numel() for t in after2)
    del state, after2, model
    torch.cuda.empty_cache()
    msg = (f"accum 2 against accum 1 on one batch ({check.n_layers} "
           f"layers, float32, router_aux_loss 0, capacity factor "
           f"{check.capacity_factor:.4g}: nothing drops): grad norm {norm2:.6g} and {norm1:.6g}; the {n:,} "
           f"parameters after one step, max |diff| {worst:.3g} (bound "
           f"{TRAIN_ACCUM_ATOL})")
    if not worst <= TRAIN_ACCUM_ATOL:
        raise AssertionError(f"11: {msg}")
    return msg


def train_drill(device) -> str:
    """tests/test_train.py's crash drill on the olmoe smoke config in
    float32 on the card: a clean run of 8 steps, a second clean run,
    and a run crashed at steps 3 and 6 through the pytree store."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.ckpt import store
    from repro_torch.configs.base import OptimizerConfig, ShardingConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import build_model
    from repro_torch.runtime.fault import FailurePlan
    from repro_torch.train.drill import run_train_with_failures
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_smoke_config(TRAIN_ARCH)
    model = build_model(cfg, device=device)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=12)
    step = make_train_step(model, ocfg, ShardingConfig(strategy="dp_tp",
                                                       grad_accum=1))
    batches = [synth_batch(cfg, 4, 32, i) for i in range(8)]

    def make_state():
        gen = torch.Generator(device=device)
        gen.manual_seed(LLM_SEED)
        return init_train_state(model, gen, ocfg)

    def clean_run():
        state = make_state()
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return losses

    clean, again = clean_run(), clean_run()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_drill_")
    try:
        def restore_fn():
            s = store.latest_step(tmp)
            return store.restore(make_state(), tmp, s), s

        _, crashy, events = run_train_with_failures(
            make_state, step, batches, tmp,
            FailurePlan(schedule={3: "crash", 6: "crash"}),
            lambda st, i: store.save(st, tmp, i), restore_fn, ckpt_every=2)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rel = float(np.max(np.abs(np.subtract(crashy, clean))
                       / np.abs(clean)))
    msg = (f"crash drill ({cfg.name}, float32, 8 steps of 4 x 32, crashes "
           f"at steps 3 and 6, a save every 2 steps through the pytree "
           f"store): {len(events)} restores, losses {np.round(clean, 5)}; "
           f"the crashed run's against the clean run's max relative diff "
           f"{rel:.3g} (rtol {DRILL_RTOL}, atol {DRILL_ATOL}), bitwise "
           f"{crashy == clean}; a second clean run bitwise {again == clean} "
           f"(torch.use_deterministic_algorithms is off: the tolerance, not "
           f"a forced order, carries the gradients' scatters)")
    if not (len(events) == 2 and np.allclose(crashy, clean, rtol=DRILL_RTOL,
                                             atol=DRILL_ATOL)):
        raise AssertionError(f"11: {msg}")
    return msg


def phase_train(device, card) -> float:
    """Phase 11: the one-card trainer on olmoe-1b-7b at full width cut
    to TRAIN_LAYERS layers: TRAIN_STEPS steps of synth_batch TRAIN_BATCH
    x TRAIN_SEQ at the registry's grad_accum over TRAIN_DATA repeated
    batches (the loss must fall), a save and a restore of the trained
    state through the pytree store (bitwise), accum 2 against accum 1,
    and the crash drill."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.ckpt import store
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.configs.registry import default_sharding, get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import build_model
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    scfg = default_sharding(TRAIN_ARCH)
    ocfg = OptimizerConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS)
    model = build_model(cfg, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(LLM_SEED)
    state = init_train_state(model, gen, ocfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(state)) / 1e9
    log(f"[train] 11 {TRAIN_ARCH} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.n_experts_per_token}, expert "
        f"d_ff {cfg.moe_d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}) cut "
        f"from {full.n_layers} to {cfg.n_layers} layers: {n_params:,} "
        f"parameters, state {state_gb:.3f} GB (bf16 params, float32 master, "
        f"mu, nu; the full model's {full.param_count():,} parameters would "
        f"need about {full.param_count() * 16 / 1e9:.0f} GB with float32 "
        f"gradients), initialised in {init_s:.2f} s; grad_accum "
        f"{scfg.grad_accum}, AdamW lr {TRAIN_LR}, warm-up {TRAIN_WARMUP}")

    batches = [synth_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, i)
               for i in range(TRAIN_DATA)]
    step = make_train_step(model, ocfg, scfg)
    out = [None]
    losses, ms = [], []
    for i in range(TRAIN_STEPS):
        def run():
            out[0] = step(state, batches[i % TRAIN_DATA])

        ms.append(cuda_ms(run))
        state, metrics = out[0]
        losses.append(float(metrics["loss"]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = float(np.mean(ms[1:]))
    bound = 6 * cfg.active_param_count() * tokens / PEAK_BF16_OPS * 1e3
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log(f"[train] 11 {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"over {TRAIN_DATA} repeated batches: loss by step "
        f"{[round(x, 4) for x in losses]}; first step {ms[0]:.1f} ms, then "
        f"mean {step_ms:.1f} ms (min {min(ms[1:]):.1f}, max "
        f"{max(ms[1:]):.1f}), {tokens / (step_ms / 1e3):.5g} tokens/s; "
        f"bound {bound:.3f} ms (6 x {cfg.active_param_count():,} active "
        f"parameters x {tokens} tokens at {PEAK_BF16_OPS / 1e12:g} TFLOP/s "
        f"bf16), {bound / step_ms:.3f} of it; peak memory {peak_gb:.3f} GB")
    # the loss falls: on the last step, and over the last TRAIN_DATA
    # steps (the same batches) against the first TRAIN_DATA
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and np.mean(losses[-TRAIN_DATA:]) < np.mean(
                losses[:TRAIN_DATA])):
        raise AssertionError("11: the loss does not fall")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = store.save(state, tmp, TRAIN_STEPS)
        save_s = time.perf_counter() - t0
        size_gb = os.path.getsize(os.path.join(path, "arrays.npz")) / 1e9
        t0 = time.perf_counter()
        back = store.restore(state, tmp)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(a, c) for a, c in zip(tree_leaves(back),
                                                     tree_leaves(state)))
        del back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[train] 11 the trained state through the pytree store: save "
        f"{save_s:.2f} s, {size_gb:.3f} GB, restore {restore_s:.2f} s "
        f"(sha256 verified), every leaf bitwise {same}")
    if not same:
        raise AssertionError("11: the restored state differs")
    del state, out, metrics, model
    torch.cuda.empty_cache()
    log(f"[train] 11 {train_accum_check(cfg, ocfg, scfg, batches[0], device)}")
    log(f"[train] 11 {train_drill(device)}; {card}")
    return step_ms


def phase_llm_parity(device) -> None:
    """Phase 9b: each dense, VLM and MoE config at its smoke size,
    float32, the same weights on the card and on the CPU: the MoE
    configs' expert ids first (every layer's top-k, equal), then
    forward, prefill (cache and last logits) and one decode step agree
    within LLM_F32_TOL; and gemma's smoke size in bf16 (tied embeddings:
    the card's float32-output product of the transposed table) within
    LLM_BF16_TOL."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import build_model

    def diff(a, b, what, tol=LLM_F32_TOL):
        a, b = a.float().cpu(), b.float()
        worst = float(((a - b).abs() - tol * b.abs()).max())
        if not worst <= tol:
            raise AssertionError(f"9b {what}: card and CPU disagree "
                                 f"beyond rtol = atol = {tol}")
        return float((a - b).abs().max())

    cases = [(n, get_smoke_config(n)) for n in LLM_DENSE + MOE_ARCHS]
    cases.append(("gemma-7b bf16", dataclasses.replace(
        get_smoke_config("gemma-7b"), dtype="bfloat16")))
    for label, cfg in cases:
        host = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(1))
        dev = build_model(cfg, device=device)
        dev.load_state_dict(host.state_dict())
        rng = np.random.default_rng(2)
        n_pre = cfg.frontend_tokens if cfg.frontend != "none" else 0
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32 - n_pre))}
        if n_pre:
            batch["embeds"] = rng.standard_normal(
                (2, n_pre, cfg.d_model)).astype(np.float32)
        v = cfg.vocab_size
        with MoeProbe() as r_dev:
            f_dev = dev.forward(batch)[0][..., :v]
        with MoeProbe() as r_host:
            f_host = host.forward(batch)[0][..., :v]
        if cfg.n_experts:
            flips, margin = compare_routes(r_dev, r_host,
                                           cfg.n_experts_per_token)
            log(f"[llm] 9b {label}: expert ids of {len(r_dev.routes)} MoE "
                f"layers x {r_dev.routes[0][1].shape[0]} tokens, card "
                f"against CPU: {flips} tokens differ (smallest top-k margin "
                f"among them {margin:.3g}); aux {float(sum(r_dev.aux)):.6f} "
                f"against {float(sum(r_host.aux)):.6f}")
            if flips:
                raise AssertionError(f"9b {label}: the card routes tokens "
                                     "to other experts than the CPU")
        if cfg.dtype == "bfloat16":
            rel = float((f_dev.cpu() - f_host).abs().max()
                        / f_host.abs().max())
            log(f"[llm] 9b {label}: forward logits card against CPU max "
                f"|diff| over max |logit| {rel:.4g} (bound "
                f"{LLM_BF16_TOL:.4g})")
            if not rel <= LLM_BF16_TOL:
                raise AssertionError(f"9b {label}: card and CPU disagree")
            continue
        worst = [diff(f_dev, f_host, f"{label} forward")]
        (c_dev, l_dev), (c_host, l_host) = (
            m.prefill(batch, cache_len=36) for m in (dev, host))
        worst.append(diff(l_dev, l_host, f"{label} prefill logits"))
        for name in c_host["stack"]:
            for kv in ("k", "v"):
                worst.append(diff(c_dev["stack"][name][kv],
                                  c_host["stack"][name][kv],
                                  f"{label} prefill cache"))
        token = rng.integers(0, cfg.vocab_size, (2, 1))
        pos = np.full((2,), 32)
        worst.append(diff(dev.decode_step(c_dev, token, pos)[0],
                          host.decode_step(c_host, token, pos)[0],
                          f"{label} decode"))
        log(f"[llm] 9b {label}: forward, prefill (logits, cache) and "
            f"decode on the card against the CPU, float32: max |diff| "
            f"{max(worst):.3g} (rtol = atol = {LLM_F32_TOL})")


# phase 12: the multi-device pieces over a mesh of the visible cards, or
# of repeated entries of the one card
MESH_SHARDS = 4
MERGE_SHARDS = 8
# one MoE layer on a mesh against the one-device apply_moe and the dense
# oracle, at a capacity factor of E/k (nothing drops on either): EP rounds
# the experts' outputs to bf16 before its combine (the reference does), so
# the two may differ by a bf16 rounding of the output
MESH_LAYER_TOL = 2 ** -7
# the data-parallel step: olmoe-1b-7b at full width cut to DP_LAYERS
# layers, DP_SHARDS shards, DP_STEPS steps of synth_batch TRAIN_BATCH x
# TRAIN_SEQ; compress=False against make_train_step on the whole batch in
# float32 (aux off, nothing drops) within TRAIN_ACCUM_ATOL after one step
DP_LAYERS = 2
DP_SHARDS = 2
DP_STEPS = 5
# the 2-layer cut on a mesh against one device runs in float32: in bf16
# EP rounds each expert output before its combine (the reference does),
# which moves layer 1's input by a bf16 rounding and flips near-tie
# routes. Routes are compared as sets of experts: two experts trading
# rank inside the top-k (counted, printed) choose the same experts. A
# token whose set differs must lie at a near-tie, or sit downstream of a
# change: a later layer of a sequence in which an earlier layer's set
# changed at or before the token's position (the changed expert output
# reaches it through attention). A near-tie is a top-k margin below
# MESH_NEAR_TIE, or below twice the largest difference of a router
# probability between the two runs among the layer's tokens whose set
# is unchanged and not downstream: the dense layers on the mesh are
# tensor-parallel (phase 13), so the router's input carries their sums'
# float32 noise, and a set can change only where the margin is within
# the probabilities' noise
MESH_NEAR_TIE = 1e-5


def mesh_devices(n: int, device) -> list:
    """cuda:0..3 in turn when four cards are visible, else n entries of
    `device`."""
    import torch

    if torch.cuda.device_count() >= MESH_SHARDS:
        return [torch.device("cuda", k % MESH_SHARDS) for k in range(n)]
    return [device] * n


def mesh_topology(cfg, shape, axes, device, **sharding):
    from repro_torch.configs.base import MeshSpec, ShardingConfig
    from repro_torch.sharding.rules import Topology, make_mesh_from_spec

    n = 1
    for s in shape:
        n *= s
    mesh = make_mesh_from_spec(MeshSpec(shape, axes),
                               mesh_devices(n, device))
    return Topology(mesh, cfg, ShardingConfig(strategy="dp_tp", **sharding))


def on_topology(model, topo):
    """`model`'s parameters placed by their specs on `topo`: views of
    its tensors on repeated entries of its card (no copy), copies on
    other cards."""
    from repro_torch.models.causal_lm import CausalLM

    return CausalLM(model.cfg, topo, params=model.params())


def whole_leaf(t):
    """A cache or parameter leaf as one tensor (a placed one joined)."""
    from repro_torch.sharding.collectives import Placed

    return t.whole() if isinstance(t, Placed) else t


def sub_phase(label, card):
    """A context that prints a sub-phase's wall and peak memory."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def ctx():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        log(f"[mesh] {label}: {time.perf_counter() - t0:.1f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; {card}")

    return ctx()


def mesh_routes(probe, n_calls: int, pick) -> list:
    """A probe's routes regrouped to one (probs, ids) per layer: each
    layer made n_calls route calls (one a shard); `pick` keeps the
    shards that cover the tokens once, in order."""
    import torch

    out = []
    for i in range(0, len(probe.routes), n_calls):
        calls = [probe.routes[i + j] for j in pick]
        out.append((torch.cat([c[0] for c in calls]),
                    torch.cat([c[1] for c in calls])))
    return out


def route_changes(a, b, k, seq: int, earlier=None) -> dict:
    """Two lists of (probs, ids) by layer, each layer's tokens in (batch,
    position) order over sequences of `seq` tokens: per layer, the
    tokens whose expert set differs, how many of them lie at a near-tie,
    how many are downstream of an earlier layer's change in their
    sequence, the largest margin among those neither, the rank swaps
    inside an unchanged set, and the near-tie bound: MESH_NEAR_TIE, or
    twice the largest difference of a router probability among the
    layer's other tokens (the two runs' own noise) where that is larger.
    `earlier` is the result for the tokens that precede these in their
    sequences (prefill's, for a decode step)."""
    import torch

    rows, before, first = [], [], None
    for layer, ((pa, ia), (pb, ib)) in enumerate(zip(a, b)):
        pa, ia, pb, ib = pa.cpu(), ia.cpu(), pb.cpu(), ib.cpu()
        changed = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        swapped = (~changed) & (ia != ib).any(-1)
        margin = route_margin(pa, k)
        which = torch.arange(ia.shape[0]) // seq
        pos = torch.arange(ia.shape[0]) % seq
        if first is None:  # per sequence, the first changed position
            first = torch.full((ia.shape[0] // seq,), seq)
        up = first[which] <= pos
        if earlier is not None:
            up |= (earlier["before"][layer] < earlier["seq"])[which]
        before.append(first.clone())
        rest = ~changed & ~up
        noise = (float((pa - pb)[rest].abs().max()) if bool(rest.any())
                 else 0.0)
        near = max(MESH_NEAR_TIE, 2 * noise)
        tie = changed & (margin < near)
        bad = changed & ~tie & ~up
        rows.append({"changed": int(changed.sum()), "tie": int(tie.sum()),
                     "downstream": int((changed & ~tie & up).sum()),
                     "unexplained": int(bad.sum()),
                     "margin": float(margin[bad].max()) if bool(bad.any())
                     else -1.0, "swaps": int(swapped.sum()), "near": near,
                     "widest": float(margin[changed].max())
                     if bool(changed.any()) else -1.0})
        at = torch.where(changed, pos, seq).reshape(-1, seq).min(-1).values
        first = torch.minimum(first, at)
    return {"rows": rows, "before": before, "seq": seq}


def mesh_moe_layer(tag, model, topo, prompts, card) -> None:
    """One MoE layer of `model` at full width on phase 10's prefill input
    (the mesh's big-batch path) and on a 4-token decode input (its small
    path), each against the one-device apply_moe and moe_dense_oracle at
    capacity factor E/k."""
    import dataclasses

    import torch

    from repro_torch.configs.base import FFN_MOE
    from repro_torch.models.blocks import layer_groups
    from repro_torch.models.moe import apply_moe, moe_dense_oracle
    from repro_torch.models.norms import apply_norm

    cfg = model.cfg
    nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                 / cfg.n_experts_per_token)
    ntopo = dataclasses.replace(topo, model=nodrop)
    params = model.params()
    groups = layer_groups(model.specs)
    j = next(i for i, sp in enumerate(groups.pattern) if sp.ffn == FFN_MOE)
    # the layer's placed leaves (sliced part by part) for the mesh, and
    # joined for the one-device call and the oracle
    placed = {k: _placed_slice(v, 0)
              for k, v in params["blocks"]["stack"][f"l{j}"].items()}
    layer = _whole_tree(placed)
    embed = params["embed"].whole()
    b, p = prompts.shape[0], LLM_PROMPT
    with torch.no_grad():
        for what, tokens in (("prefill", prompts[:, :p]),
                             ("decode", prompts[:, p:p + 1])):
            h = apply_norm(layer["norm2"], embed[tokens], cfg.norm)
            with MoeProbe() as probe:
                y, aux = apply_moe(placed["ffn"], h, nodrop, ntopo)
            y1, aux1 = apply_moe(layer["ffn"], h, nodrop)
            yo, _ = moe_dense_oracle(layer["ffn"], h, nodrop)
            kept = min([float(k) for k in probe.keep] or [1.0])
            mesh_ms = cuda_ms(lambda: apply_moe(placed["ffn"], h, nodrop,
                                                ntopo))
            one_ms = cuda_ms(lambda: apply_moe(layer["ffn"], h, nodrop))
            top = float(y1.float().abs().max())
            d1 = float((y.float() - y1.float()).abs().max())
            do = float((y.float() - yo.float()).abs().max())
            log(f"[mesh] {tag} one MoE layer, {what} input "
                f"({b * tokens.shape[1]} tokens, capacity factor {nodrop.capacity_factor:.4g}, kept "
                f"{kept:.4f}): on the mesh {mesh_ms:.3f} ms, one device "
                f"{one_ms:.3f} ms; max |y| {top:.4g}, max |diff| against "
                f"one device {d1:.4g}, against moe_dense_oracle {do:.4g} "
                f"(bound {MESH_LAYER_TOL:.4g} of max |y|); aux "
                f"{float(aux):.6f} against {float(aux1):.6f} (the mesh's is "
                f"the mean of its shards' own, as the reference's)")
            if not (kept == 1.0 and d1 <= MESH_LAYER_TOL * top
                    and do <= MESH_LAYER_TOL * top):
                raise AssertionError(f"{tag}: the mesh's MoE layer disagrees "
                                     f"on the {what} input")
    del y, y1, yo, h, layer, placed, embed, params


def _placed_slice(tree, i):
    """Repeat i of a tree of stacked placed leaves (views, part by
    part; the stacked axis is never split under dp_tp)."""
    if isinstance(tree, dict):
        return {k: _placed_slice(v, i) for k, v in tree.items()}
    return tree.map(lambda t: t[i], tree.spec[1:])


def _whole_tree(tree):
    if isinstance(tree, dict):
        return {k: _whole_tree(v) for k, v in tree.items()}
    return tree.whole()


def mesh_serve(tag, model, card) -> dict:
    """Phase 10's requests on the mesh model at the config's capacity:
    prefill (timed, rerun bitwise, drops by model shard), 32 greedy
    decode steps (timed, logits finite)."""
    import numpy as np
    import torch

    cfg, device = model.cfg, model.device
    gen = torch.Generator(device=device)
    gen.manual_seed(LLM_SEED + 1)
    b, p = LLM_BATCH, LLM_PROMPT
    prompts = torch.randint(0, cfg.vocab_size, (b, p + 1), generator=gen,
                            device=device)
    batch = {"tokens": prompts[:, :p]}
    model.prefill(batch, cache_len=LLM_CACHE)  # warm-up
    out = [None]

    def prefill():
        out[0] = model.prefill(batch, cache_len=LLM_CACHE)

    with MoeProbe() as probe:
        pre_ms = cuda_ms(prefill)
    cache, last = out[0]
    cache2, last2 = model.prefill(batch, cache_len=LLM_CACHE)
    same = torch.equal(last, last2) and all(
        torch.equal(a, c) for kv in ("k", "v")
        for a, c in zip(layer_kvs(cache, kv), layer_kvs(cache2, kv)))
    del cache2, last2
    n = model.topo.n_devices
    keep = np.array([float(k) for k in probe.keep]).reshape(-1, n)
    drops = [round(float(x), 4) for x in 1 - keep.mean(axis=0)]
    token = prompts[:, p:p + 1]
    step_ms, logits = [], []
    for i in range(LLM_DECODE):
        pos = torch.full((b,), p + i, dtype=torch.long, device=device)

        def step():
            out[0] = model.decode_step(cache, token, pos)

        step_ms.append(cuda_ms(step))
        lg, cache = out[0]
        logits.append(lg)
        token = lg[:, :, :cfg.vocab_size].argmax(dim=-1)
    logits = torch.cat(logits, dim=1)
    finite = bool(torch.isfinite(logits).all()) and bool(
        torch.isfinite(last).all())
    dec = float(np.mean(step_ms[1:]))
    log(f"[mesh] {tag} served on the mesh, {b} x {p} prefill at capacity "
        f"factor {cfg.capacity_factor}: {pre_ms:.3f} ms, a rerun bitwise "
        f"{same}; share of routed entries dropped by shard (mean over "
        f"layers) {drops}, largest in a layer "
        f"{round(float(1 - keep.min()), 4)}; {LLM_DECODE} greedy decode "
        f"steps: first {step_ms[0]:.3f} ms, then mean {dec:.3f} ms; logits "
        f"finite {finite}")
    if not (same and finite):
        raise AssertionError(f"{tag}: the mesh's serving run failed")
    del cache, logits
    return {"prefill_ms": pre_ms, "decode_ms": dec}


def mesh_cut(tag, cfg, topo, device) -> None:
    """The config cut to LLM_CHECK_LAYERS layers at capacity factor E/k,
    in float32: prefill and the first decode step on the mesh against
    the one-device model on the same weights, expert ids compared layer
    by layer."""
    import dataclasses

    import torch

    from repro_torch.models import build_model

    cut = dataclasses.replace(cfg, n_layers=LLM_CHECK_LAYERS,
                              dtype="float32", capacity_factor=cfg.n_experts
                              / cfg.n_experts_per_token)
    ctopo = dataclasses.replace(topo, model=cut)
    gen = torch.Generator(device=device)
    gen.manual_seed(LLM_SEED)
    one = build_model(cut, device=device).init(gen)
    mesh = on_topology(one, ctopo)
    b, p, v = LLM_BATCH, LLM_PROMPT, cut.vocab_size
    prompts = torch.randint(0, v, (b, p + 1), generator=gen, device=device)
    n = ctopo.n_devices
    tp = ctopo.tp_size
    ep_path = ctopo.rules["experts"] is not None
    res = {}
    for name, m in (("one", one), ("mesh", mesh)):
        with MoeProbe() as pre:
            cache, last = m.prefill({"tokens": prompts[:, :p]},
                                    cache_len=LLM_CACHE)
        with MoeProbe() as dec:
            step, _ = m.decode_step(cache, prompts[:, p:],
                                    torch.full((b,), p, device=device))
        res[name] = (last, step, pre, dec)
        del cache
    # which shards' routes cover the tokens once, in order: EP slices
    # every data shard's tokens over `model` (all positions, row-major);
    # TP and EP-small repeat a data shard's routing over `model`
    every = list(range(n))
    first = [i for i in range(n) if i % tp == 0]
    pre_m = mesh_routes(res["mesh"][2], n, every if ep_path else first)
    dec_m = mesh_routes(res["mesh"][3], n, first)
    k = cut.n_experts_per_token
    pre = route_changes(pre_m, res["one"][2].routes, k, p)
    dec = route_changes(dec_m, res["one"][3].routes, k, 1, pre)
    rows = pre["rows"] + dec["rows"]
    d_pre = logits_spread(res["mesh"][0][..., :v], res["one"][0][..., :v])[0]
    d_dec = logits_spread(res["mesh"][1][..., :v], res["one"][1][..., :v])[0]
    log(f"[mesh] {tag} cut to {LLM_CHECK_LAYERS} layers, float32, capacity "
        f"factor {cut.capacity_factor:.4g}: on the mesh against one device, "
        f"by MoE layer (prefill's {len(pre['rows'])}, then the first decode "
        f"step's) the tokens whose expert set differs / at a near-tie "
        f"(margin below the bound) / downstream of an earlier layer's "
        f"change in their sequence / neither (their largest margin) / rank "
        f"swaps inside an unchanged set, the largest margin of a changed "
        f"set, the near-tie bound: "
        + "; ".join(f"{r['changed']} / {r['tie']} / {r['downstream']} / "
                    f"{r['unexplained']} ({r['margin']:.3g}) / {r['swaps']}"
                    f", {r['widest']:.3g}, {r['near']:.3g}" for r in rows)
        + f" (bound: none neither); max |diff| over max |logit| prefill "
        f"{d_pre:.4g}, first decode step {d_dec:.4g} (bound "
        f"{LLM_DECODE_TOL})")
    if any(r["unexplained"] for r in rows) or not (
            d_pre <= LLM_DECODE_TOL and d_dec <= LLM_DECODE_TOL):
        raise AssertionError(f"{tag}: the cut model on the mesh disagrees "
                             "with one device")
    del one, mesh, res
    torch.cuda.empty_cache()


def mesh_moe(tag, arch, shape, device, card, **sharding) -> dict:
    """12a / 12b: a MoE config at full width on a mesh."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch)
    topo = mesh_topology(cfg, shape, ("data", "model"), device, **sharding)
    path = ("EP (experts over model)" if topo.rules["experts"]
            else "TP-in-expert (expert FFN over model)")
    log(f"[mesh] {tag} {arch} at full width on a {shape} (data, model) "
        f"mesh of {[str(d) for d in topo.mesh.device_list()]}: {path}, "
        f"batch over {topo.rules['batch']}")
    gen = torch.Generator(device=device)
    gen.manual_seed(LLM_SEED)
    model = build_model(cfg, topo).init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (LLM_BATCH, LLM_PROMPT + 1),
                            generator=gen, device=device)
    mesh_moe_layer(tag, model, topo, prompts, card)
    nums = mesh_serve(tag, model, card)
    del model, prompts
    torch.cuda.empty_cache()
    mesh_cut(tag, cfg, topo, device)
    return nums


def mesh_llm(device, card) -> dict:
    """12c: llama3-8b at full width, decoding with the cache split on its
    sequence axis over `model` on (1, 4) and over `data` on (4, 1), fed
    the one-device greedy run's tokens: layer 0's decoded K/V bitwise,
    the full-depth logits spread printed, and the 2-layer cut's first
    decode step within LLM_DECODE_TOL (float32)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

    cfg = get_config(LLM_ARCH)
    gen = torch.Generator(device=device)
    gen.manual_seed(LLM_SEED)
    one = build_model(cfg, device=device).init(gen)
    b, p, v = LLM_BATCH, LLM_PROMPT, cfg.vocab_size
    prompts = torch.randint(0, v, (b, p), generator=gen, device=device)

    def run(model, tokens=None):
        cache, last = model.prefill({"tokens": prompts}, cache_len=LLM_CACHE)
        token = last[:, :, :v].argmax(-1) if tokens is None else tokens[0]
        fed, logits, ms = [], [], []
        for i in range(LLM_DECODE):
            fed.append(token)
            pos = torch.full((b,), p + i, dtype=torch.long, device=device)
            out = [None]

            def step():
                out[0] = model.decode_step(cache, token, pos)

            ms.append(cuda_ms(step))
            lg, cache = out[0]
            logits.append(lg)
            token = (lg[:, :, :v].argmax(-1) if tokens is None
                     else tokens[min(i + 1, LLM_DECODE - 1)])
        return cache, torch.cat(logits, 1), fed, float(np.mean(ms[1:]))

    cache1, logits1, fed, one_ms = run(one)
    nums = {}
    for shape, axis in (((1, 4), "model"), ((4, 1), "data")):
        topo = mesh_topology(cfg, shape, ("data", "model"), device,
                             seq_sharded_kv=True, kv_seq_axis=axis)
        mesh = on_topology(one, topo)
        cache, logits, _, ms = run(mesh, fed)
        k0 = [whole_leaf(cache["stack"]["l0"][kv])[0] for kv in ("k", "v")]
        r0 = [cache1["stack"]["l0"]["k"][0], cache1["stack"]["l0"]["v"][0]]
        same = all(torch.equal(a[:, p:p + LLM_DECODE], c[:, p:p + LLM_DECODE])
                   for a, c in zip(k0, r0))
        spread, agree = logits_spread(logits[..., :v], logits1[..., :v])
        log(f"[mesh] 12c {LLM_ARCH} decode with the {LLM_CACHE}-slot cache "
            f"split {topo.axis_sizes[axis]} x "
            f"{LLM_CACHE // topo.axis_sizes[axis]} over {axis} on {shape}: "
            f"{LLM_DECODE} steps fed the one-device run's tokens, mean "
            f"{ms:.3f} ms a step against {one_ms:.3f} on one device; layer "
            f"0's decoded K/V bitwise {same}; full-depth logits max |diff| "
            f"over max |logit| {spread:.4g} (chaotic depth: printed), "
            f"argmax equal on {agree:.3f}")
        if not same:
            raise AssertionError("12c: layer 0's decoded K/V differ")
        nums[axis] = ms
        del cache, logits, mesh
    del one, cache1, logits1
    torch.cuda.empty_cache()
    # float32: in bf16 the flash-decode rounds its unnormalised weights
    # for the PV product where the one-device decode rounds the
    # normalised ones (the reference's two decodes do the same), a bf16
    # rounding of each layer's attention output
    cut = dataclasses.replace(cfg, n_layers=LLM_CHECK_LAYERS,
                              dtype="float32")
    gen.manual_seed(LLM_SEED)
    one = build_model(cut, device=device).init(gen)
    prompts = torch.randint(0, v, (b, p), generator=gen, device=device)
    _, logits1, fed, _ = run(one)
    for shape, axis in (((1, 4), "model"), ((4, 1), "data")):
        mesh = on_topology(one, mesh_topology(
            cut, shape, ("data", "model"), device, seq_sharded_kv=True,
            kv_seq_axis=axis))
        _, logits, _, _ = run(mesh, fed)
        d = logits_spread(logits[:, 0, :v], logits1[:, 0, :v])[0]
        worst = max(logits_spread(logits[:, i, :v], logits1[:, i, :v])[0]
                    for i in range(LLM_DECODE))
        log(f"[mesh] 12c {LLM_ARCH} cut to {LLM_CHECK_LAYERS} layers, "
            f"float32, decode over {axis} on {shape} against one device: first step "
            f"max |diff| over max |logit| {d:.4g} (bound {LLM_DECODE_TOL}, "
            f"phase 9's first-step gate); over the {LLM_DECODE} steps at "
            f"most {worst:.4g}")
        if not d <= LLM_DECODE_TOL:
            raise AssertionError("12c: the cut model's decode disagrees")
    del one, logits1
    torch.cuda.empty_cache()
    return nums


def mesh_train(device, card, train_ms) -> None:
    """12d: make_dp_train_step on olmoe-1b-7b at full width cut to
    DP_LAYERS layers over a DP_SHARDS-shard ("data",) mesh."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.base import MeshSpec, OptimizerConfig
    from repro_torch.configs.base import ShardingConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import make_mesh_from_spec
    from repro_torch.train.compression import error_feedback, init_error
    from repro_torch.train.step import (
        init_train_state,
        make_dp_train_step,
        make_train_step,
    )
    from repro_torch.tree import tree_leaves

    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=DP_LAYERS)
    ocfg = OptimizerConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS)
    mesh = make_mesh_from_spec(MeshSpec((DP_SHARDS,), ("data",)),
                               mesh_devices(DP_SHARDS, device))
    batches = [synth_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, i)
               for i in range(TRAIN_DATA)]

    def train(compress=True, steps=DP_STEPS, timed=False):
        model = build_model(cfg, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(LLM_SEED)
        state = init_train_state(model, gen, ocfg)
        state["error"] = init_error(state["params"])
        step = make_dp_train_step(model, ocfg, mesh, compress=compress)
        losses, ms, out = [], [], [None]
        for i in range(steps):
            def run():
                out[0] = step(state, batches[i % TRAIN_DATA])

            ms.append(cuda_ms(run))
            state, m = out[0]
            losses.append(float(m["loss"]))
        return model, state, losses, ms

    model, state, losses, ms = train()
    n_params = sum(p.numel() for p in model.parameters())
    state_gb = sum(t.numel() * t.element_size() for t in tree_leaves(
        {k: state[k] for k in ("params", "opt")})) / 1e9
    err_gb = sum(t.numel() * t.element_size()
                 for t in tree_leaves(state["error"])) / 1e9
    step_ms = float(np.mean(ms[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[mesh] 12d {TRAIN_ARCH} cut to {DP_LAYERS} of {full.n_layers} "
        f"layers ({n_params:,} parameters, state {state_gb:.3f} GB, error "
        f"buffers {err_gb:.3f} GB for {DP_SHARDS} shards) on a "
        f"{DP_SHARDS}-shard (data,) mesh of "
        f"{[str(d) for d in mesh.device_list()]}, compress=True: loss by "
        f"step {[round(x, 4) for x in losses]}; first step {ms[0]:.1f} ms, "
        f"then mean {step_ms:.1f} ms, {tokens / (step_ms / 1e3):.5g} "
        f"tokens/s (phase 11's one-device step on {TRAIN_LAYERS} layers at "
        f"grad_accum 2: {train_ms:.1f} ms)")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("12d: the loss does not fall")
    final = [t.clone() for t in tree_leaves(state["params"])]
    final_err = [t.clone() for t in tree_leaves(state["error"][-1])]
    # the compression's own cost: each shard's error feedback over every
    # leaf (the float32 mu standing in for a gradient), CUDA events
    g = tree_leaves(state["opt"].mu)
    errs = [tree_leaves(e) for e in state["error"]]
    comp_ms = cuda_ms(lambda: [error_feedback(a, e) for es in errs
                               for a, e in zip(g, es)])
    # the same model one device at grad_accum DP_SHARDS, same state
    one_step = make_train_step(model, ocfg, ShardingConfig(
        grad_accum=DP_SHARDS))
    one = []
    for i in range(3):
        box = [None]
        one.append(cuda_ms(lambda: box.__setitem__(0, one_step(
            {"params": state["params"], "opt": state["opt"]},
            batches[i % TRAIN_DATA]))))
    log(f"[mesh] 12d the compression's own cost: {comp_ms:.2f} ms a step "
        f"({DP_SHARDS} shards' error feedback over every leaf); the same "
        f"model on one device at grad_accum {DP_SHARDS}: mean "
        f"{float(np.mean(one[1:])):.1f} ms a step")
    del model, state, g, errs, one_step
    torch.cuda.empty_cache()
    _, state, losses2, _ = train()
    same = (losses2 == losses and all(
        torch.equal(a, c) for a, c in zip(final,
                                           tree_leaves(state["params"])))
        and all(torch.equal(a, c) for a, c in zip(
            final_err, tree_leaves(state["error"][-1]))))
    log(f"[mesh] 12d a rerun from the same seed: losses, parameters and "
        f"the last shard's error buffers bitwise {same}")
    if not same:
        raise AssertionError("12d: a rerun of the DP step differs")
    del state, final, final_err
    torch.cuda.empty_cache()

    # compress=False against make_train_step on the whole batch: float32,
    # aux off, nothing drops (the aux and the drops are per-shard); at
    # factor E/k the capacity is the token count
    check = dataclasses.replace(
        cfg, dtype="float32", router_aux_loss=0.0,
        capacity_factor=cfg.n_experts / cfg.n_experts_per_token)
    after = []
    for kind in ("dp", "one"):
        model = build_model(check, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(LLM_SEED)
        state = init_train_state(model, gen, ocfg)
        step = (make_dp_train_step(model, ocfg, mesh, compress=False)
                if kind == "dp" else
                make_train_step(model, ocfg, ShardingConfig(grad_accum=1)))
        state, m = step(state, batches[0])
        after.append((tree_leaves(state["params"]), float(m["loss"])))
        if kind == "dp":
            after[0] = ([t.clone() for t in after[0][0]], after[0][1])
            del state, model
            torch.cuda.empty_cache()
    worst = max(float((a - c).abs().max())
                for a, c in zip(after[0][0], after[1][0]))
    log(f"[mesh] 12d compress=False over {DP_SHARDS} shards against "
        f"make_train_step on the whole batch ({DP_LAYERS} layers, float32, "
        f"aux off, nothing drops): loss {after[0][1]:.6f} and "
        f"{after[1][1]:.6f}; parameters after one step max |diff| "
        f"{worst:.3g} (bound {TRAIN_ACCUM_ATOL})")
    if not worst <= TRAIN_ACCUM_ATOL:
        raise AssertionError("12d: the uncompressed DP step disagrees with "
                             "the one-device step")
    del after, state, model
    torch.cuda.empty_cache()


def mesh_merge(device, obs_x, card) -> None:
    """12e: merge_over_axis of phase 3's observables over an
    MERGE_SHARDS-shard mesh against merge_blocks: bitwise."""
    import torch

    from repro_torch.configs.base import MeshSpec
    from repro_torch.core.reduction import (
        Welford,
        blocked_welford,
        merge_blocks,
        merge_over_axis,
    )
    from repro_torch.sharding.rules import make_mesh_from_spec

    obs = obs_x.to(torch.float32)
    mesh = make_mesh_from_spec(MeshSpec((MERGE_SHARDS,), ("data",)),
                               mesh_devices(MERGE_SHARDS, device))
    rows = obs.shape[0] // MERGE_SHARDS
    devs = mesh.device_list()
    out = [None, None]

    def sharded():
        parts = [Welford(*(leaf[0] for leaf in blocked_welford(
            obs[k * rows:(k + 1) * rows].to(devs[k]), 1)))
            for k in range(MERGE_SHARDS)]
        out[0] = merge_over_axis(parts, mesh, "data")[0]

    def blocked():
        out[1] = merge_blocks(blocked_welford(obs, MERGE_SHARDS))

    sharded()
    blocked()
    s_ms, b_ms = cuda_ms(sharded), cuda_ms(blocked)
    same = all(torch.equal(a.to(device), c) for a, c in zip(*out))
    log(f"[mesh] 12e merge_over_axis of phase 3's {tuple(obs.shape)} "
        f"observables over a {MERGE_SHARDS}-shard mesh: {s_ms:.3f} ms; "
        f"merge_blocks of the same {MERGE_SHARDS} blocks {b_ms:.3f} ms; "
        f"bitwise {same}")
    if not same:
        raise AssertionError("12e: merge_over_axis differs from "
                             "merge_blocks")


def phase_mesh(device, card, obs_x, train_ms) -> dict:
    """Phase 12: the multi-device pieces on a mesh of the visible cards,
    or of repeated entries of the one card."""
    import torch

    n = torch.cuda.device_count()
    log(f"[mesh] 12 {n} card(s) visible: meshes of "
        + ("cuda:0..3" if n >= MESH_SHARDS else
           f"repeated entries of {device}") + "; every shard's body runs in "
        "mesh order on the host, its kernels on its card")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    t0 = time.perf_counter()
    with sub_phase("12a olmoe-1b-7b EP on (1, 4)", card):
        mesh_moe("12a", "olmoe-1b-7b", (1, 4), device, card,
                 expert_parallel=True)
    with sub_phase("12b deepseek-moe-16b TP-in-expert on (2, 2)", card):
        mesh_moe("12b", "deepseek-moe-16b", (2, 2), device, card,
                 expert_parallel=False)
    with sub_phase("12c llama3-8b sequence-sharded decode", card):
        nums = mesh_llm(device, card)
    with sub_phase("12d the data-parallel step", card):
        mesh_train(device, card, train_ms)
    with sub_phase("12e merge_over_axis", card):
        mesh_merge(device, obs_x, card)
    log(f"[mesh] phase 12 took {time.perf_counter() - t0:.1f} s; {card}")
    return nums


# phase 13: the dense layers placed by their specs, over four entries of
# cuda:0 (cuda:0..3 where four cards are visible)
DENSE_MESHES = (((1, 4), "dp_tp"), ((2, 2), "fsdp_tp"))
# the 2-layer float32 cut on a mesh against one device: prefill's last
# logits and the first decode step, and each parameter's gradient on one
# microbatch. Only the order of the sums differs (four partial products
# and a psum where one device adds one product), and float32 carries
# these random full-width layers only so far, so the bound comes from a
# control in the same run: the one-device float32 model against the
# same weights evaluated in float64 throughout by `f64_llama` (only its
# RoPE table is the model's float32 one, which defines the function).
# Two float32 evaluations each that far from float64 differ by up to
# twice it, so the mesh is held within DENSE_NOISE_FACTOR times the
# control (per leaf for gradients), and the control itself within
# DENSE_F64_TOL of max |logit| or of each leaf's largest gradient (the
# float64 forward against the model's). A bf16 one-device model against
# float64 is printed beside them: the size of a one-rounding fault. On
# the H100 the float32 control read 3.9e-4 on the logits and 1.1e-4 to
# 1.07e-2 on the gradients, the meshes 0.65-1.24 times it, the bf16
# control 0.41 and 0.13-1.9: a wrong sum or a missing psum moves a leaf
# by a share of its size, far above these bounds
DENSE_NOISE_FACTOR = 4
DENSE_F64_TOL = 5e-2
# ... and the float32 train steps, from the default optimizer: each
# step's loss within DENSE_LOSS_RTOL of one device's (a mean over 8,192
# tokens). The parameters after them are printed, not gated: Adam
# divides each entry by its own size, so an entry whose gradient lies
# within float32's noise of zero may step either way
DENSE_LOSS_RTOL = 1e-4
# the fsdp_tp step: llama3-8b cut to 4 of 32 layers (its state, about
# 27 GB, fits one card; the full model's about 128 GB does not), on
# (2, 2), at the registry's grad_accum; the float32 2-layer cut over
# DENSE_CHECK_STEPS steps, whose placed state (about 18 GB) goes through
# the store
DENSE_TRAIN_LAYERS = 4
DENSE_CHECK_STEPS = 3


def dense_topology(cfg, shape, strategy, device, **kw):
    from repro_torch.configs.base import MeshSpec, ShardingConfig
    from repro_torch.sharding.rules import Topology, make_mesh_from_spec

    mesh = make_mesh_from_spec(MeshSpec(shape, ("data", "model")),
                               mesh_devices(shape[0] * shape[1], device))
    return Topology(mesh, cfg, ShardingConfig(strategy=strategy, **kw))


def placed_layout(model) -> str:
    """A few leaves' specs and part shapes, as placed."""
    params = model.params()
    leaves = {"embed": params["embed"],
              "wq": params["blocks"]["stack"]["l0"]["mixer"]["wq"],
              "wk": params["blocks"]["stack"]["l0"]["mixer"]["wk"],
              "w_down": params["blocks"]["stack"]["l0"]["ffn"]["w_down"]}
    return "; ".join(f"{k} {tuple(v.shape)} by {v.spec} as "
                     f"{tuple(v.parts[0].shape)}" for k, v in leaves.items())


def bf16_ulps(a, b) -> int:
    """The largest distance in bf16 steps between a and b (same-sign
    values; a sign change counts as large)."""
    import torch

    ia = a.contiguous().view(torch.int16).to(torch.int32)
    ib = b.contiguous().view(torch.int16).to(torch.int32)
    return int((ia - ib).abs().max())


def f64_llama(cfg, params, tokens):
    """A plain forward of a llama-style config (RMSNorm, half-split RoPE,
    GQA, SwiGLU, an untied head, no biases) in float64 throughout, from
    `params` (the model's tree of whole leaves, already float64): the
    logits over the unpadded vocabulary, (B, S, vocab_size). The RoPE
    table is the model's own, computed in float32 as it defines it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.rope import rope_freqs

    if not (cfg.norm == "rmsnorm" and cfg.mlp_variant == "swiglu"
            and cfg.use_rope and not cfg.tie_embeddings and not cfg.mlp_bias
            and not cfg.parallel_block and cfg.family == "dense"):
        raise ValueError(f"f64_llama does not cover {cfg.name}")
    dev, s = tokens.device, tokens.shape[1]
    hd = cfg.resolved_head_dim
    angles = (torch.arange(s, dtype=torch.float32, device=dev)[:, None]
              * rope_freqs(hd, cfg.rope_theta, dev))
    cos, sin = (f(angles).double()[:, None, :] for f in (torch.cos,
                                                         torch.sin))

    def rope(t):
        t1, t2 = t.chunk(2, dim=-1)
        return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos], -1)

    def norm(x, scale):
        return x * (x.pow(2).mean(-1, keepdim=True) + 1e-6).rsqrt() * scale

    group = cfg.n_heads // cfg.n_kv_heads
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    st = params["blocks"]["stack"]["l0"]
    x = params["embed"][tokens]
    for i in range(cfg.n_layers):
        at, ff = st["mixer"], st["ffn"]
        h = norm(x, st["norm1"]["scale"][i])
        q = rope(torch.einsum("bsd,dhk->bshk", h, at["wq"][i]))
        k = rope(torch.einsum("bsd,dhk->bshk", h, at["wk"][i]))
        v = torch.einsum("bsd,dhk->bshk", h, at["wv"][i])
        k, v = (t.repeat_interleave(group, dim=2) for t in (k, v))
        w = torch.einsum("bqhk,bshk->bhqs", q, k) * hd ** -0.5
        w = w.masked_fill(~causal, float("-inf")).softmax(-1)
        o = torch.einsum("bhqs,bshk->bqhk", w, v)
        x = x + torch.einsum("bshk,hkd->bsd", o, at["wo"][i])
        h = norm(x, st["norm2"]["scale"][i])
        x = x + (F.silu(h @ ff["w_gate"][i]) * (h @ ff["w_up"][i])) \
            @ ff["w_down"][i]
    x = norm(x, params["final_norm"]["scale"])
    return x @ params["head"][:, :cfg.vocab_size]


def f64_tree(params, grad: bool = False):
    """A float64 copy of a tree of whole leaves (requiring grad where
    asked)."""
    if isinstance(params, dict):
        return {k: f64_tree(v, grad) for k, v in params.items()}
    if isinstance(params, list):
        return [f64_tree(v, grad) for v in params]
    return whole_leaf(params).detach().double().requires_grad_(grad)


def spread(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    return float((got.double() - ref.double()).abs().max()) / float(
        ref.double().abs().max())


def dense_serve_run(model, prompts, fed=None):
    """Phase 9's requests on `model`: prefill (a warm-up, then timed),
    LLM_DECODE decode steps, greedy or `fed` tokens. Returns (cache,
    last, logits (B, LLM_DECODE, V), the fed tokens, prefill ms, decode
    ms of each step)."""
    import torch

    b, p = LLM_BATCH, LLM_PROMPT
    v = model.cfg.vocab_size
    device = model.device
    batch = {"tokens": prompts[:, :p]}
    model.prefill(batch, cache_len=LLM_CACHE)
    out = [None]

    def prefill():
        out[0] = model.prefill(batch, cache_len=LLM_CACHE)

    pre_ms = cuda_ms(prefill)
    cache, last = out[0]
    token = prompts[:, p:p + 1] if fed is None else fed[0]
    tokens, logits, ms = [], [], []
    for i in range(LLM_DECODE):
        tokens.append(token)
        pos = torch.full((b,), p + i, dtype=torch.long, device=device)

        def step():
            out[0] = model.decode_step(cache, token, pos)

        ms.append(cuda_ms(step))
        lg, cache = out[0]
        logits.append(lg)
        token = (lg[:, :, :v].argmax(-1) if fed is None
                 else fed[min(i + 1, LLM_DECODE - 1)])
    return cache, last, torch.cat(logits, 1), tokens, pre_ms, ms


def dense_serve(device, card, llm, seq_decode) -> None:
    """13a: llama3-8b at full width served on (1, 4) under dp_tp and on
    (2, 2) under fsdp_tp, its parameters placed by param_shardings
    (views of the one-device model's weights), against the one-device
    run."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

    cfg = get_config(LLM_ARCH)
    gen = torch.Generator(device=device)
    gen.manual_seed(LLM_SEED)
    one = build_model(cfg, device=device).init(gen)
    b, p, v = LLM_BATCH, LLM_PROMPT, cfg.vocab_size
    prompts = torch.randint(0, v, (b, p + 1), generator=gen, device=device)
    cache1, _, logits1, fed, one_pre, one_ms = dense_serve_run(one, prompts)
    n = p + LLM_DECODE
    ref0 = [cache1["stack"]["l0"][kv][0, :, :n] for kv in ("k", "v")]
    for shape, strategy in DENSE_MESHES:
        topo = dense_topology(cfg, shape, strategy, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh = on_topology(one, topo)
        log(f"[dense] 13a {LLM_ARCH} at full width on {shape} (data, model) "
            f"under {strategy} over {[str(d) for d in topo.mesh.device_list()]}:"
            f" {placed_layout(mesh)}")
        runs = [dense_serve_run(mesh, prompts, fed) for _ in range(2)]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        cache, last, logits, _, pre_ms, ms = runs[0]
        got0 = [whole_leaf(cache["stack"]["l0"][kv])[0, :, :n]
                for kv in ("k", "v")]
        ulps = max(bf16_ulps(a, r) for a, r in zip(got0, ref0))
        c2, last2, logits2 = runs[1][:3]
        rerun = (torch.equal(last, last2) and torch.equal(logits, logits2)
                 and all(torch.equal(whole_leaf(a), whole_leaf(c))
                         for a, c in zip(tree_walk(cache), tree_walk(c2))))
        spread, agree = logits_spread(logits[..., :v], logits1[..., :v])
        dec = float(np.mean(ms[1:]))
        log(f"[dense] 13a on {shape}: layer 0's K/V over the {n} positions "
            f"against the one-device run: "
            + ("bitwise" if ulps == 0 else
               f"within {ulps} bf16 step(s), not bitwise")
            + f" (bound one step); a rerun bitwise {rerun}; full-depth "
            f"logits max |diff| over max |logit| {spread:.4g}, argmax equal "
            f"on {agree:.3f} (chaotic depth: printed, not gated); prefill "
            f"{b} x {p} {pre_ms:.3f} ms (one device here {one_pre:.3f}, "
            f"phase 9 {llm['prefill_ms']:.3f}); decode mean {dec:.3f} ms a "
            f"step (one device here {float(np.mean(one_ms[1:])):.3f}, phase "
            f"9 {llm['decode_ms']:.3f}, phase 12c's sequence-sharded "
            f"{seq_decode['model']:.3f} / {seq_decode['data']:.3f}); peak "
            f"memory {peak_gb:.3f} GB (phase 9 {llm['peak_gb']:.3f}); "
            f"{card}")
        if not (ulps <= 1 and rerun and bool(torch.isfinite(logits).all())):
            raise AssertionError(f"13a: the placed model on {shape} "
                                 "disagrees")
        del runs, cache, c2, mesh, logits, logits2, got0
    del one, cache1, logits1, ref0
    torch.cuda.empty_cache()



def dense_cut(device, card) -> None:
    """13a's float32 check: llama3-8b cut to LLM_CHECK_LAYERS layers on
    each mesh against one device, within DENSE_NOISE_FACTOR times the
    one-device model's own distance from float64."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

    cfg = get_config(LLM_ARCH)
    b, p, v = LLM_BATCH, LLM_PROMPT, cfg.vocab_size
    gen = torch.Generator(device=device)
    cut = dataclasses.replace(cfg, n_layers=LLM_CHECK_LAYERS,
                              dtype="float32")
    gen.manual_seed(LLM_SEED)
    one = build_model(cut, device=device).init(gen)
    prompts = torch.randint(0, v, (b, p + 1), generator=gen, device=device)
    _, last1, logits1, fed, _, _ = dense_serve_run(one, prompts)
    # the controls: the float32 and the bf16 one-device model against
    # float64, at prefill's last position and the first decode step's
    exact = f64_llama(cut, f64_tree(one.params()), prompts)[:, p - 1:]
    f32 = max(spread(last1.reshape(b, -1)[:, :v], exact[:, 0]),
              spread(logits1[:, 0, :v], exact[:, 1]))
    half = build_model(dataclasses.replace(cut, dtype="bfloat16"),
                       device=device)
    half.load_state_dict(one.state_dict())  # each weight rounded once
    _, last_h, logits_h, _, _, _ = dense_serve_run(half, prompts, fed)
    bf16 = max(spread(last_h.reshape(b, -1)[:, :v], exact[:, 0]),
               spread(logits_h[:, 0, :v], exact[:, 1]))
    del half, exact, last_h, logits_h
    limit = DENSE_NOISE_FACTOR * f32
    log(f"[dense] 13a {LLM_ARCH} cut to {LLM_CHECK_LAYERS} layers: one "
        f"device against float64 (f64_llama), max |diff| over max |logit| "
        f"of prefill's last logits and the first decode step: float32 "
        f"{f32:.4g} (bound {DENSE_F64_TOL}), bf16 {bf16:.4g} (printed); "
        f"the meshes held within {DENSE_NOISE_FACTOR} x the float32 "
        f"figure, {limit:.4g}")
    if not f32 <= DENSE_F64_TOL:
        raise AssertionError("13a: the float32 model disagrees with its "
                             "float64 evaluation")
    for shape, strategy in DENSE_MESHES:
        mesh = on_topology(one, dense_topology(cut, shape, strategy, device))
        _, last, logits, _, _, _ = dense_serve_run(mesh, prompts, fed)
        d_pre = spread(last[..., :v], last1[..., :v])
        d = spread(logits[:, 0, :v], logits1[:, 0, :v])
        worst = max(spread(logits[:, i, :v], logits1[:, i, :v])
                    for i in range(LLM_DECODE))
        log(f"[dense] 13a {LLM_ARCH} cut to {LLM_CHECK_LAYERS} layers, "
            f"float32, on {shape} under {strategy} against one device: max "
            f"|diff| over max |logit| prefill {d_pre:.4g}, first decode "
            f"step {d:.4g} (bound {limit:.4g}); over the {LLM_DECODE} "
            f"steps at most {worst:.4g}")
        if not (d_pre <= limit and d <= limit):
            raise AssertionError(f"13a: the float32 cut on {shape} "
                                 "disagrees with one device")
        del mesh, logits
    del one, logits1
    torch.cuda.empty_cache()


def tree_walk(tree) -> list:
    """The leaves of a nested dict / list, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_walk(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_walk(t)]
    return [tree]


def dense_steps(model_cfg, topology, steps, opt, device):
    """`steps` train steps of `model_cfg` on `topology` (one device where
    None) from LLM_SEED's init, at llama3-8b's registry sharding, over
    TRAIN_DATA synth_batch batches of TRAIN_BATCH x TRAIN_SEQ: (model,
    state, losses, each step's ms)."""
    import torch

    from repro_torch.configs.registry import default_sharding
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import build_model
    from repro_torch.train.step import init_train_state, make_train_step

    scfg = default_sharding(LLM_ARCH)
    batches = [synth_batch(model_cfg, TRAIN_BATCH, TRAIN_SEQ, i)
               for i in range(TRAIN_DATA)]
    model = build_model(model_cfg, topology, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(LLM_SEED)
    state = init_train_state(model, gen, opt)
    step = make_train_step(model, opt, scfg)
    losses, ms, out = [], [], [None]
    for i in range(steps):
        def run():
            out[0] = step(state, batches[i % TRAIN_DATA])

        ms.append(cuda_ms(run))
        state, m = out[0]
        losses.append(float(m["loss"]))
    return model, state, losses, ms


def dense_train(device, card) -> None:
    """13b: the fsdp_tp train step of llama3-8b at full width cut to
    DENSE_TRAIN_LAYERS layers on (2, 2)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.configs.registry import default_sharding, get_config
    from repro_torch.sharding.collectives import flat_parts

    full = get_config(LLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=DENSE_TRAIN_LAYERS)
    scfg = default_sharding(LLM_ARCH)
    ocfg = OptimizerConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS)
    shape = (2, 2)
    topo = dense_topology(cfg, shape, scfg.strategy, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, state, losses, ms = dense_steps(cfg, topo, TRAIN_STEPS, ocfg,
                                           device)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state_gb = sum(t.numel() * t.element_size()
                   for t in flat_parts(state)) / 1e9
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = float(np.mean(ms[1:]))
    bound = 6 * cfg.active_param_count() * tokens / PEAK_BF16_OPS * 1e3
    log(f"[dense] 13b {LLM_ARCH} at full width cut to {cfg.n_layers} of "
        f"{full.n_layers} layers, {scfg.strategy} on {shape} over "
        f"{[str(d) for d in topo.mesh.device_list()]}: state {state_gb:.3f} "
        f"GB as parts ({placed_layout(model)}); {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} at grad_accum {scfg.grad_accum}: loss "
        f"by step {[round(x, 4) for x in losses]}; first step {ms[0]:.1f} "
        f"ms, then mean {step_ms:.1f} ms, {tokens / (step_ms / 1e3):.5g} "
        f"tokens/s; bound {bound:.3f} ms (6 x {cfg.active_param_count():,} "
        f"parameters x {tokens} tokens at {PEAK_BF16_OPS / 1e12:g} TFLOP/s "
        f"bf16), {bound / step_ms:.3f} of it; peak memory {peak_gb:.3f} GB")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and np.mean(losses[-TRAIN_DATA:]) < np.mean(
                losses[:TRAIN_DATA])):
        raise AssertionError("13b: the loss does not fall")
    final = [t.clone() for t in flat_parts(state["params"])]
    del model, state
    torch.cuda.empty_cache()
    _, state, losses2, _ = dense_steps(cfg, topo, TRAIN_STEPS, ocfg,
                                       device)
    rerun = losses2 == losses and all(
        torch.equal(a, c) for a, c in zip(final, flat_parts(state["params"])))
    log(f"[dense] 13b a rerun from the same seed: losses and every "
        f"parameter part bitwise {rerun}")
    if not rerun:
        raise AssertionError("13b: a rerun of the fsdp_tp step differs")
    del state, final
    torch.cuda.empty_cache()
    # the phase-11-style step of the same cut on one device
    _, state, _, one_ms = dense_steps(cfg, None, DENSE_CHECK_STEPS, ocfg,
                                      device)
    one_step = float(np.mean(one_ms[1:]))
    log(f"[dense] 13b the same cut on one device (make_train_step, grad_"
        f"accum {scfg.grad_accum}): mean {one_step:.1f} ms a step; the "
        f"fsdp_tp step on {shape} takes {step_ms / one_step:.2f} x it")
    del state
    torch.cuda.empty_cache()


def dense_check(device, card) -> None:
    """13b's float32 check: llama3-8b cut to LLM_CHECK_LAYERS layers on
    (2, 2) under fsdp_tp against one device, each parameter's gradient
    beside the float64 and bf16 controls, then DENSE_CHECK_STEPS steps;
    the placed state through the store."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.ckpt import store
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.configs.registry import default_sharding, get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import build_model
    from repro_torch.sharding.collectives import flat_parts
    from repro_torch.train.step import _grad_fn
    from repro_torch.tree import tree_flatten_with_path, tree_leaves

    full = get_config(LLM_ARCH)
    scfg = default_sharding(LLM_ARCH)
    shape = (2, 2)
    # the float32 2-layer cut on the mesh against one device: each
    # parameter's gradient on one microbatch, beside the float64 and bf16
    # controls; then DENSE_CHECK_STEPS steps with the default optimizer
    check = dataclasses.replace(full, n_layers=LLM_CHECK_LAYERS,
                                dtype="float32")
    ctopo = dense_topology(check, shape, scfg.strategy, device)
    mb = {k: v[:TRAIN_BATCH // scfg.grad_accum] for k, v in synth_batch(
        check, TRAIN_BATCH, TRAIN_SEQ, 0).items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(LLM_SEED)
    one = build_model(check, device=device).init(gen)
    names = [path for path, _ in tree_flatten_with_path(one.params())]
    g_one = tree_leaves(_grad_fn(one, one.params(), mb)[2])
    mesh = on_topology(one, ctopo)
    r_mesh = [spread(whole_leaf(g), w) for g, w in zip(
        tree_leaves(_grad_fn(mesh, mesh.params(), mb)[2]), g_one)]
    del mesh
    wide = f64_tree(one.params(), grad=True)
    tokens = torch.as_tensor(mb["tokens"], dtype=torch.long, device=device)
    targets = torch.as_tensor(mb["targets"], dtype=torch.long, device=device)
    logp = torch.log_softmax(f64_llama(check, wide, tokens), -1)
    ce = -torch.take_along_dim(logp, targets[..., None], -1).mean()
    g64 = torch.autograd.grad(ce, tree_leaves(wide))
    del logp, ce, wide
    r_f32 = [spread(g, w) for g, w in zip(g_one, g64)]
    del g_one
    half = build_model(dataclasses.replace(check, dtype="bfloat16"),
                       device=device)
    half.load_state_dict(one.state_dict())
    r_bf16 = [spread(g, w) for g, w in zip(
        tree_leaves(_grad_fn(half, half.params(), mb)[2]), g64)]
    del half, g64, one
    torch.cuda.empty_cache()
    limits = [DENSE_NOISE_FACTOR * r for r in r_f32]
    log(f"[dense] 13b {LLM_ARCH} cut to {LLM_CHECK_LAYERS} layers, float32: "
        f"each parameter's gradient on one {tuple(tokens.shape)} microbatch "
        f"as max |diff| over the leaf's max |gradient|, the mesh {shape} "
        f"({scfg.strategy}) against one device (bound {DENSE_NOISE_FACTOR} "
        f"x the float32 control), the float32 control (one device against "
        f"float64, bound {DENSE_F64_TOL}) and the bf16 control (printed): "
        + "; ".join(f"{n} {a:.3g} / {c:.3g} / {h:.3g}" for n, a, c, h in zip(
            names, r_mesh, r_f32, r_bf16)) + f"; {card}")
    if not (all(a <= lim for a, lim in zip(r_mesh, limits))
            and all(c <= DENSE_F64_TOL for c in r_f32)):
        raise AssertionError("13b: the float32 gradients on the mesh "
                             "disagree with one device")
    del tokens, targets
    torch.cuda.empty_cache()

    _, state, l_one, _ = dense_steps(check, None, DENSE_CHECK_STEPS,
                                     OptimizerConfig(), device)
    want = [t.clone() for t in tree_walk(state["params"])]
    del state
    torch.cuda.empty_cache()
    _, state, l_mesh, _ = dense_steps(check, ctopo, DENSE_CHECK_STEPS,
                                      OptimizerConfig(), device)
    diffs = [(whole_leaf(a) - c).abs() for a, c in zip(
        tree_walk(state["params"]), want)]
    worst = max(float(d.max()) for d in diffs)
    off = sum(int((d > 1e-6).sum()) for d in diffs) / sum(
        d.numel() for d in diffs)
    del diffs, want
    d_loss = max(abs(a - c) / abs(c) for a, c in zip(l_mesh, l_one))
    log(f"[dense] 13b the same cut: {DENSE_CHECK_STEPS} fsdp_tp steps on "
        f"{shape} against make_train_step on one device: losses {l_mesh} "
        f"and {l_one} (largest relative difference {d_loss:.3g}, bound "
        f"{DENSE_LOSS_RTOL}); parameters max |diff| {worst:.3g}, {off:.3g} "
        f"of the entries beyond 1e-6 (printed); {card}")
    if not d_loss <= DENSE_LOSS_RTOL:
        raise AssertionError("13b: the float32 fsdp_tp steps disagree with "
                             "one device")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dense_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = store.save(state, tmp, DENSE_CHECK_STEPS)
        save_s = time.perf_counter() - t0
        size_gb = os.path.getsize(os.path.join(path, "arrays.npz")) / 1e9
        t0 = time.perf_counter()
        back = store.restore(state, tmp)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(a, c) for a, c in zip(flat_parts(back),
                                                     flat_parts(state)))
        del back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[dense] 13b the cut's placed state through the pytree store "
        f"(whole leaves in the file, parts on restore): save {save_s:.2f} "
        f"s, {size_gb:.3f} GB, restore {restore_s:.2f} s, every part "
        f"bitwise {same}; {card}")
    if not same:
        raise AssertionError("13b: the restored placed state differs")
    del state
    torch.cuda.empty_cache()


def phase_dense_mesh(device, card, llm, seq_decode) -> None:
    """Phase 13: the dense layers placed by their specs on a mesh of the
    visible cards, or of repeated entries of the one card."""
    import torch

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    t0 = time.perf_counter()
    with sub_phase("13a llama3-8b served tensor-parallel", card):
        dense_serve(device, card, llm, seq_decode)
        dense_cut(device, card)
    with sub_phase("13b the fsdp_tp train step", card):
        dense_train(device, card)
        dense_check(device, card)
    log(f"[dense] phase 13 took {time.perf_counter() - t0:.1f} s; {card}")


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
    shard_launches["ssa_window"] += phase_examples(device, card)
    llm = phase_llm(device, card)
    phase_llm_parity(device)
    t_lm = time.perf_counter()
    phase_moe(device, card)
    train_ms = phase_train(device, card)
    log(f"[moe+train] phases 10 and 11 took "
        f"{time.perf_counter() - t_lm:.1f} s")
    seq_decode = phase_mesh(device, card, dense.pop("final_x"), train_ms)
    phase_dense_mesh(device, card, llm, seq_decode)
    entries = [
        ("ssa_window", "src/repro_torch/kernels/netgen.py",
         "src/repro/kernels/ssa_step.py:64", dense),
        ("sparse_window", "src/repro_torch/kernels/csrc/sparse_window.cu",
         "src/repro/kernels/ssa_step.py:291", sparse),
        ("propensity", "src/repro_torch/kernels/csrc/propensity.cu",
         "src/repro/kernels/propensity.py:72", match),
        ("tau_window", "src/repro_torch/kernels/csrc/tau_window.cu",
         "src/repro/kernels/ssa_step.py:178", tau_dense),
        ("sparse_tau_window",
         "src/repro_torch/kernels/csrc/sparse_tau_window.cu",
         "src/repro/kernels/ssa_step.py:423", tau_sparse),
    ]
    report = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": replaces,
        "launches": nums["launches"] + shard_launches.get(name, 0),
        "max_abs_err": max(worst[name], nums["err"]),
        "ms": nums["ms"],
        "tables_ms": nums.get("tables_ms"),
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
