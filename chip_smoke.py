#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. build   — compile the CUDA kernel from `src/repro_torch/kernels/csrc`
             with nvcc; print the seconds, ptxas's report and the card's
             name and power limit.
2. kernels — hold each kernel bitwise against its plain torch twin on the
             card: the fused SSA window on lv8 (65,536 lanes, per-lane
             sweep rates), ecoli (shared rates), transport (coefficient
             2) and a window cut short by a small budget.
3. main    — the port's main path at full width:
             simulate(Experiment(lv8, 2^20 replicas, use_kernel=True)).
             The launch counter must equal the window count, the records
             must be finite, a second run must repeat them bit for bit,
             and every window mean must agree with a float64
             recomputation from the pulled observables (rtol 1e-5:
             at 2^20 lanes the float32 population sums exceed 2^24).
             Prints ms per window (CUDA events, after a warm-up window),
             events per window and events/s. Then times one full-width
             kernel launch against its plain twin on the same window.
4. report  — one JSON line of per-kernel numbers, then the result line.

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

# phase 2: kernel against its plain twin
CHECK_LANES = 65_536
CHECK_SEED = 11
# phase 3: the main path at full width
MAIN_MODEL = "lv8"
MAIN_REPLICAS = 1 << 20
MAIN_T_END = 4.0
MAIN_WINDOWS = 8
MAIN_RTOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet; Hopper white paper for int32:
# 64 INT32 lanes per SM against 128 FP32 lanes)
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS = 67e12
PEAK_I32_OPS = 67e12 / 4  # half the lanes, no FMA pairing


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


def window_inputs(system, n_lanes, seed, per_lane_rates, device):
    """A fresh pool and tensors for one window of `system`: the kernel
    argument tuple minus the horizon."""
    import numpy as np
    import torch

    from repro_torch.core.gillespie import init_lanes, system_tensors

    rates = None
    if per_lane_rates:
        rng = np.random.default_rng(seed)
        rates = (system.rates[None, :] * rng.uniform(
            0.5, 1.5, (n_lanes, system.n_reactions))).astype(np.float32)
    idx, coef, delta, r = system_tensors(system, rates, device=device)
    pool = init_lanes(system, n_lanes, seed, device=device)
    return (pool.x, pool.t, pool.dead.to(torch.int32), pool.key, pool.ctr,
            pool.ctr_hi, idx, coef, delta, r)


def bitwise_diff(outs_a, outs_b) -> tuple[int, float]:
    """(number of differing elements, max abs difference) over the six
    window outputs (x, t, dead, steps, ctr, ctr_hi)."""
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


def ops_per_step(system) -> tuple[int, int, int]:
    """The least work the direct-method SSA needs, counted from
    kernels/csrc/ssa_window.cu: (float32 ops per active lane step,
    float32 ops per fired event, int32 ops per active lane step). An FMA
    counts 2.

    Work the kernel repeats or hoists is left out: the Match is counted
    once (the kernel's second pass for the scan is recomputation), and
    threefry's key schedule, fixed for a lane and hoisted out of the step
    loop, is not counted. Each reactant slot counts what C(n, c) times
    the rate needs: one multiply for c = 1; c-1 subtractions, c-1
    multiplies, the division by c! and the multiply into the rate for
    c > 1. The scan and the update depend on the reaction that fires,
    which the run does not record, so each fired event is charged their
    least: one compare of the scan and the fewest nonzero entries of a
    delta row."""
    import numpy as np

    coef = system.reactant_coef
    slots = coef[coef > 0].astype(int)
    match = int(np.where(slots == 1, 1, 2 * slots).sum())
    a0 = system.n_reactions - 1  # left-to-right sum
    # log_f32: 11 FMAs; max, convert, add, compare, two subs, add, three
    # muls (z2, z3, e*c), the final add
    log_f = 11 * 2 + 11
    uniforms = 2 * 2  # sub 1, max U_MIN
    resolve = 6  # negate, max(a0, 1e-30), divide, t + tau, two compares
    f_step = match + a0 + log_f + uniforms + resolve
    nnz = int((system.delta != 0).sum(axis=1).min())
    f_fired = 1 + 1 + nnz  # threshold multiply, one scan compare, update
    threefry = 20 * 3 + 2 + 5 * 2  # rounds (add, rotate, xor), injections
    i_step = threefry + 2 * 2 + 4 + 2  # uniforms' bits, log's bits, counter
    return f_step, f_fired, i_step


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.build()
    log(f"[build] kernel library built in {time.perf_counter() - t0:.2f} s:"
        f" {lib.name}")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build] {line.strip()}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_kernels(device) -> float:
    """Kernel against plain twin, bitwise. Returns the max abs error."""
    from repro_torch.core.cwc.compile import compile_model
    from repro_torch.core.cwc.models import MODELS
    from repro_torch.kernels.ssa_step import ssa_window_call, ssa_window_plain

    cases = [  # (model, per-lane rates, horizon, n_steps)
        ("lv8", True, 0.5, 256 * 64),
        ("ecoli", False, 2.0, 256 * 64),
        ("transport", True, 2.0, 256 * 64),
        ("lv8", False, 0.5, 48),  # budget cut: lanes still live
    ]
    worst = 0.0
    for name, per_lane, horizon, n_steps in cases:
        system, _ = compile_model(MODELS[name]())
        args = window_inputs(system, CHECK_LANES, CHECK_SEED, per_lane,
                             device)
        k = ssa_window_call(*args, horizon, n_steps=n_steps)
        p = ssa_window_plain(*args, horizon, n_steps=n_steps)
        n_diff, err = bitwise_diff(k, p)
        live_k = bool(((k[1] < horizon) & (k[2] == 0)).any())
        live_p = bool(((p[1] < horizon) & (p[2] == 0)).any())
        events = int(k[3].sum())
        log(f"[kernels] ssa_window {name} B={CHECK_LANES} "
            f"rates={'(B,R)' if per_lane else '(R,)'} n_steps={n_steps}: "
            f"{events} events, truncated={live_k}/{live_p}, "
            f"{n_diff} differing elements, max abs err {err:g}")
        if n_diff or live_k != live_p:
            raise AssertionError(f"kernel and plain twin disagree on {name}")
        if (n_steps < 256 * 64) != live_k:
            raise AssertionError(f"unexpected truncation state on {name}")
        worst = max(worst, err)
    return worst


def phase_main(device) -> dict:
    """The main path at full width; returns the numbers for the report."""
    import numpy as np
    import torch

    from repro_torch.api import Ensemble, Experiment, Schedule, build_engine
    from repro_torch.api import simulate
    from repro_torch.core.cwc.models import MODELS
    from repro_torch.kernels.ssa_step import ssa_window_call, ssa_window_plain

    exp = Experiment(model=MODELS[MAIN_MODEL](),
                     ensemble=Ensemble.make(replicas=MAIN_REPLICAS),
                     schedule=Schedule(t_end=MAIN_T_END,
                                       n_windows=MAIN_WINDOWS),
                     n_lanes=1024, use_kernel=True)

    # timed run: counts reset just before, read just after
    ssa_window_call.launches = 0
    t0 = time.perf_counter()
    res = simulate(exp, device=device, max_windows=1)  # warm-up window
    eng = res._engine
    win_ms, lane_max, warp_eff = [], [], []
    while not res.completed:
        ctr0 = eng._pool.ctr
        win_ms.append(cuda_ms(lambda: res.resume(max_windows=1)))
        # per-lane active steps this window, read outside the timed span:
        # the longest lane, and the share of each warp's 32 x (longest
        # lane) step slots that did work
        used = (eng._pool.ctr.long() - ctr0.long()) & 0xFFFFFFFF
        lane_max.append(int(used.max()))
        warp_eff.append(float(used.sum()) / float(
            32 * used.view(-1, 32).max(dim=1).values.sum()))
    wall = time.perf_counter() - t0
    launches = ssa_window_call.launches
    recs = res.records
    steps = res.telemetry.steps_per_window
    pool_mb = sum(t.numel() * t.element_size() for t in eng._pool) / 1e6
    log(f"[main] lv8 x {MAIN_REPLICAS} lanes, {MAIN_WINDOWS} windows to "
        f"t={MAIN_T_END}: {launches} kernel launches, {wall:.2f} s wall, "
        f"pool {pool_mb:.1f} MB on the device")
    log(f"[main] events per window: {list(steps)}")
    timed_events = sum(steps[1:])
    log(f"[main] ms per window after warm-up: "
        f"{[round(m, 3) for m in win_ms]}; mean {np.mean(win_ms):.3f} ms, "
        f"{timed_events / (sum(win_ms) / 1e3):.4g} events/s")
    log(f"[main] longest lane's steps per window after warm-up: {lane_max} "
        f"(budget {exp.kernel_chunk_steps * exp.kernel_max_chunks}); warp "
        f"step-slot efficiency {[round(e, 4) for e in warp_eff]}")
    if launches != MAIN_WINDOWS:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{MAIN_WINDOWS} windows")
    means = np.stack([r.mean for r in recs])
    if len(recs) != MAIN_WINDOWS or not all(
            np.isfinite(v).all() for r in recs
            for v in (r.mean, r.var, r.ci90)):
        raise AssertionError("records missing or not finite")

    # checked run: same seed, observables pulled every window
    res2 = simulate(exp.with_(record_trajectories=True), device=device)
    means2 = np.stack([r.mean for r in res2.records])
    if means.tobytes() != means2.tobytes():
        raise AssertionError("a second run gave different record means")
    traj = res2.trajectories()  # (I, T, n_obs)
    ref = traj.astype(np.float64).mean(axis=0)
    rel = float(np.max(np.abs(means2 - ref) / np.maximum(np.abs(ref), 1)))
    log(f"[main] record means vs float64 recomputation: max rel err "
        f"{rel:.3g} (tolerance {MAIN_RTOL:g}); rerun bitwise equal")
    if not rel <= MAIN_RTOL:
        raise AssertionError("record means disagree with float64 sums")

    # one full-width launch of a main-path window: kernel vs plain twin
    eng = build_engine(exp, device=device)
    eng.run_window()
    pool = eng._pool
    idx, coef, delta, _ = eng._tensors_base
    args = (pool.x, pool.t, pool.dead.to(torch.int32), pool.key, pool.ctr,
            pool.ctr_hi, idx, coef, delta, eng._rates_dev)
    horizon = float(np.float32(eng.grid[1]))
    n_steps = exp.kernel_chunk_steps * exp.kernel_max_chunks

    def launch():
        return ssa_window_call(*args, horizon, n_steps=n_steps)

    launch()
    k_ms = cuda_ms(launch, reps=5)
    out = launch()
    p_out = [None]

    def plain():
        p_out[0] = ssa_window_plain(*args, horizon, n_steps=n_steps)

    p_ms = cuda_ms(plain)
    n_diff, err = bitwise_diff(out, p_out[0])
    active = int(((out[4].long() - pool.ctr.long()) & 0xFFFFFFFF).sum())
    fired = int(out[3].sum())
    f_step, f_fired, i_step = ops_per_step(eng.system)
    b, s = pool.x.shape
    r = eng.system.n_reactions
    n_bytes = b * (2 * 4 * s + 2 * 4 + 2 * 4 + 8 + 2 * 4 + 2 * 4 + 4) + \
        r * (4 * 4 * 2 + 4 * s + 4)
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_f = (active * f_step + fired * f_fired) / PEAK_F32_OPS * 1e3
    t_i = active * i_step / PEAK_I32_OPS * 1e3
    bound = max(t_bytes, t_f, t_i)
    log(f"[main] one window at full width: kernel {k_ms:.3f} ms, plain "
        f"twin {p_ms:.1f} ms, {n_diff} differing elements; {active} active "
        f"lane steps, {fired} events; bound {bound:.4f} ms (bytes "
        f"{t_bytes:.4f}, f32 ops {t_f:.4f}, int32 ops {t_i:.4f} ms); the "
        f"same window took {win_ms[0]:.3f} ms end to end, kernel share "
        f"{k_ms / win_ms[0]:.4f}")
    if n_diff:
        raise AssertionError("full-width kernel and plain twin disagree")
    return dict(launches=launches, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                bound_by="bytes" if t_bytes >= max(t_f, t_i)
                else "operations", err=err)


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
    main_nums = phase_main(device)
    report = {"kernels": [{
        "name": "ssa_window",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssa_window.cu",
        "replaces": "src/repro/kernels/ssa_step.py:64",
        "launches": main_nums["launches"],
        "max_abs_err": max(worst, main_nums["err"]),
        "ms": main_nums["ms"],
        "plain_ms": main_nums["plain_ms"],
        "bound_ms": main_nums["bound_ms"],
        "bound_by": main_nums["bound_by"],
        "library_ms": None,
    }]}
    log(f"[done] all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
