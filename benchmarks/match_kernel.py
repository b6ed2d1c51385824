"""Time the Match kernel (`kernels.propensity.propensity_call`) on the card.

Runs `chip_smoke.py`'s sparse main path (ring80 x 2^18 lanes, t_end 4 in
8 windows, exact, the sparse window kernel) to its end, then launches the
Match kernel on the final populations, with the shared (R,) rates and
with a seeded per-lane (B, R) sweep, after `--warmup` launches:

- `ms`: `--reps` launches, each timed alone with CUDA events (the
  wrapper's host time before the launch included);
- `batch_ms`: `--reps` launches back to back between two events, per
  launch (the host's time hidden while it runs ahead of the card);
- `device_ms`: the kernel's own time on the card, per launch, from
  `torch.profiler` over `--reps` launches (null if the profiler records
  no device time);
- `fill_ms`: one `fill_` of a tensor of the output's size, per launch
  over `--reps` back to back: the write rate a plain PyTorch kernel
  reaches on this card.

Every launch must give the bits of the plain twin `propensity_plain`.
Prints the card's name and power limit, then one JSON line per kind of
rates with every time, the route and the tile.

The kernels come from the `repro_torch` package under `--src` (default:
this checkout's `src/`), built there at first use, so two trees can be
compared in one run on one card, for example

    python3 benchmarks/match_kernel.py
    python3 benchmarks/match_kernel.py --src OTHER/src --label parent

Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODEL, LANES, T_END, N_WINDOWS, SEED = "ring80", 1 << 18, 4.0, 8, 11


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]


def back_to_back(fn, reps: int) -> float:
    """Milliseconds per call of `reps` calls of fn between two events."""
    import torch

    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiled_ms(fn, reps: int, name: str) -> float | None:
    """Device milliseconds per launch of the kernels whose name holds
    `name`, from torch.profiler over `reps` calls of fn; None if it
    records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if name in ev.key and us > 0:
            total += us
            count += ev.count
    return total / count / 1e3 if count else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="",
                    help="a name for this tree, copied into the output")
    a = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("match_kernel: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(a.src.resolve()))
    from repro_torch.api import Ensemble, Experiment, Schedule, build_engine
    from repro_torch.core.cwc.models import MODELS
    from repro_torch.kernels import build
    from repro_torch.kernels.ops import system_kernel_tensors
    from repro_torch.kernels.propensity import (
        propensity_call,
        propensity_plain,
    )

    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    card = card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    exp = Experiment(model=MODELS[MODEL](),
                     ensemble=Ensemble.make(replicas=LANES),
                     schedule=Schedule(t_end=T_END, n_windows=N_WINDOWS),
                     n_lanes=1024, sparse=True, use_kernel=True)
    eng = build_engine(exp, device=device)
    for _ in range(N_WINDOWS):
        eng.run_window()
    x = eng._pool.x
    system = eng.system
    idx, coef, _ = system_kernel_tensors(system, device=device)
    rng = np.random.default_rng(SEED)
    sweep = (system.rates[None] * rng.uniform(
        0.5, 1.5, (LANES, system.n_reactions))).astype(np.float32)
    for label, rates in (("(R,)", torch.as_tensor(system.rates,
                                                  device=device)),
                         ("(B,R)", torch.as_tensor(sweep, device=device))):
        plain = propensity_plain(x, idx, coef, rates)
        for _ in range(a.warmup):
            propensity_call(x, idx, coef, rates)
        ms = []
        for _ in range(a.reps):
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            out = propensity_call(x, idx, coef, rates)
            stop.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(stop))
            if not torch.equal(out.view(torch.int32),
                               plain.view(torch.int32)):
                raise AssertionError(f"match {label}: kernel and plain "
                                     f"twin disagree")
        batch_ms = back_to_back(
            lambda: propensity_call(x, idx, coef, rates), a.reps)
        fill_ms = back_to_back(lambda: out.fill_(1.0), a.reps)
        device_ms = profiled_ms(
            lambda: propensity_call(x, idx, coef, rates), a.reps,
            "propensity")
        srt = sorted(ms)
        print(json.dumps({
            "label": a.label, "src": str(a.src), "model": MODEL,
            "lanes": LANES, "rates": label,
            "route": getattr(propensity_call, "route", None),
            "tile": getattr(propensity_call, "tile", None), "ms": ms,
            "median_ms": srt[len(srt) // 2], "min_ms": srt[0],
            "max_ms": srt[-1], "batch_ms": batch_ms, "device_ms": device_ms,
            "fill_ms": fill_ms, "card": card, "build_s": round(build_s, 2),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
