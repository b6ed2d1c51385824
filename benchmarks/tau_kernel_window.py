"""Time the tau-leap window kernels at a main path's second window, on the card.

Builds `chip_smoke.py`'s tau main paths (dense: lv8 x 2^20 lanes; sparse:
ring80 x 2^18 lanes; t_end 4 in 8 windows, 1,024 lanes a chunk), runs
the first window (t 0 -> 0.5), then launches the window kernel on the
second window's state (t 0.5 -> 1.0) `--reps` times after one warm-up,
each launch timed alone with CUDA events. Every launch must give the
same bits as the first. Prints the card's name and power limit, then one
JSON line per path with every time.

The kernels come from the `repro_torch` package under `--src` (default:
this checkout's `src/`), built there at first use, so two trees can be
compared in one run on one card, for example

    python3 benchmarks/tau_kernel_window.py --path both
    python3 benchmarks/tau_kernel_window.py --path sparse --src OTHER/src

Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATHS = {  # path: (model, lanes, sparse)
    "dense": ("lv8", 1 << 20, False),
    "sparse": ("ring80", 1 << 18, True),
}
T_END, N_WINDOWS = 4.0, 8


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]


def same_bits(a, b) -> bool:
    import torch

    return all(torch.equal(x.view(torch.int32) if x.is_floating_point()
                           else x, y.view(torch.int32)
                           if y.is_floating_point() else y)
               for x, y in zip(a, b))


def time_path(path: str, reps: int, device) -> dict:
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

    model, lanes, sparse = PATHS[path]
    exp = Experiment(model=MODELS[model](),
                     ensemble=Ensemble.make(replicas=lanes),
                     schedule=Schedule(t_end=T_END, n_windows=N_WINDOWS),
                     n_lanes=1024, sparse=sparse, use_kernel=True,
                     method=Method.TAU_LEAP)
    eng = build_engine(exp, device=device)
    eng.run_window()
    pool, tb = eng._pool, eng._tau_tables
    args = (pool.x, pool.t, pool.dead.to(torch.int32),
            pool.no_leap.to(torch.int32), pool.key, pool.ctr,
            pool.ctr_hi, *tb[:6], eng._rates_dev, tb.gi, tb.rmask)
    horizon = float(np.float32(eng.grid[1]))
    call = (ssa_step.sparse_tau_window_call if sparse
            else ssa_step.tau_window_call)
    kw = dict(n_steps=exp.kernel_chunk_steps * exp.kernel_max_chunks,
              eps=exp.tau_eps, fallback=exp.tau_fallback)
    if sparse:
        kw["max_c"] = tb.max_c
    elif "dep_mask" in inspect.signature(call).parameters:
        # bound once per run on the main path (FusedDispatch.set_rates)
        kw["dep_mask"] = ssa_step.dense_dep_mask(*eng._tensors_base[:3])
    first = call(*args, horizon, **kw)
    ms = []
    for _ in range(reps):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        out = call(*args, horizon, **kw)
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
        if not same_bits(out, first):
            raise AssertionError(f"{path}: a rerun gave other bits")
    srt = sorted(ms)
    return {"path": path, "model": model, "lanes": lanes, "window": 2,
            "iterations": int(first[7].sum()), "leaps": int(first[4].sum()),
            "ms": ms, "median_ms": srt[len(srt) // 2], "min_ms": srt[0],
            "max_ms": srt[-1]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("dense", "sparse", "both"),
                    default="both")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="",
                    help="a name for this tree, copied into the output")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tau_kernel_window: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(a.src.resolve()))
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    card = card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    for path in (("dense", "sparse") if a.path == "both" else (a.path,)):
        res = time_path(path, a.reps, device)
        res.update(label=a.label, src=str(a.src), card=card,
                   build_s=round(build_s, 2))
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
