"""A sample of one job's lanes, followed from the start through every
window."""
from __future__ import annotations

import numpy as np

from portbench.reference import ssa, tau
from portbench.reference.rng import lane_keys

F32 = np.float32


def grid(t_end: float, n_windows: int) -> np.ndarray:
    """Each window's horizon, as float32."""
    return np.linspace(t_end / n_windows, t_end, n_windows).astype(F32)


def bf16(v):
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    b = np.asarray(v, F32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return b.view(F32)


def follow(net, job: dict, lanes, windows: int, rnd=None) -> dict:
    """The sampled `lanes` (indices into the job's ensemble) through its
    first `windows` windows. job: seed, t_end, n_windows, method, for tau
    eps and fallback, and `budget`, the iterations a lane may take in a
    window (the program refuses a window that needs more). rnd: a
    rounding of the populations and propensities wherever they are made
    (the control; the clock stays float32, since a bfloat16 clock stops
    advancing once t is some hundred times a step). Returns the lanes'
    x, t, dead, ctr, steps and leaps, `xs`: x after each window, and
    `truncated`: the lanes that ran out of budget in some window."""
    b = len(lanes)
    st = dict(x=np.tile(net.x0, (b, 1)), t=np.zeros(b, F32),
              dead=np.zeros(b, bool), key=lane_keys(job["seed"], lanes),
              ctr=np.zeros(b, np.uint64), steps=np.zeros(b, np.int64),
              leaps=np.zeros(b, np.int64), truncated=np.zeros(b, bool),
              xs=[])
    ts = tau.TauSystem(net) if job["method"] == "tau_leap" else None
    for h in grid(job["t_end"], job["n_windows"])[:windows]:
        for _ in range(job["budget"]):
            if not ((st["t"] < h) & ~st["dead"]).any():
                break
            if ts is None:
                ssa.step(net, st, h, rnd)
            else:
                tau.step(net, ts, st, h, job["tau_eps"], job["tau_fallback"],
                         rnd)
        st["truncated"] |= (st["t"] < h) & ~st["dead"]
        st["xs"].append(st["x"].copy())
    return st
