"""The fused window: one kernel call per sim-time window.

Port of `repro/kernels/ops.py`'s dense exact path (`window_chunk_loop`,
`_chunk_while`, `FusedWindowOut`, `FusedWindowTruncated`). The
reference runs back-to-back launches of `chunk_steps` events in a
device-side while loop until no lane is live or `max_chunks` launches
have run. Here the kernel itself loops each lane until it is no longer
live or has spent the whole budget `chunk_steps * max_chunks`, so a
window is ONE launch. A finished lane's steps are exact no-ops in the
reference, so every lane ends with the bits the chunked loop gives, and
the reference's chunk count is recovered from the draw counters: the
loop ran min(max_chunks, ceil(max_lane(ctr_after - ctr_before) /
chunk_steps)) times.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.gillespie import LaneState
from repro_torch.core.stream import MASK32, to_words
from repro_torch.kernels.ssa_step import ssa_window_call

DEFAULT_CHUNK_STEPS = 256
DEFAULT_MAX_CHUNKS = 64


class FusedWindowTruncated(RuntimeError):
    """A fused window hit its event budget with live lanes still below
    the horizon — the result would silently be a partial window. Raise
    `kernel_max_chunks` / `kernel_chunk_steps` or shrink the window."""


class FusedWindowOut(NamedTuple):
    """fused-window result + single-launch telemetry.

    n_chunks: int64 0-dim tensor (device) — the reference's chunk-loop
    iteration count for this window.
    truncated: bool 0-dim tensor (device) — True iff the budget ran out
    with live lanes still below the horizon (the engine raises
    FusedWindowTruncated).
    """

    state: LaneState
    n_chunks: torch.Tensor
    truncated: torch.Tensor


def window_chunk_loop(pool: LaneState, tensors, horizon,
                      chunk_steps: int = DEFAULT_CHUNK_STEPS,
                      max_chunks: int = DEFAULT_MAX_CHUNKS
                      ) -> FusedWindowOut:
    """Advance every lane of `pool` to `horizon` through one
    `ssa_window_call` with the whole window's event budget.

    tensors: (idx, coef, delta, rates) as `gillespie.system_tensors`
    gives them. horizon: a float (rounded to float32).
    """
    idx, coef, delta, rates = tensors
    h = np.float32(horizon)
    x, t, dead, steps_d, ctr, ctr_hi = ssa_window_call(
        pool.x, pool.t, pool.dead.to(torch.int32), pool.key, pool.ctr,
        pool.ctr_hi, idx, coef, delta, rates, h,
        n_steps=chunk_steps * max_chunks)
    used = (to_words(ctr) - to_words(pool.ctr)) & MASK32  # active steps
    n_chunks = torch.clamp_max(
        (used.max() + chunk_steps - 1) // chunk_steps, max_chunks)
    truncated = ((t < float(h)) & (dead == 0)).any()
    t = torch.where(dead > 0, torch.clamp_min(t, float(h)), t)
    state = LaneState(x=x, t=t, key=pool.key, ctr=ctr, ctr_hi=ctr_hi,
                      steps=pool.steps + steps_d, leaps=pool.leaps,
                      dead=dead > 0, no_leap=pool.no_leap)
    return FusedWindowOut(state=state, n_chunks=n_chunks,
                          truncated=truncated)
