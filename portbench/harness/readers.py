"""Helpers of the per-layer readers (`metrics/<name>.py`). A reader's
`read(run)` returns the metric's value, or None where the run holds
nothing to read it from; `run` has the cell, the measured window (its
jobs, their counters and spans) and, in a `--trace 1` run, the trace."""
from __future__ import annotations

import numpy as np

from portbench.roofline import kernels
from portbench.roofline.peaks import bound_s


def roofline(kernel: str):
    """The roofline module of a window kernel (`roofline/<kernel>.py`)."""
    return kernels()[kernel]


def window_works(run):
    """Each window's (lanes, steps, leaps) of every job in the window."""
    lanes = run.cell.replicas
    for job in run.window.jobs:
        for w in range(job.windows):
            yield lanes, job.steps[w], job.leaps[w] if job.leaps else 0


def roofline_pct(run, kernel: str):
    """The kernel's least time over the trace's windows (its roofline
    module's `work`, held against the card's peaks) as a share of the
    device time its launches took."""
    if run.trace is None:
        return None
    mod = roofline(kernel)
    took = run.trace.durations_s(mod.KERNEL)
    if not took.size:
        return None
    work = mod.per_window(run.cell.net)
    least = sum(bound_s(*work(*w)) for w in window_works(run))
    return 100.0 * least / float(took.sum())


def kernel_ms_p95(run, kernel: str):
    """The 95th percentile of the kernel's device ms a launch."""
    if run.trace is None:
        return None
    took = run.trace.durations_s(roofline(kernel).KERNEL)
    return float(np.percentile(took, 95) * 1e3) if took.size else None
