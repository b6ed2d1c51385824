"""The program's own spans on a `--trace 1` run's trace: their intervals,
a span's self time, and the card's idle time split by the spans the
host was in.

The program names its spans `repro_torch.<layer>` (the port's
`core/trace.py`); a program that records none leaves every reader of
this file with nothing to read (None). All times are in ns on the
profiler's clock.
"""
from __future__ import annotations

import numpy as np

from portbench.harness.trace import Trace

PREFIX = "repro_torch."
SETUP = "repro_torch.setup"
WINDOW = "repro_torch.window"
FOLD = "repro_torch.window.fold"
PULL = "repro_torch.window.pull"


def spans_where(tr: Trace, keep) -> np.ndarray:
    """(k, 2) of the host spans whose name passes `keep`, by start."""
    out = np.asarray([(a, b) for n, a, b in zip(
        tr.host_name, tr.host_start, tr.host_end) if keep(n)],
        np.int64).reshape(-1, 2)
    return out[np.argsort(out[:, 0], kind="stable")]


def union(iv: np.ndarray) -> np.ndarray:
    """Intervals (k, 2) merged into sorted disjoint ones."""
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = []
    for a, b in iv.tolist():
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out, np.int64).reshape(-1, 2)


def covered(u: np.ndarray, x) -> np.ndarray:
    """ns of the disjoint sorted intervals `u` that lie before each x."""
    x = np.asarray(x, np.int64)
    if not len(u):
        return np.zeros(x.shape, np.int64)
    length = u[:, 1] - u[:, 0]
    before = np.concatenate([[0], np.cumsum(length)])
    k = np.searchsorted(u[:, 0], x, side="right")  # intervals begun by x
    last = np.maximum(k - 1, 0)
    part = np.where(k > 0, np.clip(x - u[last, 0], 0, length[last]), 0)
    return before[last] + part


def overlap_ns(a: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Per interval of `a`, the ns of it that the disjoint sorted
    intervals `u` cover."""
    return covered(u, a[:, 1]) - covered(u, a[:, 0])


def self_ns(tr: Trace, parent: str, children) -> np.ndarray:
    """Per span called `parent`: its ns less those its spans called one
    of `children` cover."""
    p = tr.spans(parent)
    kids = union(spans_where(tr, lambda n: n in children))
    return (p[:, 1] - p[:, 0]) - overlap_ns(p, kids)


def idle(tr: Trace, device=None) -> np.ndarray:
    """The window's stretches with nothing on the card (the check's
    copies count as busy, as in `Trace.busy`), disjoint and sorted."""
    b = tr.busy(device)
    lo, hi = tr.window
    edges = np.concatenate([[lo], b.ravel(), [hi]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def idle_parts_pct(tr: Trace) -> dict:
    """The card's idle time as % of the window, in three parts that sum
    to `device_idle_pct`: under the program's set-up spans ("setup"),
    under its other spans (the window loop, supersteps, checkpoints:
    "windows"), and under none of them ("outside": the caller's code
    between calls). Averaged over the cards, as `Trace.busy_s` is."""
    setup = union(spans_where(
        tr, lambda n: n == SETUP or n.startswith(SETUP + ".")))
    program = union(spans_where(tr, lambda n: n.startswith(PREFIX)))
    parts = []
    for d in tr.devices() or [None]:
        gaps = idle(tr, d)
        total = int((gaps[:, 1] - gaps[:, 0]).sum())
        s = int(overlap_ns(setup, gaps).sum())
        p = int(overlap_ns(program, gaps).sum())
        parts.append((s, p - s, total - p))
    ns = np.mean(np.asarray(parts, np.float64), axis=0)
    win = tr.window_s * 1e9
    return dict(zip(("setup", "windows", "outside"), 100.0 * ns / win))


def readable(run) -> bool:
    """Whether the run has a trace with the program's spans in it."""
    return run.trace is not None and any(
        n.startswith(PREFIX) for n in run.trace.host_name)


def device_readable(run) -> bool:
    """Whether the run also has operations on the card (none on a CPU)."""
    return readable(run) and bool(run.trace.dev_name)
