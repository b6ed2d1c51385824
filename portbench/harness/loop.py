"""The measured window's jobs.

A job is one `simulate()` call (its set-up: the model's tables, the
engine, the lanes' keys) followed by its windows, one `resume()` each,
whose records reach the benchmark's sink. How jobs are offered is the
mix's `loop` (`portbench/loops/<loop>.py`).
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import numpy as np

from portbench.harness.cell import Cell
from portbench.harness.trace import CHECK_SPAN, SETUP_SPAN, WINDOWS_SPAN
from portbench.roofline import kernels


class Clock:
    """The window's clock: the host's, with the harness's own pauses (the
    copies of a drawn job's lanes for the check, during which the card
    runs nothing of the program) taken out."""

    def __init__(self):
        self.paused = 0.0

    def now(self) -> float:
        return time.perf_counter() - self.paused

    @contextmanager
    def pause(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.paused += time.perf_counter() - t0


@dataclass
class Job:
    index: int
    seed: int
    submitted: float
    setup_s: float = 0.0
    arrivals: list = field(default_factory=list)
    records: list = field(default_factory=list)
    windows: int = 0
    host_syncs: int = 0
    steps: tuple = ()
    leaps: tuple = ()
    states: dict = field(default_factory=dict)  # window: lanes, kept


@dataclass
class Window:
    seconds: float
    jobs: list
    launches: int

    @property
    def windows(self) -> int:
        return sum(j.windows for j in self.jobs)

    def jobs_done(self, n_windows: int) -> float:
        """Jobs finished, the last one by the share of its windows."""
        return sum(j.windows for j in self.jobs) / n_windows

    def gaps_ms(self) -> np.ndarray:
        """Per record, ms since the job's previous record reached the sink
        (the first record: since the job was submitted)."""
        out = []
        for j in self.jobs:
            prev = j.submitted
            for t in j.arrivals:
                out.append((t - prev) * 1e3)
                prev = t
        return np.asarray(out)


def launches() -> int:
    """Launches so far of the window kernels' wrappers
    (`kernels.ssa_step.<kernel>_call.launches`)."""
    from repro_torch.kernels import ssa_step

    calls = (getattr(ssa_step, f"{k}_call", None) for k in kernels())
    return sum(c.launches for c in calls if hasattr(c, "launches"))


def run_job(cell: Cell, seed: int, index: int, device, clock: Clock,
            deadline=None, keep=False, span=None, per_call=1) -> Job:
    """One job, timed by `clock`, `per_call` windows a `resume()`; with
    a deadline, stop after the call in which it passes. keep: hold the
    lanes' populations after each call (a copy to the host for the
    check, off the clock), by the index of the last window done."""
    from repro_torch.api import simulate

    span = span or (lambda name: nullcontext())
    job = Job(index, seed, clock.now())

    def sink(rec):
        job.arrivals.append(clock.now())
        job.records.append(rec)

    exp = cell.experiment(seed, sinks=[sink])
    with span(SETUP_SPAN):
        res = simulate(exp, device=device, max_windows=0)
    job.setup_s = clock.now() - job.submitted
    while not res.completed:
        with span(WINDOWS_SPAN):
            res.resume(max_windows=per_call)
        if keep:
            with clock.pause(), span(CHECK_SPAN):
                job.states[res.windows_run - 1] = res.final_state()
        if deadline is not None and clock.now() >= deadline:
            break
    tel = res.telemetry
    job.windows = res.windows_run
    job.host_syncs = tel.host_syncs
    job.steps, job.leaps = tel.steps_per_window, tel.leaps_per_window
    return job
