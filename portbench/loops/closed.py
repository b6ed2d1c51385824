"""A closed loop: each client submits its next job when its last one
has ended, until the window's seconds have passed on the window's clock
(the host's, less the check's copies); the job then running counts by
the share of its windows that are done. Each `resume()` runs the mix's
`windows_per_call` windows (1 by default). `simulate()` and `resume()`
block the calling thread, so one process drives one client."""
from __future__ import annotations

from portbench.harness.cell import job_seed
from portbench.harness.loop import Clock, Window, launches, run_job


def drive(cell, seed: int, seconds: float, device, keep=(),
          span=None) -> Window:
    """Jobs back to back for `seconds`; the per-window states of the job
    indices in `keep` are held for the check."""
    if cell.mix["clients"] != 1:
        raise SystemExit(f"mix {cell.workload['traffic']!r}: a closed loop "
                         "in one process drives one client")
    n0 = launches()
    jobs = []
    clock = Clock()
    t0 = clock.now()
    deadline = t0 + seconds
    while clock.now() < deadline:
        i = len(jobs)
        jobs.append(run_job(cell, job_seed(seed, i), i, device, clock,
                            deadline, keep=i in keep, span=span,
                            per_call=cell.mix.get("windows_per_call", 1)))
    return Window(clock.now() - t0, jobs, launches() - n0)
