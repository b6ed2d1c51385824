"""Accepted leaps as a share of the iterations that advanced a lane
(`Telemetry.leaps_per_window` over `steps_per_window`), over every
window of the run; None on an exact cell (no leaps are counted)."""


def read(run):
    steps = sum(sum(j.steps) for j in run.window.jobs)
    leaps = sum(sum(j.leaps) for j in run.window.jobs)
    if run.cell.method != "tau_leap" or not steps:
        return None
    return 100.0 * leaps / steps
