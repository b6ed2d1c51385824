"""Blocking device-to-host waits a window (`Telemetry.host_syncs`)."""


def read(run):
    w = run.window.windows
    return sum(j.host_syncs for j in run.window.jobs) / w if w else None
