"""The mean ms of a job's `simulate()` call, which runs no window: the
model's tables, the engine and the lanes' keys (the benchmark's span)."""


def read(run):
    jobs = run.window.jobs
    return 1e3 * sum(j.setup_s for j in jobs) / len(jobs) if jobs else None
