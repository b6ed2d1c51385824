"""The mean ms of a job's set-up inside the program: its
`repro_torch.setup` span, from before `build_engine` through the sinks'
attach (the part of `job_setup_ms` the program spends)."""
from portbench.harness.spans import SETUP, readable


def read(run):
    if not readable(run):
        return None
    s = run.trace.spans(SETUP)
    return float((s[:, 1] - s[:, 0]).mean()) / 1e6 if len(s) else None
