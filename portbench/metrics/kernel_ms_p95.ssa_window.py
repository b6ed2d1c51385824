"""The 95th percentile of a `ssa_window` launch's device ms."""
from portbench.harness.readers import kernel_ms_p95


def read(run):
    return kernel_ms_p95(run, "ssa_window")
