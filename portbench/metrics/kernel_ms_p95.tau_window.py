"""The 95th percentile of a `tau_window` launch's device ms."""
from portbench.harness.readers import kernel_ms_p95


def read(run):
    return kernel_ms_p95(run, "tau_window")
