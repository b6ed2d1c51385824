"""The share of its roofline that `tau_window`'s launches reached."""
from portbench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "tau_window")
