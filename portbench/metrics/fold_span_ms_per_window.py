"""Device ms a window of the operations launched under the program's
`repro_torch.window.fold` spans: the observables, the blocked Welford
fold, its gathers and the packed row (the part of `fold_ms_per_window`
the fold launches)."""
from portbench.harness.spans import FOLD, device_readable


def read(run):
    tr, w = run.trace, run.window.windows
    if not w or not device_readable(run):
        return None
    inside = tr.launched_in(FOLD)
    return float((tr.dev_end - tr.dev_start)[inside].sum()) / 1e6 / w
