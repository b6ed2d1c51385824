"""The mean ms of the host's own time in a window on the per-window
path: a `repro_torch.window` span less its `repro_torch.window.pull`
spans, the waits for the card."""
from portbench.harness.spans import PULL, WINDOW, readable, self_ns


def read(run):
    if not readable(run):
        return None
    own = self_ns(run.trace, WINDOW, (PULL,))
    return float(own.mean()) / 1e6 if own.size else None
