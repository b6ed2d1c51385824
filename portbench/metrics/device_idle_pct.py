"""The share of the traced window in which no kernel, copy or set ran
on the card."""


def read(run):
    tr = run.trace
    if tr is None or not tr.dev_name:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
