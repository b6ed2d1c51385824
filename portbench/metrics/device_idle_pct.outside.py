"""The share of the traced window with nothing on the card while the
host was in no `repro_torch.` span: the caller's code between calls
into the program. The three `device_idle_pct.*` parts sum to
`device_idle_pct`."""
from portbench.harness.spans import device_readable, idle_parts_pct


def read(run):
    return idle_parts_pct(run.trace)["outside"] if device_readable(run) \
        else None
