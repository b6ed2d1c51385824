"""The share of the traced window with nothing on the card while the
host was in the program's window loop (`repro_torch.window`, and any
other `repro_torch.` span outside the set-up: the supersteps'
`repro_torch.block.*`, checkpoints). The three `device_idle_pct.*`
parts sum to `device_idle_pct`."""
from portbench.harness.spans import device_readable, idle_parts_pct


def read(run):
    return idle_parts_pct(run.trace)["windows"] if device_readable(run) \
        else None
