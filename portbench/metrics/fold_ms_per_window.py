"""Device ms a window of every operation but the window kernels that
the jobs' windows launched (inside the `portbench.windows` spans): the
Welford fold and the packing of the record, and the pull. A job's
set-up on the card is left out."""
from portbench.harness.trace import WINDOWS_SPAN, base_name
from portbench.roofline import kernels


def read(run):
    tr, w = run.trace, run.window.windows
    if tr is None or not w or not tr.dev_name:
        return None
    window = {mod.KERNEL for mod in kernels().values()}
    inside = tr.launched_in(WINDOWS_SPAN)
    other = sum(int(b - a) for n, a, b, i in zip(
        tr.dev_name, tr.dev_start, tr.dev_end, inside)
        if i and base_name(n) not in window)
    return other / 1e6 / w
