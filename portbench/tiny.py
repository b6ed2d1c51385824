"""Cut sizes at which a cell's run goes through the CPU in a second or
so (the port's plain twins stand in for its kernels there), and such a
run; the tests' only."""
import time

from portbench.harness.bench import run_cell
from portbench.harness.cell import merged

TINY = {"experiment": {"ensemble": {"replicas": 32}, "n_lanes": 32,
                       "schedule": {"t_end": 0.05, "n_windows": 2}},
        "check": {"lanes": 8, "jobs": 1, "pool": 1, "record_n": 32}}
#: the sparse kernels' path at the tiny sizes
SPARSE = {"experiment": {"sparse": True}}


def sizes(**more) -> dict:
    """The tiny override, with further blocks merged over it."""
    return merged(TINY, more)


SEED = 2 ** 31 + 4242
SECONDS = 1.5


def run(workload="lv8-exact", traced=False, control=False, seconds=SECONDS,
        override=None):
    """A run of the cell at its cut sizes on the CPU (override: further
    configuration blocks); returns the result's line and the details."""
    return run_cell(workload, SEED, seconds, traced, "cpu",
                    time.perf_counter(), override=merged(TINY, override or {}),
                    control=control)
