"""The sparse exact window (`kernels/csrc/sparse_window.cu`): the
direct method with the propensities carried across events and only an
event's dependents recomputed."""
from portbench.roofline.counts import (
    F_DRAW,
    I_STEP,
    fired_ops,
    match_ops,
    pool_bytes,
    refold_ops,
    table_bytes,
)

KERNEL = "sparse_window_kernel"


def per_window(net):
    """work(lanes, steps, leaps) -> (bytes, float32 ops, int32 ops) of one
    window in which the lanes fired `steps` events. Each lane evaluates
    every reaction and sums a0 once on entry (R - 1 adds) and takes one
    more step, the one whose draw crosses the horizon; each event
    updates the populations and its dependents' propensities and
    refolds the running sums from the lowest changed row
    (`counts.refold_ops`)."""
    entry = net.n_reactions - 1 + match_ops(net)
    event = refold_ops(net) + fired_ops(net, 3)
    tables = table_bytes(net)

    def work(lanes: int, steps: int, leaps: int):
        active = steps + lanes
        return (pool_bytes(lanes, net.n_species) + tables,
                active * F_DRAW + lanes * entry + steps * event,
                active * I_STEP)

    return work
