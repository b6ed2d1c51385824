"""The dense exact window (`kernels/csrc/ssa_window.cu`): Gillespie's
direct method with every propensity and a0 evaluated each step."""
from portbench.roofline.counts import (
    F_DRAW,
    I_STEP,
    fired_ops,
    match_ops,
    pool_bytes,
    table_bytes,
)

KERNEL = "ssa_window_kernel"


def per_window(net):
    """work(lanes, steps, leaps) -> (bytes, float32 ops, int32 ops) of one
    window in which the pool's lanes fired `steps` events. Each lane
    takes one more step, the one whose draw crosses the horizon, and
    evaluates every reaction once on entry; each step sums a0 (R - 1
    adds) and draws; each event updates the populations and its
    dependents' propensities."""
    step = net.n_reactions - 1 + F_DRAW
    fired, match, tables = fired_ops(net, 2), match_ops(net), table_bytes(net)

    def work(lanes: int, steps: int, leaps: int):
        active = steps + lanes
        return (pool_bytes(lanes, net.n_species) + tables,
                active * step + steps * fired + lanes * match,
                active * I_STEP)

    return work
