"""The rooflines' work counts on systems small enough to count by hand."""
import numpy as np

from portbench.reference.network import SLOTS, Network
from portbench.roofline import counts, peaks, sparse_window, ssa_window, tau


def network(reactions, n_species):
    """reactions: (reactant slots [(species, c)], delta {species: d}, k)."""
    r = len(reactions)
    idx = np.full((r, SLOTS), n_species)
    coef = np.zeros((r, SLOTS), np.int64)
    delta = np.zeros((r, n_species), np.float32)
    for j, (slots, d, _) in enumerate(reactions):
        for m, (i, c) in enumerate(slots):
            idx[j, m], coef[j, m] = i, c
        for i, v in d.items():
            delta[j, i] = v
    return Network(tuple(range(n_species)), idx, coef, delta,
                   np.array([k for *_, k in reactions], np.float32),
                   np.ones(n_species, np.float32), (), ())


# A -> B (1), 2B -> A (2), B -> 0 (3)
NET = network([([(0, 1)], {0: -1, 1: 1}, 1.0),
               ([(1, 2)], {0: 1, 1: -2}, 2.0),
               ([(1, 1)], {1: -1}, 3.0)], 2)


def test_counts_by_hand():
    assert counts.slot_ops([1, 0, 0, 0]) == 1
    assert counts.slot_ops([2, 1, 0, 0]) == 4 + 1
    assert counts.match_ops(NET) == 1 + 4 + 1
    # A -> B changes A and B: every reaction reads A or B
    assert counts.dependents(NET) == [[0, 1, 2], [0, 1, 2], [1, 2]]
    # least over j of extra + changed species + dependents' Match:
    # j = 2: 2 + 1 + (4 + 1)
    assert counts.fired_ops(NET, 2) == 8
    # the lowest dependent row of j = 2 is 1: rows 1 and 2 refold
    assert counts.refold_ops(NET) == 2
    assert counts.pool_bytes(10, 2) == 10 * (16 + 8 + 8 + 16 + 8 + 4)
    # slots (2 x 12 int32), rates 3, delta nonzeros 5 x 2, dep 8
    assert counts.table_bytes(NET) == 4 * (24 + 3 + 10 + 8)


def test_window_work_by_hand():
    lanes, steps = 10, 100
    b = counts.pool_bytes(lanes, 2) + counts.table_bytes(NET)
    active = steps + lanes
    assert ssa_window.per_window(NET)(lanes, steps, 0) == (
        b, active * (2 + counts.F_DRAW) + steps * 8 + lanes * 6,
        active * counts.I_STEP)
    assert sparse_window.per_window(NET)(lanes, steps, 0) == (
        b, active * counts.F_DRAW + lanes * 2 + steps * (2 + 9)
        + lanes * 6, active * counts.I_STEP)


def test_tau_work_by_hand():
    lanes, steps, leaps = 10, 100, 60
    # consumed: A (order 1, c 1), B (order 2, c 2: one g term); columns:
    # A changed by reactions 0 and 1, B by 0, 1 and 2
    cao = (5 * 2 + 0 + 11) + (5 * 3 + 4 + 11)
    leap = cao + 4 + 3 * (1 + counts.F_EXP + 1) + 2 * (2 * 5 + 2 * 2) + 2
    f32 = (steps * (2 * 2 + 6) + leaps * (leap + 6)
           + 40 * (counts.F_DRAW + 9) + lanes * 6)
    i32 = leaps * (2 * counts.I_BLOCK + 2) + 40 * counts.I_STEP
    b = counts.pool_bytes(lanes, 2) + counts.table_bytes(NET)
    assert tau.per_window(NET)(lanes, steps, leaps) == (b, f32, i32)


def test_bound_is_the_slowest_resource():
    assert peaks.bound_s(peaks.PEAK_BYTES_S, 0, 0) == 1.0
    assert peaks.bound_s(0, 2 * peaks.PEAK_F32_OPS, peaks.PEAK_I32_OPS) == 2.0
