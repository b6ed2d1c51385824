"""Operation and byte counts shared by the window kernels' rooflines,
from a reaction network's shape (`portbench.reference.network.Network`).
An FMA counts as one operation."""
from __future__ import annotations

import numpy as np

#: float32 operations of a direct-method step besides the Match and a0:
#: the log (11 FMAs and 11 other operations), the two uniforms (a
#: subtract and a clamp each), the Resolve (negate, max(a0, 1e-30),
#: divide, t + tau, two compares)
F_LOG, F_UNIFORMS, F_RESOLVE = 22, 4, 6
F_DRAW = F_LOG + F_UNIFORMS + F_RESOLVE
#: int32 operations of one counter block: threefry's 20 rounds of add,
#: rotate and xor (60), 2 key adds and 5 injections of 2 adds (12), the
#: uniforms' bit moves (4), the log's exponent and mantissa bits (4), the
#: 64-bit counter bump (2); the key schedule is fixed for a lane
I_STEP = 82
#: int32 operations of a leap's counter block: threefry (72), the counter
#: add and carry (2), the uniforms' bits (4)
I_BLOCK = 78
#: float32 operations of exp (2 clamps, floor, 2 more clamps, 8 FMAs,
#: the square, the add of 1, the scaling multiply)
F_EXP = 17


def slot_ops(coef_row) -> int:
    """float32 operations of one reaction's rate-times-factors product:
    a multiply for a slot of multiplicity 1; for c > 1, c - 1 subtracts,
    c - 1 multiplies, the division by c! and the multiply into the
    product."""
    return int(sum(1 if c == 1 else 2 * c for c in coef_row if c > 0))


def match_ops(net) -> int:
    """The Match of every reaction once."""
    return sum(slot_ops(row) for row in net.coef)


def dependents(net) -> list[list[int]]:
    """dep(j): the reactions with a reactant that reaction j changes."""
    r, s = net.n_reactions, net.n_species
    reads = np.zeros((r, s + 1), bool)  # column S takes the pads
    reads[np.arange(r)[:, None], net.idx] = net.coef > 0
    dep = (net.delta != 0).astype(np.int64) @ reads[:, :s].T.astype(
        np.int64) > 0
    return [list(np.nonzero(row)[0]) for row in dep]


def fired_ops(net, extra: int) -> int:
    """An event's Update, least over the reaction j that fires: `extra`
    operations (the threshold multiply and the scan's compare, and for a
    carried scan its add), an add per species j changes, and the Match
    of j's dependents."""
    nnz = (net.delta != 0).sum(axis=1)
    deps = dependents(net)
    return min(extra + int(nnz[j]) + sum(slot_ops(net.coef[r])
                                         for r in deps[j])
               for j in range(net.n_reactions))


def refold_ops(net) -> int:
    """The a0 sum after an event, least over j: the running sums from the
    lowest row j's dependents change to the last (the bits of a left to
    right sum fix that order)."""
    deps = dependents(net)
    return min(net.n_reactions - min(d) if d else 0 for d in deps)


def pool_bytes(lanes: int, s: int) -> int:
    """A window's pool read and written once: x (float32) in and out; t,
    dead and the 64-bit counter in and out; the key in; the steps out."""
    return lanes * (2 * 4 * s + 2 * 4 + 2 * 4 + 2 * 8 + 8 + 4)


def table_bytes(net) -> int:
    """The network's tables read once: the reactant slots (index and
    multiplicity, int32), the rates, the nonzeros of delta (index and
    value) and the dependency lists (int32)."""
    nnz = int((net.delta != 0).sum())
    n_dep = sum(len(d) for d in dependents(net))
    return 4 * (2 * net.idx.size + net.n_reactions + 2 * nnz + n_dep)
