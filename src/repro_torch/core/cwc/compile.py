"""CWC → ReactionSystem compiler (the compile-time tree matching); the
port's own copy of `repro/core/cwc/compile.py`, producing the same
tables.

The paper's Match phase walks the subject tree per step (§2.3, the
non-SIMD part, Fig. 3). For static compartment topologies we hoist that
walk to compile time: every compartment instance in the initial term is
enumerated once; each (rule, matching compartment instance) pair
becomes one dense reaction. The run-time Match is then the propensity
matrix — fully vectorised (DESIGN.md §2/§6).
"""
from __future__ import annotations

from repro_torch.core.cwc.rules import CWCModel, Rule, TransportRule
from repro_torch.core.cwc.terms import TOP, comp, term
from repro_torch.core.reactions import ReactionSystem, make_system


def compile_model(model: CWCModel) -> tuple[ReactionSystem, dict]:
    """Returns (system, meta). meta maps species index -> (path, atom)
    and lists per-observable species indices."""
    t0 = model.initial_term()

    # 1. enumerate compartment contexts (path () = top level)
    contexts: list[tuple[tuple, str]] = []  # (path, label)
    content_by_path: dict = {}
    for path, label, content in t0.walk():
        if label is None:
            # nested compartment label — recover from the object
            node = t0
            for i in path[:-1]:
                node = node.compartments[i].content
            label = node.compartments[path[-1]].label
        contexts.append((path, label))
        content_by_path[path] = content

    # 2. alphabet per context: atoms in the initial content + any atom
    #    mentioned by a rule applicable to the context's label
    alphabet: dict = {}
    for path, label in contexts:
        names = set(content_by_path[path].atoms)
        for r in model.rules:
            if isinstance(r, Rule) and r.label == label:
                names |= {a for a, _ in r.lhs} | {a for a, _ in r.rhs}
            if isinstance(r, TransportRule):
                if r.label == label:
                    names.add(r.atom)
                if r.child_label == label:
                    names.add(r.atom)
        alphabet[path] = sorted(names)

    species = []
    sidx = {}
    for path, label in contexts:
        for a in alphabet[path]:
            sidx[(path, a)] = len(species)
            species.append(f"{_path_str(path, label)}/{a}")

    # 3. instantiate reactions
    reactions = []
    names = []
    for path, label in contexts:
        for r in model.rules:
            if isinstance(r, Rule) and r.label == label:
                lhs = {_species_name(path, label, a): c for a, c in r.lhs}
                rhs = {_species_name(path, label, a): c for a, c in r.rhs}
                reactions.append((lhs, rhs, r.k))
                names.append(f"{r.name}@{_path_str(path, label)}")
            elif isinstance(r, TransportRule) and r.label == label:
                # one reaction per child instance with the right label
                for i, compi in enumerate(content_by_path[path].compartments):
                    if compi.label != r.child_label:
                        continue
                    child_path = path + (i,)
                    parent_sp = _species_name(path, label, r.atom)
                    child_sp = _species_name(child_path, compi.label, r.atom)
                    if r.direction == "in":
                        lhs, rhs = {parent_sp: 1}, {child_sp: 1}
                    else:
                        lhs, rhs = {child_sp: 1}, {parent_sp: 1}
                    reactions.append((lhs, rhs, r.k))
                    names.append(
                        f"{r.name or 'transport'}@{_path_str(path, label)}"
                        f"->{i}")

    # 4. initial state
    x0 = {}
    for path, label in contexts:
        for a, c in content_by_path[path].atoms.items():
            x0[_species_name(path, label, a)] = c

    # reactions/x0 already use species-name keys; make_system maps them
    # onto the canonical species order
    sys = make_system(species, reactions, x0, names)

    obs_idx = {}
    for obs in model.observables:
        path_label, atom = obs
        for (path, label) in contexts:
            if _path_str(path, label) == path_label or label == path_label:
                key = f"{_path_str(path, label)}/{atom}"
                if key in species:
                    obs_idx.setdefault(f"{path_label}/{atom}", []).append(
                        species.index(key))
    meta = {"species": species, "observables": obs_idx}
    return sys, meta


# ---------------------------------------------------------------------
# Large structured model generators (the sparse engine's target class).
#
# Real compartmentalised models scale by REPEATING a motif over a
# topology — a ring of coupled cells, a tissue lattice — not by making
# one compartment's chemistry huge. Compiled through `compile_model`,
# n coupled cells become S ≈ 4n species and R ≈ 7n reactions whose
# dependency graph has out-degree bounded by the motif (≈ 5), NOT by n:
# firing a reaction in cell i touches only cell i's species and the
# shared carrier slot for cell i, so the sparse engine's per-event cost
# stays O(1) in the number of cells while the dense path pays O(R).


def cell_ring_model(n_cells: int, k_express: float = 4.0,
                    k_decay: float = 0.05, k_dim: float = 0.002,
                    k_unpack: float = 0.5, k_hop: float = 1.0,
                    k_export: float = 0.3, k_import: float = 0.8,
                    p0: int = 40) -> CWCModel:
    """A ring of `n_cells` coupled cells passing a cargo clockwise.

    Cell i (compartment label ``c{i}``) runs a local motif —

      g        -> g + p      (express)
      p        -> ∅          (decay)
      2 p      -> w{i}       (dimerise: packages cargo; coefficient 2)
      w{i}     -> 2 p        (unpack: received cargo releases payload)

    — and couples to its clockwise neighbour through the top level:
    ``w{i}`` is exported out of cell i, relabelled ``w{(i+1) % n}`` by a
    TOP hop rule, and imported into cell i+1. The cargo atom is named
    per DESTINATION slot, so each TOP species is consumed by exactly
    one import and one hop: the reaction dependency graph stays
    motif-bounded (max out-degree ~5) no matter how large the ring is.

    Sizes: S = 4n (g, p, w{i} per cell + n TOP carrier slots),
    R = 7n (4 local + hop + export + import per cell).
    """
    if n_cells < 2:
        raise ValueError(f"cell_ring_model needs >= 2 cells, "
                         f"got {n_cells}")
    rules = []
    for i in range(n_cells):
        lab, w, w_next = f"c{i}", f"w{i}", f"w{(i + 1) % n_cells}"
        rules += [
            Rule.make(lab, {"g": 1}, {"g": 1, "p": 1}, k_express,
                      f"express{i}"),
            Rule.make(lab, {"p": 1}, {}, k_decay, f"decay{i}"),
            Rule.make(lab, {"p": 2}, {w: 1}, k_dim, f"dimerise{i}"),
            Rule.make(lab, {w: 1}, {"p": 2}, k_unpack, f"unpack{i}"),
            # at TOP the cargo is relabelled for its destination cell
            Rule.make(TOP, {w: 1}, {w_next: 1}, k_hop, f"hop{i}"),
            TransportRule(TOP, w, lab, "out", k_export, f"export{i}"),
            TransportRule(TOP, w, lab, "in", k_import, f"import{i}"),
        ]

    def init(n=n_cells, p0=p0):
        return term(comps=[comp(f"c{i}", content=term({"g": 1, "p": p0}))
                           for i in range(n)])

    return CWCModel(
        rules=tuple(rules), init_fn=init,
        observables=(("c0", "p"), ("c0", "w0"), (TOP, "w0")),
        name=f"cell-ring-{n_cells}")


def cell_lattice_model(rows: int, cols: int, k_express: float = 4.0,
                       k_decay: float = 0.05, k_dim: float = 0.002,
                       k_unpack: float = 0.5, k_hop: float = 1.0,
                       k_export: float = 0.3, k_import: float = 0.8,
                       p0: int = 40) -> CWCModel:
    """`cell_ring_model`'s motif on a rows × cols torus: each cell's
    exported cargo hops east or south with equal rate, so every TOP
    carrier is consumed by TWO hop rules + one import (out-degree still
    motif-bounded). Sizes: S = 4·rows·cols, R = 8·rows·cols."""
    if rows < 1 or cols < 1 or rows * cols < 2:
        raise ValueError(f"cell_lattice_model needs >= 2 cells, "
                         f"got {rows}x{cols}")
    n = rows * cols

    def cid(r, c):
        return (r % rows) * cols + (c % cols)

    rules = []
    for r in range(rows):
        for c in range(cols):
            i = cid(r, c)
            lab, w = f"c{i}", f"w{i}"
            w_east, w_south = f"w{cid(r, c + 1)}", f"w{cid(r + 1, c)}"
            rules += [
                Rule.make(lab, {"g": 1}, {"g": 1, "p": 1}, k_express,
                          f"express{i}"),
                Rule.make(lab, {"p": 1}, {}, k_decay, f"decay{i}"),
                Rule.make(lab, {"p": 2}, {w: 1}, k_dim, f"dimerise{i}"),
                Rule.make(lab, {w: 1}, {"p": 2}, k_unpack, f"unpack{i}"),
                Rule.make(TOP, {w: 1}, {w_east: 1}, k_hop, f"hop-e{i}"),
                Rule.make(TOP, {w: 1}, {w_south: 1}, k_hop, f"hop-s{i}"),
                TransportRule(TOP, w, lab, "out", k_export, f"export{i}"),
                TransportRule(TOP, w, lab, "in", k_import, f"import{i}"),
            ]

    def init(n=n, p0=p0):
        return term(comps=[comp(f"c{i}", content=term({"g": 1, "p": p0}))
                           for i in range(n)])

    return CWCModel(
        rules=tuple(rules), init_fn=init,
        observables=(("c0", "p"), ("c0", "w0"), (TOP, "w0")),
        name=f"cell-lattice-{rows}x{cols}")


def _path_str(path, label) -> str:
    return (label if not path else
            f"{label}[{'.'.join(map(str, path))}]")


def _species_name(path, label, atom) -> str:
    return f"{_path_str(path, label)}/{atom}"
