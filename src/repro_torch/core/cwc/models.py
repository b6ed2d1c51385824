"""CWC model library (the paper's experimental systems); the port's own
copy of `repro/core/cwc/models.py`, with the same `MODELS` entries.

* `lotka_volterra(n)` — the n-species prey/predator chains of Fig. 4
  (n=2 is the classic model used in Fig. 7).
* `ecoli_gene_regulation()` — gene regulation with negative feedback in
  an E. coli cell compartment (the Fig. 1 experiment's model family).
* `membrane_transport()` — compartment demo: molecules crossing a cell
  membrane, exercising the CWC compartment fragment.
* `ring{8,80}` / `lattice8x8` — generated large structured models
  (`cwc.compile.cell_ring_model` / `cell_lattice_model`): a local
  gene-expression/cargo motif repeated over a ring or torus of coupled
  cells. Hundreds of species/reactions with motif-bounded dependency
  out-degree — the sparse engine's target class (DESIGN.md §3g).

`pentamer_system()` is not a `MODELS` entry but a flat ReactionSystem
with a reactant coefficient of 5, above the dense path's MAX_COEF: the
one system the port's tests and `chip_smoke.py` run on the sparse path
only.
"""
from __future__ import annotations

from repro_torch.core.cwc.compile import cell_lattice_model, cell_ring_model
from repro_torch.core.cwc.rules import CWCModel, Rule, TransportRule
from repro_torch.core.cwc.terms import TOP, comp, term
from repro_torch.core.reactions import ReactionSystem, make_system


def lotka_volterra(n_species: int = 2, k_reproduce: float = 1.0,
                   k_eat: float = 0.005, k_die: float = 0.6,
                   prey0: int = 1000, pred0: int = 1000) -> CWCModel:
    """n-species cyclic prey/predator chain (n=2: classic LV).

    Species s_i preys on s_{i-1}; s_0 reproduces; the last dies.
    """
    assert n_species >= 2
    names = [f"s{i}" for i in range(n_species)]
    rules = [Rule.make(TOP, {names[0]: 1}, {names[0]: 2}, k_reproduce,
                       "reproduce")]
    for i in range(1, n_species):
        rules.append(Rule.make(
            TOP, {names[i - 1]: 1, names[i]: 1}, {names[i]: 2},
            k_eat, f"eat{i}"))
    rules.append(Rule.make(TOP, {names[-1]: 1}, {}, k_die, "die"))

    init_atoms = {names[0]: prey0, names[-1]: pred0}
    for i in range(1, n_species - 1):
        init_atoms[names[i]] = 100

    return CWCModel(
        rules=tuple(rules),
        init_fn=lambda: term(init_atoms),
        observables=tuple((TOP, n) for n in names),
        name=f"lotka-volterra-{n_species}",
    )


def ecoli_gene_regulation(k_transcribe: float = 0.5,
                          k_translate: float = 0.12,
                          k_mrna_decay: float = 0.06,
                          k_prot_decay: float = 0.02,
                          k_bind: float = 0.0005,
                          k_unbind: float = 0.2) -> CWCModel:
    """Gene regulation with negative feedback inside an `ecoli` cell:

      gene        -> gene + mrna       (transcription)
      mrna        -> mrna + protein    (translation)
      mrna        -> ∅                 (decay)
      protein     -> ∅                 (decay)
      gene + protein <-> gene_blocked  (repression)
    """
    L = "ecoli"
    rules = (
        Rule.make(L, {"gene": 1}, {"gene": 1, "mrna": 1}, k_transcribe,
                  "transcribe"),
        Rule.make(L, {"mrna": 1}, {"mrna": 1, "protein": 1}, k_translate,
                  "translate"),
        Rule.make(L, {"mrna": 1}, {}, k_mrna_decay, "mrna-decay"),
        Rule.make(L, {"protein": 1}, {}, k_prot_decay, "protein-decay"),
        Rule.make(L, {"gene": 1, "protein": 1}, {"gene_blocked": 1}, k_bind,
                  "repress"),
        Rule.make(L, {"gene_blocked": 1}, {"gene": 1, "protein": 1},
                  k_unbind, "derepress"),
    )

    def init():
        return term(comps=[comp(L, wrap={"m": 1},
                                content=term({"gene": 10}))])

    return CWCModel(rules=rules, init_fn=init,
                    observables=((L, "mrna"), (L, "protein")),
                    name="ecoli-gene-regulation")


def membrane_transport(k_in: float = 0.1, k_out: float = 0.05,
                       k_react: float = 0.01, n0: int = 500) -> CWCModel:
    """Nutrient `a` diffuses into a cell, reacts to product `b`, which
    is exported. Exercises TransportRules across the membrane."""
    L = "cell"
    rules = (
        TransportRule(TOP, "a", L, "in", k_in, "uptake"),
        Rule.make(L, {"a": 2}, {"b": 1}, k_react, "dimerise"),
        TransportRule(TOP, "b", L, "out", k_out, "export"),
    )

    def init():
        return term({"a": n0}, comps=[comp(L, content=term({}))])

    return CWCModel(rules=rules, init_fn=init,
                    observables=((TOP, "a"), (L, "a"), (L, "b"), (TOP, "b")),
                    name="membrane-transport")


def pentamer_system() -> ReactionSystem:
    """A monomer fed and decaying, five of which pentamerise: the
    coefficient-5 reaction the dense path refuses and the sparse path
    runs (its comb unroll goes to the system's own max coefficient)."""
    return make_system(
        ["A", "P"],
        [({}, {"A": 1}, 30.0), ({"A": 1}, {}, 0.5),
         ({"A": 5}, {"P": 1}, 1e-4), ({"P": 1}, {}, 0.2)],
        {"A": 60}, names=["feed", "decay", "pentamerise", "p-decay"])


MODELS = {
    "lv2": lambda: lotka_volterra(2),
    "lv4": lambda: lotka_volterra(4),
    "lv8": lambda: lotka_volterra(8),
    "ecoli": ecoli_gene_regulation,
    "transport": membrane_transport,
    "ring8": lambda: cell_ring_model(8),       # S=32, R=56 (tests)
    "ring80": lambda: cell_ring_model(80),     # S=320, R=560 (bench)
    "lattice8x8": lambda: cell_lattice_model(8, 8),  # S=256, R=512
}
