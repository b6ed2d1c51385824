"""Faithful sequential CWC simulator — the paper's Fig. 3 pseudo-code;
the port's own copy of `repro/core/cwc/reference.py`.

This is the reproduction of the ORIGINAL tool (§2.3): Match walks the
nested term recursively building a weighted matchset (binomial
combination counting); Resolve draws (tau, mu) per Gillespie; Update
rewrites the matched compartment in place. Pure Python + numpy RNG —
deliberately unvectorised; it is both the fidelity baseline (fig-4
style measurements) and the oracle for the tensorised engine. It runs
on the host, like the tool it reproduces, and draws from numpy's
`default_rng`: the same model, grid and seed give the reference's
trajectory bit for bit (rule order and `Counter` iteration order are
the reference's, so `rng.choice` picks the same reaction).
"""
from __future__ import annotations

import math
from collections import Counter

import numpy as np

from repro_torch.core.cwc.rules import CWCModel, Rule, TransportRule
from repro_torch.core.cwc.terms import TOP, Term


class Match:
    __slots__ = ("rule", "path", "rate", "child_index")

    def __init__(self, rule, path, rate, child_index=None):
        self.rule = rule
        self.path = path
        self.rate = rate
        self.child_index = child_index


def _content_at(term: Term, path) -> Term:
    node = term
    for i in path:
        node = node.compartments[i].content
    return node


def _label_at(term: Term, path) -> str:
    if not path:
        return TOP
    node = term
    for i in path[:-1]:
        node = node.compartments[i].content
    return node.compartments[path[-1]].label


def match_populations(lhs: Counter, content: Counter) -> float:
    """Paper Fig. 3 Match_Populations: product of binomials."""
    count = 1.0
    for atom, k in lhs.items():
        n = content.get(atom, 0)
        if n < k:
            return 0.0
        count *= math.comb(n, k)
    return count


def build_matchset(term: Term, rules) -> list:
    """Paper Fig. 3 Match: recursive walk over the subject tree."""
    matchset = []

    def visit(path):
        content = _content_at(term, path)
        label = _label_at(term, path)
        for r in rules:
            if isinstance(r, Rule) and r.label == label:
                cnt = match_populations(r.lhs_counter(), content.atoms)
                if cnt > 0:
                    matchset.append(Match(r, path, cnt * r.k))
            elif isinstance(r, TransportRule) and r.label == label:
                for i, comp in enumerate(content.compartments):
                    if comp.label != r.child_label:
                        continue
                    if r.direction == "in":
                        n = content.atoms.get(r.atom, 0)
                    else:
                        n = comp.content.atoms.get(r.atom, 0)
                    if n > 0:
                        matchset.append(Match(r, path, n * r.k, i))
        for i in range(len(content.compartments)):
            visit(path + (i,))  # recursive step [non-SIMD in the paper]

    visit(())
    return matchset


def apply_match(term: Term, m: Match) -> None:
    """Paper Fig. 3 Update (in place)."""
    content = _content_at(term, m.path)
    if isinstance(m.rule, Rule):
        for a, c in m.rule.lhs:
            content.atoms[a] -= c
            if content.atoms[a] <= 0:
                del content.atoms[a]
        for a, c in m.rule.rhs:
            content.atoms[a] += c
    else:  # transport
        child = content.compartments[m.child_index].content
        src, dst = ((content, child) if m.rule.direction == "in"
                    else (child, content))
        src.atoms[m.rule.atom] -= 1
        if src.atoms[m.rule.atom] <= 0:
            del src.atoms[m.rule.atom]
        dst.atoms[m.rule.atom] += 1


def simulation_step(term: Term, rules, t: float, rng) -> tuple[float, bool]:
    """One Match/Resolve/Update step. Returns (new_t, alive)."""
    matchset = build_matchset(term, rules)
    if not matchset:
        return t, False
    rates = np.array([m.rate for m in matchset])
    r_total = rates.sum()
    tau = rng.exponential(1.0 / r_total)
    mu = rng.choice(len(matchset), p=rates / r_total)
    apply_match(term, matchset[mu])
    return t + tau, True


def simulate(model: CWCModel, t_grid, seed: int = 0,
             observe=None) -> np.ndarray:
    """Run one trajectory, sampling observables on t_grid.

    Returns (len(t_grid), n_observables). observe(term) -> tuple
    defaults to the model's (label, atom) observables summed over
    matching compartments.
    """
    rng = np.random.default_rng(seed)
    term = model.initial_term()
    rules = model.rules
    if observe is None:
        def observe(term):
            out = []
            for label, atom in model.observables:
                tot = 0
                for path, lab, content in term.walk():
                    eff = lab if lab is not None else _label_at(term, path)
                    if eff == label:
                        tot += content.atoms.get(atom, 0)
                out.append(tot)
            return out

    t = 0.0
    alive = True
    samples = []
    # peek-ahead stepping: freeze state when the next event crosses a grid
    # point (memoryless redraw afterwards, as in the tensor engine)
    for t_target in t_grid:
        while alive and t < t_target:
            matchset = build_matchset(term, rules)
            if not matchset:
                alive = False
                break
            rates = np.array([m.rate for m in matchset])
            r_total = rates.sum()
            tau = rng.exponential(1.0 / r_total)
            if t + tau > t_target:
                t = t_target
                break
            mu = rng.choice(len(matchset), p=rates / r_total)
            apply_match(term, matchset[mu])
            t += tau
        samples.append(observe(term))
    return np.asarray(samples, np.float64)


def matchset_rates(model: CWCModel, term: Term) -> dict:
    """name -> rate for the current term (oracle for compiled propensities)."""
    out = {}
    for m in build_matchset(term, model.rules):
        label = _label_at(term, m.path)
        key = (getattr(m.rule, "name", "") or str(m.rule), m.path,
               m.child_index)
        out[key] = out.get(key, 0.0) + m.rate
    return out
