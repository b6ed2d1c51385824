"""CWC stochastic rewrite rules (paper §2.1–2.2); the port's own copy
of `repro/core/cwc/rules.py`.

Supported rule forms (the tensorisable fragment — DESIGN.md §6):

* `Rule(label, lhs, rhs, k)` — atom rewriting inside compartments of
  type `label`:  ℓ : a b X  -k->  c X   (X = rest of content, implicit).
* `TransportRule(label, atom, child_label, direction, k)` — an atom
  crosses the membrane of a child compartment with type `child_label`
  inside a compartment of type `label` ("in"), or leaves it ("out").
  One reaction is instantiated per (parent context, child instance).

Rules that create/destroy compartments fall outside this fragment and
are handled by the sequential reference simulator only (documented
restriction).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class Rule:
    label: str  # compartment type the rule applies in
    lhs: tuple  # sorted ((atom, coef), ...)
    rhs: tuple
    k: float
    name: str = ""

    @staticmethod
    def make(label: str, lhs: dict, rhs: dict, k: float, name: str = "") -> "Rule":
        return Rule(label, tuple(sorted(lhs.items())),
                    tuple(sorted(rhs.items())), float(k),
                    name or f"{label}:{lhs}->{rhs}")

    def lhs_counter(self) -> Counter:
        return Counter(dict(self.lhs))

    def rhs_counter(self) -> Counter:
        return Counter(dict(self.rhs))


@dataclass(frozen=True)
class TransportRule:
    label: str  # parent compartment type
    atom: str
    child_label: str
    direction: str  # "in" | "out"
    k: float
    name: str = ""

    def __post_init__(self):
        assert self.direction in ("in", "out")


@dataclass(frozen=True)
class CWCModel:
    """Initial term + rules + observables."""

    rules: tuple
    init_fn: object  # () -> Term (kept callable so instances are fresh)
    observables: tuple  # (compartment-path-label, atom) pairs to report
    name: str = "cwc-model"

    def initial_term(self):
        return self.init_fn()
