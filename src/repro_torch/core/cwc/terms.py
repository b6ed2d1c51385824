"""CWC terms (paper §2.1); the port's own copy of
`repro/core/cwc/terms.py`.

A term is a multiset of simple terms; a simple term is an atom or a
compartment (wrap | content)^label. Multisets are collections.Counter
over atom names; compartments are explicit objects so nesting is
preserved. This symbolic representation feeds both the faithful
sequential simulator (reference.py) and the tensorising compiler
(compile.py).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Iterator, Optional

TOP = "⊤"  # the top-level compartment label


@dataclass
class Compartment:
    label: str
    wrap: Counter  # atoms on the membrane
    content: "Term"

    def copy(self) -> "Compartment":
        return Compartment(self.label, Counter(self.wrap), self.content.copy())


@dataclass
class Term:
    """Multiset of atoms + list of compartments."""

    atoms: Counter = field(default_factory=Counter)
    compartments: list = field(default_factory=list)

    def copy(self) -> "Term":
        return Term(Counter(self.atoms),
                    [c.copy() for c in self.compartments])

    def walk(self, path=()) -> Iterator[tuple[tuple, str, "Term"]]:
        """Yield (path, label, content) for every compartment context,
        including the top level."""
        label = TOP if not path else None
        yield path, label, self
        for i, comp in enumerate(self.compartments):
            yield from _walk_comp(comp, path + (i,))

    def total_atoms(self) -> int:
        return (sum(self.atoms.values())
                + sum(c.content.total_atoms() + sum(c.wrap.values())
                      for c in self.compartments))


def _walk_comp(comp: Compartment, path) -> Iterator:
    yield path, comp.label, comp.content
    for i, sub in enumerate(comp.content.compartments):
        yield from _walk_comp(sub, path + (i,))


def atoms(*names: str, **counts: int) -> Counter:
    c = Counter()
    for n in names:
        c[n] += 1
    for n, k in counts.items():
        c[n] += k
    return c


def term(atom_counts: Optional[dict] = None, comps: Optional[list] = None) -> Term:
    return Term(Counter(atom_counts or {}), comps or [])


def comp(label: str, wrap: Optional[dict] = None,
         content: Optional[Term] = None) -> Compartment:
    return Compartment(label, Counter(wrap or {}), content or Term())
