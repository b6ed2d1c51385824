"""Tensorised reaction systems (port of `repro/core/reactions.py`).

A `ReactionSystem` is the compile-time residue of a CWC model: every
(rewrite rule × compartment instance) pair becomes one reaction over a
flat species vector. The tables are numpy arrays, identical to the
reference's; the run-time math (`comb_factors`, `propensities`) is
torch, in the reference's operation order, so its bits match.
`sparse_tables` derives the dependency graph and sparse stoichiometry
of the sparse exact path (`sparse=True`).

Propensities follow the paper's combination counting: for a reactant
with multiplicity c and population n the factor is C(n, c), times the
kinetic constant — rates first, then one factor per reactant slot.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from math import comb
from typing import Optional, Sequence

import numpy as np
import torch

MAX_REACTANTS = 4  # max distinct species on a rule LHS
# the dense path unrolls C(n, c) to c <= MAX_COEF and refuses larger
# multiplicities (`require_dense_capable`); the sparse path unrolls to
# the system's own `max_coef` and takes any multiplicity
MAX_COEF = 4


@dataclass(frozen=True)
class ReactionSystem:
    """S species, R reactions.

    reactant_idx:  (R, MAX_REACTANTS) int32 — species index, S = padding
    reactant_coef: (R, MAX_REACTANTS) int32 — multiplicity, 0 = padding
    delta:         (R, S) int32 — product-minus-reactant stoichiometry
    rates:         (R,) float32 — kinetic constants
    x0:            (S,) float32 initial state
    species_names / reaction_names: labels for reporting
    """

    reactant_idx: np.ndarray
    reactant_coef: np.ndarray
    delta: np.ndarray
    rates: np.ndarray
    x0: np.ndarray
    species_names: tuple[str, ...]
    reaction_names: tuple[str, ...]

    @property
    def max_coef(self) -> int:
        c = np.asarray(self.reactant_coef)
        return int(c.max()) if c.size else 0

    @property
    def n_species(self) -> int:
        return self.delta.shape[1]

    @property
    def n_reactions(self) -> int:
        return self.delta.shape[0]

    def with_rates(self, rates) -> "ReactionSystem":
        return dataclasses.replace(self, rates=np.asarray(rates, np.float32))

    def validate(self) -> None:
        r, s = self.n_reactions, self.n_species
        shapes = {"reactant_idx": (self.reactant_idx, (r, MAX_REACTANTS)),
                  "reactant_coef": (self.reactant_coef, (r, MAX_REACTANTS)),
                  "rates": (self.rates, (r,)), "x0": (self.x0, (s,))}
        for name, (arr, shape) in shapes.items():
            if arr.shape != shape:
                raise ValueError(f"ReactionSystem.{name} has shape "
                                 f"{arr.shape}, expected {shape}")
        if (self.reactant_idx > s).any():
            raise ValueError("reactant index out of range")
        lhs = np.zeros((r, s), np.int64)
        for j in range(r):
            for i, c in zip(self.reactant_idx[j], self.reactant_coef[j]):
                if c > 0:
                    lhs[j, i] += c
        if ((lhs + self.delta) < 0).any():
            raise ValueError("products went negative")


def make_system(species: Sequence[str],
                reactions: Sequence[tuple[dict, dict, float]],
                x0: dict,
                names: Optional[Sequence[str]] = None) -> ReactionSystem:
    """reactions: list of (reactants {name: coef}, products {name: coef}, k)."""
    sidx = {s: i for i, s in enumerate(species)}
    r = len(reactions)
    s = len(species)
    idx = np.full((r, MAX_REACTANTS), s, np.int32)
    coef = np.zeros((r, MAX_REACTANTS), np.int32)
    delta = np.zeros((r, s), np.int32)
    rates = np.zeros((r,), np.float32)
    for j, (lhs, rhs, k) in enumerate(reactions):
        if len(lhs) > MAX_REACTANTS:
            raise ValueError(f"rule {j} has too many reactants")
        for m, (name, c) in enumerate(sorted(lhs.items())):
            idx[j, m] = sidx[name]
            coef[j, m] = c
            delta[j, sidx[name]] -= c
        for name, c in rhs.items():
            delta[j, sidx[name]] += c
        rates[j] = k
    x0_arr = np.zeros((s,), np.float32)
    for name, v in x0.items():
        x0_arr[sidx[name]] = v
    sys = ReactionSystem(
        reactant_idx=idx, reactant_coef=coef, delta=delta, rates=rates,
        x0=x0_arr, species_names=tuple(species),
        reaction_names=tuple(names) if names else tuple(
            f"r{j}" for j in range(r)))
    sys.validate()
    return sys


def require_dense_capable(system: ReactionSystem) -> None:
    """Reject systems the dense path would silently mis-evaluate: the
    comb-factor unroll stops at c = MAX_COEF."""
    coef = np.asarray(system.reactant_coef)
    bad = np.argwhere(coef > MAX_COEF)
    if bad.size:
        j, m = (int(v) for v in bad[0])
        name = (system.reaction_names[j]
                if j < len(system.reaction_names) else f"r{j}")
        raise ValueError(
            f"reaction {name!r} has stoichiometric coefficient "
            f"{int(coef[j, m])} > MAX_COEF={MAX_COEF}: the dense path "
            f"unrolls the combination factors C(n, c) to c <= {MAX_COEF} "
            "and would evaluate silently wrong propensities; run this "
            "system with sparse=True (its unroll goes to the system's "
            "own max coefficient)")


def comb_factors(pops, coef, max_c: int = MAX_COEF):
    """C(pops, coef) unrolled to coef <= max_c: pops (B, R) float32,
    coef (R,) or (B, R) integer. Iterations with coef <= i keep the
    running value, so padding slots (coef 0) give exactly 1."""
    ff = torch.ones_like(pops)
    fact = torch.ones_like(pops)
    for i in range(max_c):
        active = coef > i
        ff = torch.where(active, ff * torch.clamp_min(pops - i, 0.0), ff)
        fact = torch.where(active, fact * (i + 1), fact)
    return ff / fact


def propensities(x, sys_idx, sys_coef, rates, max_c: int = MAX_COEF):
    """Batched mass-action propensities, rates first.

    x: (B, S) float32 counts; sys_idx / sys_coef: (R, M) integer
    tensors; rates: (R,) or (B, R) float32. Returns (B, R) float32. The
    product starts from the rates and multiplies one `comb_factors`
    factor per reactant slot in slot order — the association the
    reference and the CUDA kernel share, which keeps trajectories
    bitwise equal across all three.
    """
    b = x.shape[0]
    xp = torch.cat([x, torch.ones((b, 1), dtype=x.dtype, device=x.device)],
                   dim=1)  # pad slot reads 1
    pops = xp[:, sys_idx]  # (B, R, M)
    a = torch.broadcast_to(rates.to(x.dtype), (b, sys_idx.shape[0]))
    for m in range(sys_idx.shape[1]):
        a = a * comb_factors(pops[:, :, m], sys_coef[None, :, m], max_c)
    return a


def propensities_ref(x, system: ReactionSystem, rates=None) -> np.ndarray:
    """Numpy oracle (exact combinatorics, float64)."""
    x = np.asarray(x)
    rates = np.asarray(rates if rates is not None else system.rates)
    b = x.shape[0]
    out = np.zeros((b, system.n_reactions), np.float64)
    for bi in range(b):
        for j in range(system.n_reactions):
            a = 1.0
            for i, c in zip(system.reactant_idx[j], system.reactant_coef[j]):
                if c > 0:
                    a *= comb(int(x[bi, i]), int(c))
            out[bi, j] = a * (rates[bi, j] if rates.ndim == 2 else rates[j])
    return out


@dataclass(frozen=True)
class SparseTables:
    """Padded sparse structure of a ReactionSystem (numpy, identical to
    the reference's). Pad entries hold out-of-range indices: S for a
    species, R for a reaction.

    reactant_idx / reactant_coef / rate_pad: (R+1, M) / (R+1, M) /
        (R+1,) — the reactant tables with one PAD reaction row (idx S,
        coef 0, rate 0), which evaluates to propensity 0.
    dep_idx: (R+1, K) int32 — dep(j), the reactions whose reactant
        populations change when j fires; row R is all-pad.
    delta_idx: (R+1, D) int32 — the species j changes; row R all-pad.
    delta_val: (R+1, D) float32 — the signed changes (0 at pads).
    max_coef: the comb-factor unroll bound (the system's own).
    """

    reactant_idx: np.ndarray
    reactant_coef: np.ndarray
    rate_pad: np.ndarray
    dep_idx: np.ndarray
    delta_idx: np.ndarray
    delta_val: np.ndarray
    max_coef: int

    @property
    def out_degree(self) -> int:
        return self.dep_idx.shape[1]


def sparse_tables(system: ReactionSystem) -> SparseTables:
    """The dependency graph and sparse stoichiometry of `system`.

    dep(j) = { r : reactants(r) ∩ changed(j) ≠ ∅ }: after j fires only
    these propensities can change; every other one would recompute to
    the same bits, so its carried value is exact.
    """
    r, s = system.n_reactions, system.n_species
    delta = np.asarray(system.delta)
    idx = np.asarray(system.reactant_idx)
    coef = np.asarray(system.reactant_coef)

    by_species: list[list[int]] = [[] for _ in range(s)]
    for j in range(r):
        for i, c in zip(idx[j], coef[j]):
            if c > 0:
                by_species[int(i)].append(j)

    changed = [np.nonzero(delta[j])[0] for j in range(r)]
    deps = []
    for j in range(r):
        dj: set[int] = set()
        for i in changed[j]:
            dj.update(by_species[int(i)])
        deps.append(sorted(dj))

    k = max((len(d) for d in deps), default=1) or 1
    d_max = max((len(c) for c in changed), default=1) or 1

    dep_idx = np.full((r + 1, k), r, np.int32)
    for j, dj in enumerate(deps):
        dep_idx[j, :len(dj)] = dj
    delta_idx = np.full((r + 1, d_max), s, np.int32)
    delta_val = np.zeros((r + 1, d_max), np.float32)
    for j, ci in enumerate(changed):
        delta_idx[j, :len(ci)] = ci
        delta_val[j, :len(ci)] = delta[j, ci]

    m = idx.shape[1]
    idx_pad = np.concatenate([idx, np.full((1, m), s, np.int32)], axis=0)
    coef_pad = np.concatenate([coef, np.zeros((1, m), np.int32)], axis=0)
    rate_pad = np.concatenate(
        [np.asarray(system.rates, np.float32), np.zeros((1,), np.float32)])
    return SparseTables(
        reactant_idx=idx_pad, reactant_coef=coef_pad, rate_pad=rate_pad,
        dep_idx=dep_idx, delta_idx=delta_idx, delta_val=delta_val,
        max_coef=max(system.max_coef, 1))
