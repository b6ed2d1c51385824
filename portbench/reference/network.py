"""A configuration's reaction network as flat tables.

`build(config)` hands the file's `network` block to the generator named
by its `kind` (`networks/<kind>.py`, which lists species, reactions and
observables in the compiled order) and lays the result out as mass-action
tables: each reaction's reactant slots (species index, multiplicity) in
ascending species-name order, padded with index S and multiplicity 0, its
stoichiometric change, its rate, the initial populations and the species
that each observable sums.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np

SLOTS = 4


@dataclass(frozen=True)
class Network:
    species: tuple
    idx: np.ndarray  # (R, SLOTS) int64, S pads
    coef: np.ndarray  # (R, SLOTS) int64, 0 pads
    delta: np.ndarray  # (R, S) float32
    rates: np.ndarray  # (R,) float32
    x0: np.ndarray  # (S,) float32
    obs_names: tuple
    obs_idx: tuple  # per observable, the species indices it sums

    @property
    def n_species(self) -> int:
        return self.delta.shape[1]

    @property
    def n_reactions(self) -> int:
        return self.delta.shape[0]

    @property
    def max_coef(self) -> int:
        return int(self.coef.max())

    def observables(self, x) -> np.ndarray:
        """(B, n_obs) float64 observables of populations x (B, S): each
        the sum of its species (whole numbers, so exact in float64)."""
        m = np.zeros((self.n_species, len(self.obs_idx)))
        for o, members in enumerate(self.obs_idx):
            m[list(members), o] = 1.0
        return np.asarray(x, np.float64) @ m


def build(config: dict) -> Network:
    spec = dict(config["network"])
    gen = importlib.import_module(
        f"portbench.reference.networks.{spec.pop('kind')}")
    species, reactions, x0, observables = gen.generate(**spec)
    sidx = {s: i for i, s in enumerate(species)}
    r, s = len(reactions), len(species)
    idx = np.full((r, SLOTS), s, np.int64)
    coef = np.zeros((r, SLOTS), np.int64)
    delta = np.zeros((r, s), np.int64)
    rates = np.zeros((r,), np.float32)
    for j, (lhs, rhs, k) in enumerate(reactions):
        for m, (name, c) in enumerate(sorted(lhs.items())):
            idx[j, m], coef[j, m] = sidx[name], c
            delta[j, sidx[name]] -= c
        for name, c in rhs.items():
            delta[j, sidx[name]] += c
        rates[j] = k
    x = np.zeros((s,), np.float32)
    for name, v in x0.items():
        x[sidx[name]] = v
    return Network(
        species=tuple(species), idx=idx, coef=coef,
        delta=delta.astype(np.float32), rates=rates, x0=x,
        obs_names=tuple(n for n, _ in observables),
        obs_idx=tuple(tuple(sidx[m] for m in members)
                      for _, members in observables))
