"""Parameter sweeps (paper §3.1.2: replicas OR parameter sweeping); the
port's own copy of `repro/core/sweep.py`.

A sweep maps named kinetic constants over per-instance values, yielding
the (I, R) rate matrix the engine consumes. Replicas of each sweep
point are interleaved so on-line reduction can still aggregate per
point (grouped reduction helper included).
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import product
from typing import Sequence

import numpy as np

from repro_torch.core.reactions import ReactionSystem


@dataclass(frozen=True)
class SweepSpec:
    """values: {reaction_name: [v1, v2, ...]} — full factorial."""

    values: tuple  # ((reaction_name, (v, ...)), ...)
    replicas: int = 1

    @staticmethod
    def make(values: dict, replicas: int = 1) -> "SweepSpec":
        return SweepSpec(tuple((k, tuple(v)) for k, v in values.items()),
                         replicas)

    def points(self) -> list[dict]:
        names = [k for k, _ in self.values]
        grids = [v for _, v in self.values]
        return [dict(zip(names, combo)) for combo in product(*grids)]

    def n_instances(self) -> int:
        return len(self.points()) * self.replicas


def _matching_reactions(system: ReactionSystem, name: str) -> list[int]:
    """Rule names compile to one reaction per compartment context
    ("<rule>@<ctx>"); a sweep on the rule name touches all of them."""
    idx = [j for j, rn in enumerate(system.reaction_names)
           if rn == name or rn.split("@", 1)[0] == name]
    if not idx:
        raise KeyError(f"no reaction matches {name!r}: "
                       f"{system.reaction_names}")
    return idx


def sweep_rates(system: ReactionSystem, spec: SweepSpec) -> np.ndarray:
    """(I, R) rate matrix; instance i = point (i // replicas)."""
    pts = spec.points()
    out = np.broadcast_to(
        system.rates, (len(pts) * spec.replicas, system.n_reactions)).copy()
    for p, overrides in enumerate(pts):
        for name, v in overrides.items():
            for j in _matching_reactions(system, name):
                out[p * spec.replicas:(p + 1) * spec.replicas, j] = v
    return out.astype(np.float32)


def point_slices(spec: SweepSpec) -> list[slice]:
    return [slice(p * spec.replicas, (p + 1) * spec.replicas)
            for p in range(len(spec.points()))]
