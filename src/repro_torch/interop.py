"""State exchange with the reference package, as plain numpy arrays.

The reference's tables and lane pool cross over as numpy arrays (its
keys and draw counters as uint32), so the two packages can be fed one
state without this package importing the other.

  system_arrays: {reactant_idx, reactant_coef, delta, rates, x0,
                  species_names, reaction_names} — `ReactionSystem`
                  fields
  pool_arrays:   {x, t, key, ctr, ctr_hi, steps, leaps, dead, no_leap}
                  — `LaneState` leaves
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.gillespie import LaneState
from repro_torch.core.reactions import ReactionSystem

SYSTEM_FIELDS = ("reactant_idx", "reactant_coef", "delta", "rates", "x0",
                 "species_names", "reaction_names")
_WORDS = ("key", "ctr", "ctr_hi")  # uint32 in the reference


def from_reference(system_arrays: dict, pool_arrays: dict, device=None
                   ) -> tuple[ReactionSystem, LaneState]:
    """The port's (ReactionSystem, LaneState) from the reference's
    arrays; the pool goes to `device` (default: the CUDA device)."""
    dev = resolve_device(device)
    s = system_arrays
    system = ReactionSystem(
        reactant_idx=np.asarray(s["reactant_idx"], np.int32),
        reactant_coef=np.asarray(s["reactant_coef"], np.int32),
        delta=np.asarray(s["delta"], np.int32),
        rates=np.asarray(s["rates"], np.float32),
        x0=np.asarray(s["x0"], np.float32),
        species_names=tuple(s["species_names"]),
        reaction_names=tuple(s["reaction_names"]))
    system.validate()

    def leaf(name):
        a = np.asarray(pool_arrays[name])
        if name in _WORDS:
            a = a.astype(np.uint32).view(np.int32)
        return torch.tensor(a, device=dev)  # a copy: the port owns it

    return system, LaneState(*(leaf(f) for f in LaneState._fields))


def to_reference_arrays(system: ReactionSystem, pool: LaneState
                        ) -> tuple[dict, dict]:
    """(system_arrays, pool_arrays) in the reference's dtypes."""
    sysd = {f: getattr(system, f) for f in SYSTEM_FIELDS}
    poold = {}
    for f in LaneState._fields:
        a = getattr(pool, f).cpu().numpy()
        poold[f] = a.view(np.uint32) if f in _WORDS else a
    return sysd, poold
