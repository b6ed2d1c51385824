"""Faults planted under a whole run, which the comparison has to catch:
each `plant(setattr)` replaces a piece of the program's timed path
through `setattr(module, name, value)` (pytest's `monkeypatch.setattr`
in the tests, the builtin on the card)."""
from __future__ import annotations


def unchanged_step(setattr):
    """Every window kernel returns its lanes unchanged, at the horizon."""
    import torch

    from repro_torch.kernels import ops

    def exact(x, t, dead, key, ctr, ctr_hi, *a, **k):
        h = torch.full_like(t, float(a[-1]))
        return x, h, dead, torch.zeros_like(dead), ctr, ctr_hi

    def tau(x, t, dead, no_leap, key, ctr, ctr_hi, *a, **k):
        h = torch.full_like(t, float(a[-1]))
        zero = torch.zeros_like(dead)
        return x, h, dead, zero, zero, ctr, ctr_hi, zero

    for name in ("ssa_window_call", "sparse_window_call"):
        setattr(ops, name, exact)
    for name in ("tau_window_call", "sparse_tau_window_call"):
        setattr(ops, name, tau)


def half_batch(setattr):
    """The fold over the first half of the lanes only."""
    from repro_torch.core import reduction

    fold = reduction.blocked_welford
    setattr(reduction, "blocked_welford",
            lambda obs, v: fold(obs[: obs.shape[0] // 2], v))


def altered_answer(setattr):
    """Each record's means altered by a thousandth where they are made."""
    from repro_torch.core import reduction

    fin = reduction.finalize
    setattr(reduction, "finalize",
            lambda acc: fin(acc)._replace(mean=fin(acc).mean * 1.001))


FAULTS = {f.__name__: f for f in (unchanged_step, half_batch, altered_answer)}
