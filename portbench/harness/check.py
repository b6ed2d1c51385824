"""Whether the window's jobs gave the right answers: the program's
outputs against the plain reference (`portbench.reference`).

Compared, for jobs drawn from the run's seed among its first few (each
finished in the window, its lanes' populations copied to the host after
each `resume()`, which in the cells so far is every window):

- `lanes_off`: of a sample of the job's lanes, drawn from the seed, how
  many differ from the reference after some copied window, when it follows
  them from the start through every window with the lanes' own keys
  (the counter-based draws, Match, Resolve and Update, the freeze at
  each horizon, tau's choice between a leap and an exact step). Exact:
  the limit is 0.
- `fold_err`: every record of a copied window (n, mean and variance of
  each observable, as the program folded and packed them) against the
  reference's float64 fold of that window's populations of every lane
  (`reference/reductions/<reduction>.py`): the largest
  |record - reference| / max(|reference|, 1). It is infinite where any
  job of the window delivered other records than its windows (a count,
  a window index, a time or an n that differs from the configuration's
  `check.record_n`, or a value that is not finite).

The control puts the reference in the program's place at the next
precision below the configuration's float32, bfloat16: the sampled lanes
followed with populations and propensities rounded to bfloat16, and each
record folded in bfloat16 from the program's populations.
"""
from __future__ import annotations

import importlib

import numpy as np

from portbench.reference.lanes import bf16, follow


def drawn_jobs(seed: int, n: int, pool: int) -> list:
    """The `n` job indices the comparison reads, drawn from the seed
    among the window's first `pool`."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 1])
    return sorted(int(i) for i in rng.choice(pool, size=n, replace=False))


def drawn_lanes(seed: int, job: int, replicas: int, n: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed) % 2 ** 63, 2, job])
    return np.sort(rng.choice(replicas, size=min(n, replicas),
                              replace=False))


def reduction(cell):
    """The reference's fold of the cell's reduction."""
    name = cell.spec.get("reduction", "ensemble")
    return importlib.import_module(f"portbench.reference.reductions.{name}")


def bad_records(cell, jobs) -> int:
    """Jobs whose records are not one a window: the window's index, its
    horizon, `check.record_n` and finite values."""
    t_end, n_windows = cell.schedule["t_end"], cell.n_windows
    grid = np.linspace(t_end / n_windows, t_end, n_windows)
    want_n = cell.check["record_n"]
    bad = 0
    for job in jobs:
        recs = job.records
        ok = len(recs) == job.windows == len(job.arrivals)
        for w, r in enumerate(recs):
            ok = ok and r.window == w and r.t == float(grid[w]) and (
                np.all(np.asarray(r.n) == want_n)) and all(
                np.isfinite(v).all() for v in (r.mean, r.var, r.ci90))
        bad += not ok
    return bad


def record_err(rec: dict, ref: dict) -> float:
    err = float(np.max(np.abs(np.asarray(rec["n"]) - ref["n"])
                       / ref["n"]))
    for k in ("mean", "var"):
        got = np.asarray(rec[k], np.float64)
        err = max(err, float(np.max(np.abs(got - ref[k])
                                    / np.maximum(np.abs(ref[k]), 1.0))))
    return err


def compare(cell, window, seed: int, control: bool = False) -> dict:
    """The compared numbers of a window whose drawn jobs kept their
    states."""
    n_windows = cell.n_windows
    red = reduction(cell)
    out = dict(lanes_off=0, fold_err=0.0, jobs=0, records=0,
               bad_records=bad_records(cell, window.jobs))
    if out["bad_records"]:
        out["fold_err"] = float("inf")
    for job in window.jobs:
        states, job.states = job.states, {}
        if job.windows != n_windows or n_windows - 1 not in states:
            continue
        lanes = drawn_lanes(seed, job.index, cell.replicas,
                            cell.check["lanes"])
        ref = follow(cell.net, cell.job(job.seed), lanes, n_windows)
        got = {w: x[lanes] for w, x in states.items()}
        if control:
            xs = follow(cell.net, cell.job(job.seed), lanes, n_windows,
                        rnd=bf16)["xs"]
            got = {w: xs[w] for w in states}
        off = ref["truncated"].copy()
        for w, mine in got.items():
            off |= (mine != ref["xs"][w]).any(axis=1)
        out["lanes_off"] += int(off.sum())
        for rec in job.records:
            if rec.window not in states:
                continue
            obs = cell.net.observables(states[rec.window])
            mine = (red.fold_bf16(obs) if control else
                    dict(n=rec.n, mean=rec.mean, var=rec.var))
            out["fold_err"] = max(out["fold_err"],
                                  record_err(mine, red.fold(obs)))
            out["records"] += 1
        out["jobs"] += 1
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    return numbers["jobs"] > 0 and all(numbers[k] <= v
                                       for k, v in limits.items())
