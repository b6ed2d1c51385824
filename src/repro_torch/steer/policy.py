"""SteeringPolicy — the between-block controller; port of
`repro/steer/policy.py` (numpy only, the reference's decisions and
state layout, so a policy's state restores in either package).

The engine's superstep collector (`engine.run_block`) hands the policy
one DECISION POINT per collected block: the freshest per-point Welford
statistics, the newest window histogram (repro_torch/stats), and the
exact per-lane step/leap counters. The policy returns `SteeringActions`;
the engine applies them to the device pool before dispatching the next
block.

Four levers (each independently enabled on the `Steering` spec):

* EARLY-STOP: a sweep point whose per-observable relative CI
  half-width (ci90 / max(|mean|, 1)) stays under `ci_rel_tol` after
  `min_windows` windows is converged — its lanes are marked dead, so
  subsequent windows cost it nothing.
* REALLOCATE: all but one of a freshly stopped point's lanes are
  re-seeded onto the live point with the WORST relative CI, cloning a
  donor lane's trajectory state (x, t, dead) while keeping the moved
  lane's OWN RNG stream — trajectory splitting. One lane stays behind
  so the stopped point's grouped record keeps a defined (frozen) value.
* TAU-SWITCH: a tau-leap lane whose EMA leap share (accepted leaps /
  solver steps per block) sits below `min_leap_frac` after
  `tau_switch_min_steps` steps is pinned to exact SSA
  (`LaneState.no_leap`).
* BIMODALITY: histograms whose smoothed shape shows two separated
  modes (`stats.bimodality_from_hist`) are flagged into the decision
  log.

DETERMINISM CONTRACT: decisions are pure functions of the sketch and
counter values, evaluated in a fixed order with integer/argmax
tie-breaks. A steered run is exactly reproducible from (seed, Steering
spec), and a restored run (the policy state rides the engine
checkpoint via `state_dict`) replays the identical decision sequence.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.stats.sketch import bimodality_from_hist

__all__ = ["Steering", "SteeringActions", "SteeringPolicy"]


@dataclass(frozen=True)
class Steering:
    """The steering spec (pure data; see module docstring for the four
    levers). All levers default OFF: `Steering()` is the identity
    policy, and a run carrying it is bitwise identical to one with no
    steering at all (the engine still calls decide(), which returns
    empty actions and touches nothing).

    ci_rel_tol: early-stop when every observable's ci90 / max(|mean|,
    1) falls below this (0 disables).
    min_windows: never stop a point before this many windows.
    check_every: make decisions every Nth block boundary.
    reallocate: move a stopped point's lanes (all but one) to the live
    point with the worst relative CI.
    tau_switch: enable the per-lane exact<->tau auto-switch
    (Method.TAU_LEAP runs only).
    min_leap_frac / tau_switch_min_steps: switch a lane to exact once
    its EMA leap share is below the fraction and it has taken at least
    the step count.
    ema_alpha: EMA weight for the per-lane step/leap block rates.
    bimodality: flag bimodal (point, observable) histograms (needs a
    SketchSpec on the experiment).
    """

    ci_rel_tol: float = 0.0
    min_windows: int = 4
    check_every: int = 1
    reallocate: bool = False
    tau_switch: bool = False
    min_leap_frac: float = 0.1
    tau_switch_min_steps: int = 256
    ema_alpha: float = 0.5
    bimodality: bool = False

    @property
    def enabled(self) -> bool:
        return (self.ci_rel_tol > 0 or self.reallocate
                or self.tau_switch or self.bimodality)

    def validate(self) -> None:
        if self.ci_rel_tol < 0:
            raise ValueError(
                f"Steering.ci_rel_tol must be >= 0, got {self.ci_rel_tol}")
        if self.min_windows < 1:
            raise ValueError(
                f"Steering.min_windows must be >= 1, got "
                f"{self.min_windows}")
        if self.check_every < 1:
            raise ValueError(
                f"Steering.check_every must be >= 1, got "
                f"{self.check_every}")
        if not 0 <= self.min_leap_frac <= 1:
            raise ValueError(
                f"Steering.min_leap_frac must be in [0, 1], got "
                f"{self.min_leap_frac}")
        if not 0 < self.ema_alpha <= 1:
            raise ValueError(
                f"Steering.ema_alpha must be in (0, 1], got "
                f"{self.ema_alpha}")
        if self.reallocate and not self.ci_rel_tol > 0:
            raise ValueError(
                "Steering.reallocate needs early-stopping "
                "(ci_rel_tol > 0) to free any lanes")

    def check_run(self, *, host_loop: bool, sketched: bool,
                  tau_leap: bool, pipeline_depth) -> None:
        """`validate()`, then the four conflicts of an enabled spec with
        the run it steers; the one copy the spec and the engine share."""
        self.validate()
        if not self.enabled:
            return
        if host_loop:
            raise ValueError(
                "steering is driven from the superstep collector; "
                "the host_loop baseline has no block boundary to "
                "steer at (use the fused strategy)")
        if self.bimodality and not sketched:
            raise ValueError(
                "Steering.bimodality reads window histograms — "
                "configure a SketchSpec as well")
        if self.tau_switch and not tau_leap:
            raise ValueError(
                "Steering.tau_switch only applies to tau-leaping runs")
        if isinstance(pipeline_depth, int) and pipeline_depth > 1:
            raise ValueError(
                "steering is incompatible with an explicit "
                f"pipeline_depth={pipeline_depth}: decisions must see "
                "block k before block k+1 dispatches (lock-step). Use "
                "pipeline_depth=1 or 'auto' (which resolves to 1 under "
                "steering)")


class SteeringActions(NamedTuple):
    """What the engine should apply before the next block.

    stop_lanes: (I,) bool — mark these lanes dead (early-stopped
    points, minus any lanes being moved).
    moves: (n_moves, 2) int32 [lane, donor] pairs — clone donor state
    onto lane (reallocation); empty (0, 2) when none.
    new_group_ids: (I,) int32 or None — regrouped sweep-point ids
    after moves.
    no_leap: (I,) bool or None — updated per-lane exact-SSA pins.
    """

    stop_lanes: np.ndarray
    moves: np.ndarray
    new_group_ids: Optional[np.ndarray]
    no_leap: Optional[np.ndarray]

    @property
    def any(self) -> bool:
        return (bool(self.stop_lanes.any()) or len(self.moves) > 0
                or self.new_group_ids is not None
                or self.no_leap is not None)


def _empty_actions(n_instances: int) -> SteeringActions:
    return SteeringActions(
        stop_lanes=np.zeros(n_instances, bool),
        moves=np.zeros((0, 2), np.int32),
        new_group_ids=None, no_leap=None)


class SteeringPolicy:
    """Host-side controller state + decision log for one run.

    Construct once per engine (engine.set_steering does); feed it
    decision points via `decide()`. All state is numpy and serialises
    through `state_dict()`/`load_state()` for checkpoint/restore.
    """

    def __init__(self, spec: Steering, n_instances: int, n_points: int,
                 n_windows: int, tau_leap: bool):
        spec.validate()
        self.spec = spec
        self.n_instances = n_instances
        self.n_points = max(n_points, 1)
        self.n_windows = n_windows
        self.tau_leap = tau_leap
        self.stopped = np.zeros(self.n_points, bool)
        self.stop_window = np.full(self.n_points, -1, np.int64)
        self.no_leap = np.zeros(n_instances, bool)
        self.ema_steps = np.zeros(n_instances, np.float64)
        self.ema_leap_frac = np.zeros(n_instances, np.float64)
        self.prev_steps = np.zeros(n_instances, np.int64)
        self.prev_leaps = np.zeros(n_instances, np.int64)
        self.blocks_seen = 0
        self.decisions: list[dict] = []
        self.bimodal_flags: list[dict] = []

    # ------------------------------------------------------------ state
    def state_dict(self) -> dict:
        """Flat numpy mapping for np.savez (engine.checkpoint prefixes
        the keys); the decision log rides as one JSON string."""
        return dict(
            stopped=self.stopped, stop_window=self.stop_window,
            no_leap=self.no_leap, ema_steps=self.ema_steps,
            ema_leap_frac=self.ema_leap_frac,
            prev_steps=self.prev_steps, prev_leaps=self.prev_leaps,
            blocks_seen=np.int64(self.blocks_seen),
            log=np.array(json.dumps(
                {"decisions": self.decisions,
                 "bimodal": self.bimodal_flags})))

    def load_state(self, d: dict) -> None:
        self.stopped = np.asarray(d["stopped"], bool).copy()
        self.stop_window = np.asarray(d["stop_window"], np.int64).copy()
        self.no_leap = np.asarray(d["no_leap"], bool).copy()
        self.ema_steps = np.asarray(d["ema_steps"], np.float64).copy()
        self.ema_leap_frac = np.asarray(
            d["ema_leap_frac"], np.float64).copy()
        self.prev_steps = np.asarray(d["prev_steps"], np.int64).copy()
        self.prev_leaps = np.asarray(d["prev_leaps"], np.int64).copy()
        self.blocks_seen = int(d["blocks_seen"])
        log = json.loads(str(np.asarray(d["log"])))
        self.decisions = list(log["decisions"])
        self.bimodal_flags = list(log["bimodal"])

    # ----------------------------------------------------------- decide
    def decide(self, window: int, point_stats: Optional[dict],
               sketch_hist: Optional[np.ndarray],
               group_ids: np.ndarray, steps: np.ndarray,
               leaps: np.ndarray) -> SteeringActions:
        """One decision point, AFTER the block ending at `window`
        (exclusive) was collected.

        point_stats: {"mean"|"ci90": (G, n_obs)} for the latest
        window — per-point grouped stats when available, else the
        pooled ensemble record as a single point. sketch_hist:
        (G, n_obs, n_bins) int32 latest-window histogram or None.
        group_ids: (I,) current lane->point map. steps/leaps: (I,)
        cumulative per-lane counters (exact ints, path-invariant).
        """
        spec = self.spec
        self.blocks_seen += 1
        self._update_emas(steps, leaps)
        if not spec.enabled \
                or (self.blocks_seen - 1) % spec.check_every:
            return _empty_actions(self.n_instances)

        actions = _empty_actions(self.n_instances)
        if spec.bimodality and sketch_hist is not None:
            self._flag_bimodal(window, sketch_hist)
        newly = np.zeros(self.n_points, bool)
        if spec.ci_rel_tol > 0 and point_stats is not None \
                and window >= spec.min_windows:
            newly = self._early_stop(window, point_stats)
        moves, gids = self._reallocate(window, newly, point_stats,
                                       group_ids)
        stop = newly[group_ids] & self.stopped[group_ids]
        if len(moves):
            stop[moves[:, 0]] = False  # moved lanes live on elsewhere
        new_no_leap = self._tau_switch(window)
        return SteeringActions(
            stop_lanes=stop, moves=moves, new_group_ids=gids,
            no_leap=new_no_leap)

    # ---------------------------------------------------------- helpers
    def _update_emas(self, steps: np.ndarray, leaps: np.ndarray) -> None:
        a = self.spec.ema_alpha
        ds = (np.asarray(steps, np.int64) - self.prev_steps).astype(
            np.float64)
        dl = (np.asarray(leaps, np.int64) - self.prev_leaps).astype(
            np.float64)
        frac = np.where(ds > 0, dl / np.maximum(ds, 1.0),
                        self.ema_leap_frac)
        self.ema_steps = (1 - a) * self.ema_steps + a * ds
        self.ema_leap_frac = (1 - a) * self.ema_leap_frac + a * frac
        self.prev_steps = np.asarray(steps, np.int64).copy()
        self.prev_leaps = np.asarray(leaps, np.int64).copy()

    def _rel_ci(self, point_stats: dict) -> np.ndarray:
        mean = np.asarray(point_stats["mean"], np.float64)
        ci = np.asarray(point_stats["ci90"], np.float64)
        if mean.ndim == 1:  # pooled ensemble record -> one point
            mean, ci = mean[None, :], ci[None, :]
        return ci / np.maximum(np.abs(mean), 1.0)

    def _early_stop(self, window: int, point_stats: dict) -> np.ndarray:
        rel = self._rel_ci(point_stats)
        conv = (rel < self.spec.ci_rel_tol).all(axis=1)
        g = min(len(conv), self.n_points)
        newly = np.zeros(self.n_points, bool)
        newly[:g] = conv[:g] & ~self.stopped[:g]
        if newly.any():
            self.stopped |= newly
            self.stop_window[newly] = window
            self.decisions.append({
                "window": int(window), "action": "stop",
                "points": np.flatnonzero(newly).tolist(),
                "rel_ci": [round(float(rel[p].max()), 6)
                           for p in np.flatnonzero(newly)]})
        return newly

    def _reallocate(self, window: int, newly: np.ndarray,
                    point_stats: Optional[dict], group_ids: np.ndarray):
        if not self.spec.reallocate or not newly.any() \
                or point_stats is None:
            return np.zeros((0, 2), np.int32), None
        live = ~self.stopped
        if not live.any():
            return np.zeros((0, 2), np.int32), None
        rel = self._rel_ci(point_stats).max(axis=1)
        score = np.where(live[:min(len(rel), self.n_points)],
                         rel[:self.n_points], -np.inf)
        target = int(np.argmax(score))  # first max: deterministic
        donors = np.flatnonzero(group_ids == target)
        if not len(donors):
            return np.zeros((0, 2), np.int32), None
        # the reference's per-lane loop, vectorised per stopped point:
        # the same (lane, donor) pairs in the same order, the i-th moved
        # lane of each point cloning donor i mod len(donors)
        moves = []
        gids = group_ids.copy()
        for p in np.flatnonzero(newly):
            lanes = np.flatnonzero(group_ids == p)[1:]  # keep lanes[0]
            moves.append(np.stack(
                [lanes, donors[np.arange(len(lanes)) % len(donors)]], 1))
            gids[lanes] = target
        moves = np.concatenate(moves).astype(np.int32)
        if not len(moves):
            return np.zeros((0, 2), np.int32), None
        self.decisions.append({
            "window": int(window), "action": "reallocate",
            "target": target, "n_moved": len(moves)})
        return moves, gids

    def _tau_switch(self, window: int) -> Optional[np.ndarray]:
        if not (self.spec.tau_switch and self.tau_leap):
            return None
        seen = self.prev_steps >= self.spec.tau_switch_min_steps
        pin = (seen & ~self.no_leap
               & (self.ema_leap_frac < self.spec.min_leap_frac))
        if not pin.any():
            return None
        self.no_leap |= pin
        self.decisions.append({
            "window": int(window), "action": "no_leap",
            "n_lanes": int(pin.sum()),
            "total_pinned": int(self.no_leap.sum())})
        return self.no_leap.copy()

    def _flag_bimodal(self, window: int, hist: np.ndarray) -> None:
        flags = bimodality_from_hist(hist)  # (G, n_obs)
        for g, o in zip(*np.nonzero(flags)):
            self.bimodal_flags.append({
                "window": int(window), "point": int(g),
                "obs": int(o)})

    # ------------------------------------------------------------ report
    def report(self) -> dict:
        """Savings + decision summary (the SimulationResult accessor
        and the bench early-stop row read this)."""
        w = self.n_windows
        active = np.where(self.stopped, self.stop_window, w)
        simulated = int(np.minimum(active, w).sum())
        total = self.n_points * w
        return {
            "n_points": self.n_points,
            "stopped_points": np.flatnonzero(self.stopped).tolist(),
            "stop_windows": {int(p): int(self.stop_window[p])
                             for p in np.flatnonzero(self.stopped)},
            "point_windows_total": total,
            "point_windows_simulated": simulated,
            "windows_saved_ratio": (total / simulated
                                    if simulated else float(total)),
            "lanes_pinned_exact": int(self.no_leap.sum()),
            "bimodal_flags": list(self.bimodal_flags),
            "decisions": list(self.decisions),
        }
