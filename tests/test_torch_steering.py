"""Steering in the port (`repro_torch.steer`, the engine's decision
point and its on-device apply) against the reference, case for case
with tests/test_steering.py: the identity contract, early stop,
determinism, reallocation, the tau switch, bimodality at policy level,
the pipeline depth forced to 1 and an explicit depth 2 refused; plus
the crash drill (drop the engine at block boundaries, rebuild, restore)
against both packages' uninterrupted runs, a ring snapshot held across
a steered boundary, and the host syncs a decision point costs.

Decisions read per-point ci90, which the port holds to an ulp bound of
the reference's, not bitwise; each case prints the margin |rel_ci -
tol| / tol of every (decision window, live point), so a decision that
could flip between the packages shows. Record means and the pool are
bitwise, var and ci90 within the ulp bound.

The cases run the reference's mixed-variance immigration-death sweep
with the birth rates and replicas scaled (2.5 and 40 over 640
replicas, against 50 and 800 over 32) so that each relative CI is the
reference case's at a twentieth of the events per lane, which the
port's plain CPU twin pays step by step. The decisions are the
reference sizes' too: the drill's run stops point 1 at window 4, moves
all but one of its lanes to point 0, and stops point 0 at window 6.
"""
import numpy as np
import pytest
import torch

import repro.api as J
import repro_torch.api as T
from repro.core.reactions import make_system as j_make_system
from repro.steer.policy import SteeringPolicy as JPolicy
from repro_torch.core.reactions import make_system as t_make_system
from repro_torch.steer.policy import SteeringPolicy as TPolicy

LAMS, REPLICAS = (2.5, 40.0), 640
N_WINDOWS, T_END = 8, 8.0
VAR_ULP = 12
CI90_ULP = 8
TOL = 0.03


def _exp(api, steering=None, lams=LAMS, replicas=REPLICAS, **kw):
    kw.setdefault("window_block", 2)
    make = j_make_system if api is J else t_make_system
    model = make(["A"], [({}, {"A": 1}, lams[0]), ({"A": 1}, {}, 1.0)],
                 {"A": 0}, names=("birth", "death"))
    if isinstance(kw.get("sketch"), dict):
        kw["sketch"] = api.SketchSpec(**kw["sketch"])
    return api.Experiment(
        model=model,
        ensemble=api.Ensemble.make(replicas=replicas,
                                   sweep={"birth": list(lams)}),
        schedule=api.Schedule(t_end=T_END, n_windows=N_WINDOWS),
        reduction=api.Reduction.PER_POINT, n_lanes=16, seed=5,
        steering=(None if steering is None
                  else getattr(api, "Steering")(**steering)),
        # the port's kernel path runs its plain twin here; the
        # reference's jitted unfused path gives the same bits
        use_kernel=api is T, **kw)


def run(exp, **kw):
    if isinstance(exp, T.Experiment):
        return T.simulate(exp, device="cpu", **kw)
    return J.simulate(exp, **kw)


_RUNS = {}


def both(name, steering=None, **kw):
    """(reference run, port run) of one case, each run once a module."""
    if name not in _RUNS:
        _RUNS[name] = tuple(run(_exp(api, steering, **kw)) for api in (J, T))
    return _RUNS[name]


STOP = dict(ci_rel_tol=TOL, min_windows=4)
REALLOC = dict(STOP, reallocate=True)


def ulp(a, b) -> int:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def rec_tuple(records):
    return [(r.t, r.n, r.mean.tobytes(), r.var.tobytes(), r.ci90.tobytes())
            for r in records]


def assert_like_reference(ref, got, ctx=""):
    """Pool x bitwise; records and per-point statistics: n and means
    bitwise, var/ci90 within the ulp bound; the steering reports equal."""
    assert (np.asarray(ref._engine._pool.x)
            == got._engine._pool.x.numpy()).all(), ctx
    assert len(ref.records) == len(got.records) == N_WINDOWS, ctx
    for a, b in zip(ref.records, got.records):
        assert (a.t, a.window, a.n) == (b.t, b.window, b.n), ctx
        assert a.mean.tobytes() == b.mean.tobytes(), ctx
        assert ulp(a.var, b.var) <= VAR_ULP, ctx
        assert ulp(a.ci90, b.ci90) <= CI90_ULP, ctx
    pa, pb = ref.per_point(), got.per_point()
    for f in ("n", "mean"):
        assert pa[f].tobytes() == pb[f].tobytes(), (ctx, f)
    assert ulp(pa["var"], pb["var"]) <= VAR_ULP, ctx
    assert ulp(pa["ci90"], pb["ci90"]) <= CI90_ULP, ctx
    assert ref.steering_report() == got.steering_report(), ctx


def print_margins(res, tol=TOL, min_windows=4, every=2):
    """|rel_ci - tol| / tol per decision window and point, read from
    the port's per-point records as its policy read them; returns the
    smallest."""
    pp = res.per_point()
    rel = (pp["ci90"].astype(np.float64)
           / np.maximum(np.abs(pp["mean"].astype(np.float64)), 1.0)
           ).max(axis=2)  # (windows, points)
    margins = {w: [round(float(abs(r - tol) / tol), 6) for r in rel[w - 1]]
               for w in range(every, N_WINDOWS, every) if w >= min_windows}
    print(f"decision margins |rel_ci - tol| / tol by window: {margins}")
    return min(min(m) for m in margins.values())


# ------------------------------------------------- identity contract
def test_all_off_steering_is_inert_and_bitwise():
    """`Steering()` never instantiates the policy, and an active policy
    that makes no decision leaves every record bit untouched — steered
    runs take the block loop, so this also pins the block loop against
    the per-window path at window_block=1."""
    ref_plain, plain = both("plain")
    inert = run(_exp(T, {}))
    assert inert._engine._steer is None
    assert rec_tuple(inert.records) == rec_tuple(plain.records)
    ref_active, active = both("active", dict(ci_rel_tol=1e-9))
    assert active._engine._steer is not None
    assert active.steering_report()["decisions"] == []
    assert rec_tuple(active.records) == rec_tuple(plain.records)
    one = run(_exp(T, dict(ci_rel_tol=1e-9), window_block=1))
    assert rec_tuple(one.records) == rec_tuple(plain.records)
    assert one.telemetry.dispatches == N_WINDOWS  # blocks of one window
    assert_like_reference(ref_active, active)
    assert ref_plain.steering_report() is plain.steering_report() is None


# ------------------------------------------------------- early-stop
def test_early_stop_freezes_converged_point():
    ref, res = both("stop", STOP)
    rep = res.steering_report()
    assert rep["stopped_points"] == [1]
    stop_w = rep["stop_windows"][1]
    assert stop_w == 4
    assert rep["point_windows_simulated"] == N_WINDOWS + stop_w
    assert rep["windows_saved_ratio"] == pytest.approx(16 / 12)
    pp = res.per_point()
    for w in range(stop_w, N_WINDOWS):
        assert (pp["mean"][w, 1] == pp["mean"][stop_w - 1, 1]).all()
        assert (pp["var"][w, 1] == pp["var"][stop_w - 1, 1]).all()
    assert not (pp["mean"][N_WINDOWS - 1, 0]
                == pp["mean"][stop_w - 1, 0]).all()
    assert_like_reference(ref, res)
    assert print_margins(res) > 1e-3


def test_steered_decisions_and_records_deterministic():
    _, a = both("stop", STOP)
    b = run(_exp(T, STOP))
    assert a.steering_report()["decisions"] \
        == b.steering_report()["decisions"]
    assert rec_tuple(a.records) == rec_tuple(b.records)
    assert (a._engine._pool.x == b._engine._pool.x).all()


# ------------------------------------------------------- reallocate
def test_reallocation_moves_freed_lanes_to_worst_point():
    """All but one of the stopped point's lanes move to the live point,
    each taking its donor's x, t, dead, rates row and scheduler cost;
    grouped counts re-shape at the boundary and the live point's CI
    tightens."""
    ref, res = both("realloc", REALLOC)
    rep = res.steering_report()
    realloc = [d for d in rep["decisions"] if d["action"] == "reallocate"]
    assert realloc == [{"window": 4, "action": "reallocate", "target": 0,
                        "n_moved": REPLICAS - 1}]
    pp = res.per_point()
    stop_w = rep["stop_windows"][1]
    assert pp["n"][stop_w - 1, 0, 0] == REPLICAS
    assert pp["n"][N_WINDOWS - 1, 0, 0] == 2 * REPLICAS - 1
    assert pp["n"][N_WINDOWS - 1, 1, 0] == 1
    _, base = both("stop", STOP)
    assert (pp["ci90"][N_WINDOWS - 1, 0]
            < base.per_point()["ci90"][N_WINDOWS - 1, 0]).all()
    eng = res._engine
    moved = np.arange(REPLICAS + 1, 2 * REPLICAS)
    assert (eng._group_ids[moved] == 0).all()
    assert (eng.rates[moved] == eng.rates[0]).all()
    assert eng.rates.tobytes() == np.asarray(ref._engine.rates).tobytes()
    assert torch.equal(eng._rates_dev, torch.as_tensor(eng.rates))
    assert eng.scheduler._cost.tobytes() \
        == np.asarray(ref._engine.scheduler._cost).tobytes()
    assert_like_reference(ref, res)
    assert print_margins(res) > 1e-3


# ------------------------------------------------------- tau-switch
def test_tau_switch_pins_fallback_bound_lanes_exact():
    """With a leap threshold no leap meets, every lane is pure exact
    fallback, so the switch pins the whole pool at the first boundary,
    without changing a record bit."""
    kw = dict(method="tau_leap", tau_fallback=1e6)
    ref, steered = both("tau", dict(tau_switch=True,
                                    tau_switch_min_steps=8), **kw)
    rep = steered.steering_report()
    assert rep["lanes_pinned_exact"] == 2 * REPLICAS
    pins = [d for d in rep["decisions"] if d["action"] == "no_leap"]
    assert pins and pins[0]["window"] == 2
    assert steered._engine._pool.no_leap.all()
    plain = run(_exp(T, **kw))
    assert rec_tuple(steered.records) == rec_tuple(plain.records)
    assert_like_reference(ref, steered)


# ------------------------------------------------------- bimodality
def test_bimodality_flags_land_in_decision_log():
    """Policy level: a two-mode histogram for (point 1, obs 0) is
    flagged at the decision point, in both packages alike, and nothing
    else is actioned; the policies' state dicts agree."""
    hist = np.zeros((2, 1, 16), np.int32)
    hist[1, 0, 2:4] = (50, 45)
    hist[1, 0, 11:13] = (40, 48)
    z = np.zeros(4, np.int64)
    pols = []
    for cls, spec in ((JPolicy, J.Steering), (TPolicy, T.Steering)):
        pol = cls(spec(bimodality=True), n_instances=4, n_points=2,
                  n_windows=4, tau_leap=False)
        actions = pol.decide(2, None, hist, np.zeros(4, np.int32), z, z)
        assert not actions.any
        assert pol.bimodal_flags == [{"window": 2, "point": 1, "obs": 0}]
        assert pol.report()["bimodal_flags"] == pol.bimodal_flags
        pols.append(pol)
    ja, ta = (p.state_dict() for p in pols)
    assert sorted(ja) == sorted(ta)
    for k in ja:
        assert np.asarray(ja[k]).dtype == np.asarray(ta[k]).dtype, k
        assert np.asarray(ja[k]).tobytes() == np.asarray(ta[k]).tobytes(), k
    assert pols[0].report() == pols[1].report()


@pytest.mark.parametrize("n_donors", [1, 7, 300])
def test_policy_decisions_match_reference(n_donors):
    """Policy level, both packages on the same inputs: three points
    stop at once among shuffled, uneven groups and their lanes move to
    the worst live point (the port's reallocation is vectorised; the
    pairs and their order are the reference's loop's), with tau-switch
    pins from random step and leap counters over two decision points;
    actions, state dicts and reports equal."""
    rng = np.random.default_rng(n_donors)
    n_points = 6
    sizes = np.array([40, 3, n_donors, 1, 25, 90])
    gids = rng.permutation(np.repeat(np.arange(n_points, dtype=np.int32),
                                     sizes))
    n = len(gids)
    rel = np.array([0.01, 0.2, 0.5, 0.02, 0.3, 0.015])
    stats = {"mean": np.full((n_points, 2), 50.0),
             "ci90": np.stack([rel * 50.0, rel * 40.0], axis=1)}
    steps = rng.integers(0, 600, n).astype(np.int64)
    leaps = (steps * rng.uniform(0, 0.3, n)).astype(np.int64)
    out = []
    for cls, spec in ((JPolicy, J.Steering), (TPolicy, T.Steering)):
        pol = cls(spec(ci_rel_tol=0.05, min_windows=2, reallocate=True,
                       tau_switch=True), n_instances=n, n_points=n_points,
                  n_windows=8, tau_leap=True)
        first = pol.decide(2, stats, None, gids, steps, leaps)
        second = pol.decide(4, stats, None, gids, 2 * steps, leaps)
        out.append((first, second, pol))
    (jf, js_, jp), (tf, ts_, tp) = out
    for a, b in ((jf, tf), (js_, ts_)):
        assert a.stop_lanes.tobytes() == b.stop_lanes.tobytes()
        assert a.moves.dtype == b.moves.dtype == np.int32
        assert a.moves.tobytes() == b.moves.tobytes()
        assert (a.new_group_ids is None) == (b.new_group_ids is None)
        if a.new_group_ids is not None:
            assert a.new_group_ids.tobytes() == b.new_group_ids.tobytes()
        assert (a.no_leap is None) == (b.no_leap is None)
        if a.no_leap is not None:
            assert a.no_leap.tobytes() == b.no_leap.tobytes()
    assert len(jf.moves) == 40 + 1 + 90 - 3  # points 0, 3 and 5 stop
    assert jp.report() == tp.report()
    ja, ta = jp.state_dict(), tp.state_dict()
    for k in ja:
        assert np.asarray(ja[k]).tobytes() == np.asarray(ta[k]).tobytes(), k


# ------------------------------------- pipeline depth and refusals
def test_steering_forces_pipeline_depth_auto_to_one():
    res = run(_exp(T, STOP, pipeline_depth="auto"))
    assert res.telemetry.pipeline_depth_effective == 1
    assert res.telemetry.pipeline_depth == 1
    assert res._engine.depth_probe is None  # resolved without a probe
    _, stop = both("stop", STOP)
    assert rec_tuple(res.records) == rec_tuple(stop.records)
    free = run(_exp(T, pipeline_depth="auto"))
    assert free.telemetry.pipeline_depth_effective >= 1
    assert free._engine.depth_probe is not None


@pytest.mark.parametrize("steering,kw,match", [
    (STOP, dict(pipeline_depth=2), "pipeline_depth"),
    (STOP, dict(host_loop=True, window_block=1), "host_loop"),
    (dict(bimodality=True), {}, "SketchSpec|sketch"),
    (dict(tau_switch=True), {}, "tau_switch"),
    (dict(reallocate=True), {}, "reallocate"),
], ids=["depth2", "host_loop", "bimodality", "tau_switch", "reallocate"])
def test_steering_conflicts_refused_as_in_reference(steering, kw, match):
    """An explicit pipeline_depth > 1, host_loop, bimodality without a
    sketch, tau_switch without tau-leaping and reallocation without
    early stopping: refused by both packages, naming the field."""
    for api in (J, T):
        with pytest.raises(api.ExperimentError, match=match):
            run(_exp(api, steering, **kw))


# --------------------------------------------------- crash drill
DRILL = dict(steering=REALLOC, sketch=dict(n_bins=16, hi=64.0))


def _drill(path, exp=None, crash_at=(2, 6)):
    """Run the steered experiment (the scaled drill's by default) block
    by block, checkpointing after each collected block; at each window
    of `crash_at` drop the engine, build a new one and restore the file
    (the reference drill's schedule: once before the first decision,
    once after lanes were stopped and moved)."""
    exp = exp if exp is not None else _exp(T, **DRILL)
    eng = T.build_engine(exp, device="cpu")
    eng.checkpoint(path)
    crashed = set()
    while eng._window < len(eng.grid):
        w = eng._window
        if w in crash_at and w not in crashed:
            crashed.add(w)
            eng = T.build_engine(exp, device="cpu")
            eng.restore(path)
            continue
        if eng.run_block():
            eng.checkpoint(path)
    assert crashed == set(crash_at)
    return eng


def test_steered_crash_drill_replays_decisions_bitwise(tmp_path):
    """The recovery contract: the restored run's report, records and
    sketches equal the port's uninterrupted run's bit for bit, and the
    reference's (records within the ulp bound). Both points stop, as
    in the reference drill's own run: point 1 at window 4, then point
    0, 2 x 640 - 1 replicas strong after the move, at window 6."""
    eng = _drill(str(tmp_path / "drill"))
    ref, clean = both("drill", **DRILL)
    rep = clean.steering_report()
    assert rep["stopped_points"] == [0, 1]
    assert rep["stop_windows"] == {0: 6, 1: 4}
    assert eng.steering_report() == rep
    assert rec_tuple(eng.stream.records()) == rec_tuple(clean.records)
    assert len(eng.sketches()) == len(clean.sketches()) == N_WINDOWS
    for a, b, c in zip(eng.sketches(), clean.sketches(), ref.sketches()):
        assert a.hist.tobytes() == b.hist.tobytes() == c.hist.tobytes()
    assert (eng._pool.x == clean._engine._pool.x).all()
    assert_like_reference(ref, clean)
    assert print_margins(clean) > 1e-3


# --------------------------------- the apply: snapshots and syncs
def test_steered_boundary_writes_no_pool_leaf_in_place():
    """A ring snapshot (the pool held by reference at a block's entry)
    is unchanged after the decision point stops, moves and regroups
    lanes: the apply builds fresh tensors."""
    eng = T.build_engine(_exp(T, REALLOC), device="cpu")
    eng.enable_snapshots()
    limit = len(eng.grid)
    eng.run_block()  # block 0, its boundary before min_windows
    eng._dispatch_block(limit)  # block 1 (windows 2-3), entry snapshot
    held, = eng._pending[0].snapshot  # the one shard's pool
    copies = [a.clone() for a in held]
    eng._collect_block()
    before = eng._pool
    before_copies = [a.clone() for a in before]
    eng._steer_boundary()
    assert eng._steer.decisions  # point 1 stopped, its lanes moved
    for a, b in zip(held, copies):
        assert torch.equal(a, b)
    for a, b in zip(before, before_copies):
        assert torch.equal(a, b)
    assert not torch.equal(eng._pool.dead, before.dead)
    assert eng._pool.x is not before.x


def test_decision_points_add_no_host_sync():
    """One host sync per block (the ring's wait) with or without a
    decision at its boundary; the reference pays one more at each
    decision point (its counter pull: windows 2, 4, 6) and one for each
    applied decision (its pool pull: windows 4 and 6)."""
    ref, res = both("realloc", REALLOC)
    n_blocks = N_WINDOWS // 2
    assert res.telemetry.host_syncs == res.telemetry.dispatches == n_blocks
    assert ref.telemetry.host_syncs == n_blocks + 3 + 2
