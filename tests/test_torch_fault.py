"""Fault drills for the port's supervisor (`Experiment(recovery=...)`):
the counterpart of tests/test_fault.py, case for case.

The recovery contract: any injected fault sequence — crashes, corrupt
checkpoints, device loss, stalls, NaN-poisoned pools — gives records,
sketches and steering decision logs bitwise equal to the uninterrupted
run's. Trajectories are a pure function of (seed, counter-RNG state),
and checkpoints carry the pool, its counters and the emitted records,
so recovery replays rather than approximates. The drilled port runs are
also held against the reference's clean runs (means bit for bit), and
the typed surface (errors, FailurePlan's seeded schedule) against the
reference's.

The sharded drills (device loss degrading 4 -> 2 -> 1 shards) run in
process, every shard on the CPU. The port runs its kernel path (the
plain twin here) unless a case says otherwise; lv2's 16 replicas run to
t = 0.05 (the reference's tests: 1.0), since the CPU twin pays each SSA
step in Python-level torch ops.
"""
import dataclasses
import os

import numpy as np
import pytest

import repro.api as J
import repro_torch.api as T
from repro.core.cwc.models import MODELS as J_MODELS
from repro.runtime import fault as j_fault
from repro.runtime import straggler as j_straggler
from repro_torch.api.run import build_engine
from repro_torch.ckpt import store
from repro_torch.core.cwc.models import MODELS as T_MODELS
from repro_torch.runtime.fault import (
    FAULT_KINDS,
    EngineCrash,
    FailureInjector,
    FailurePlan,
    InvariantViolation,
    RecoverableError,
    run_sim_with_failures,
)
from repro_torch.runtime import fault as t_fault
from repro_torch.runtime import straggler as t_straggler
from repro_torch.runtime.supervisor import RunSupervisor

N_WINDOWS = 8
T_END = 0.05


def make_exp(api=T, use_kernel=None, **kw):
    """tests/test_fault.py's experiment (lv2, 16 replicas, 8 windows,
    seed 7, trajectories recorded) at t_end 0.05; the reference runs its
    jitted unfused path."""
    kw.setdefault("record_trajectories", True)
    models = T_MODELS if api is T else J_MODELS
    return api.Experiment(
        model=models["lv2"](),
        ensemble=api.Ensemble.make(replicas=16),
        schedule=api.Schedule(t_end=T_END, n_windows=N_WINDOWS,
                              schema="iii"),
        reduction=api.Reduction.ENSEMBLE,
        n_lanes=8, seed=7,
        use_kernel=(api is T) if use_kernel is None else use_kernel, **kw)


def run(exp, **kw):
    if isinstance(exp, T.Experiment):
        kw.setdefault("device", "cpu")
        return T.simulate(exp, **kw)
    return J.simulate(exp, **kw)


def recovery(tmp_path, schedule, **kw):
    kw.setdefault("cadence", 2)
    kw.setdefault("keep_last", 2)
    return T.Recovery(ckpt_dir=str(tmp_path / "rec"),
                      inject=FailurePlan(schedule=schedule), **kw)


def assert_bitwise(a, b, ctx=""):
    assert len(a.records) == len(b.records), ctx
    for ra, rb in zip(a.records, b.records):
        assert (ra.t, ra.window, ra.n) == (rb.t, rb.window, rb.n), ctx
        for f in ("mean", "var", "ci90"):
            assert getattr(ra, f).tobytes() == getattr(rb, f).tobytes(), \
                (ctx, f)


@pytest.fixture(scope="module")
def reference_clean():
    """The reference's uninterrupted runs, exact and tau."""
    return {m: run(make_exp(J, method=m)) for m in ("exact", "tau_leap")}


# ----------------------------------------------------------- the bar
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("method", ["exact", "tau_leap"])
@pytest.mark.parametrize("window_block", [1, 4])
def test_drill_matrix_records_bitwise(tmp_path, reference_clean, use_kernel,
                                      method, window_block):
    """Crash and corrupt-newest-checkpoint drills across the execution
    matrix: records equal to the uninterrupted run's bit for bit, and
    means equal to the reference's clean run's."""
    kw = dict(use_kernel=use_kernel, method=method,
              window_block=window_block)
    base = run(make_exp(**kw))
    got = run(make_exp(recovery=recovery(
        tmp_path, {2: "crash", 5: "ckpt_corrupt"}), **kw))
    ctx = (use_kernel, method, window_block)
    assert_bitwise(base, got, ctx)
    assert got.recovery_report()["restarts"] == 2
    assert got.telemetry.restarts == 2
    assert (base.trajectories() == got.trajectories()).all()
    ref = reference_clean[method]
    assert np.stack([r.mean for r in got.records]).tobytes() \
        == np.stack([r.mean for r in ref.records]).tobytes(), ctx


def test_drill_sparse_engine_bitwise(tmp_path):
    base = run(make_exp(sparse=True))
    got = run(make_exp(sparse=True,
                       recovery=recovery(tmp_path, {3: "crash"})))
    assert_bitwise(base, got)


def test_drill_sketches_bitwise(tmp_path):
    sk = T.SketchSpec(n_bins=8, lo=0.0, hi=1200.0)
    base = run(make_exp(window_block=4, sketch=sk))
    got = run(make_exp(window_block=4, sketch=sk,
                       recovery=recovery(tmp_path, {2: "crash", 5: "stall"})))
    assert_bitwise(base, got)
    assert len(got.sketches()) == N_WINDOWS
    for sa, sb in zip(base.sketches(), got.sketches()):
        assert (sa.hist == sb.hist).all()
    assert got.recovery_report()["stall_redispatches"] == 1


def test_drill_steering_decision_log_bitwise(tmp_path):
    st = T.Steering(ci_rel_tol=0.03, min_windows=4)
    base = run(make_exp(steering=st))
    got = run(make_exp(steering=st, recovery=recovery(
        tmp_path, {3: "crash", 6: "crash"})))
    assert_bitwise(base, got)
    assert base.steering_report()["decisions"], "nothing was decided"
    assert base.steering_report()["decisions"] \
        == got.steering_report()["decisions"]


def test_nan_pool_caught_by_engine_guard_and_recovered(tmp_path):
    """The injector poisons the pool without raising; the engine's own
    guard must turn it into a typed recoverable fault."""
    base = run(make_exp())
    got = run(make_exp(recovery=recovery(tmp_path, {4: "nan_pool"})))
    assert_bitwise(base, got)
    rep = got.recovery_report()
    assert rep["faults_by_kind"].get("nan_pool", 0) >= 1


# ------------------------------------------------- checkpoint hygiene
def test_retention_keeps_last_k(tmp_path):
    res = run(make_exp(recovery=recovery(tmp_path, {}, cadence=1,
                                         keep_last=3)))
    cks = store.list_checkpoints(str(tmp_path / "rec"))
    assert [w for w, _ in cks] == [6, 7, 8]
    assert res.recovery_report()["restarts"] == 0


def test_fallback_past_corrupt_checkpoint(tmp_path):
    """ckpt_corrupt truncates the NEWEST file then crashes; recovery
    falls back to the older one and still replays bitwise."""
    base = run(make_exp())
    got = run(make_exp(recovery=recovery(tmp_path, {5: "ckpt_corrupt"})))
    assert_bitwise(base, got)
    skipped = [e for e in got.recovery_report()["events"]
               if e["event"] == "corrupt_checkpoint_skipped"]
    assert skipped, "expected the corrupt newest checkpoint to be skipped"


def test_verify_rejects_truncated_and_garbage(tmp_path):
    p = str(tmp_path / "c.npz")
    store.save_atomic(p, {"x": np.arange(4.0)})
    store.verify(p, required=("x",))  # round-trips clean
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    with pytest.raises(store.CheckpointCorrupt) as ei:
        store.verify(p)
    assert p in str(ei.value)
    g = str(tmp_path / "g.npz")
    with open(g, "wb") as f:
        f.write(b"not a zipfile at all")
    with pytest.raises(store.CheckpointCorrupt, match="unreadable"):
        store.verify(g)


def test_verify_rejects_bitflip_and_missing_key(tmp_path):
    p = str(tmp_path / "c.npz")
    store.save_atomic(p, {"x": np.zeros(64, np.float32)})
    with pytest.raises(store.CheckpointCorrupt, match="missing"):
        store.verify(p, required=("x", "nope"))
    size = os.path.getsize(p)
    with open(p, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\xff\xff")
    with pytest.raises(store.CheckpointCorrupt):
        store.verify(p)


def test_save_atomic_leaves_no_tmp_and_is_loadable(tmp_path):
    p = str(tmp_path / "c.npz")
    store.save_atomic(p, {"a": np.arange(3), "b": np.eye(2)})
    assert os.listdir(tmp_path) == ["c.npz"]
    z = store.verify(p, required=("a", "b"))
    assert (z["a"] == np.arange(3)).all()


# ----------------------------------------------------- typed surface
def test_failure_plan_materialize_deterministic():
    p = FailurePlan(schedule={2: "crash"}, seed=3, random_rate=0.5,
                    random_kind="stall")
    a, b = p.materialize(20), p.materialize(20)
    assert a == b
    assert a[2] == "crash"  # explicit entries win over random draws
    assert any(k == "stall" for w, k in a.items() if w != 2)
    assert p.materialize(20) != FailurePlan(
        schedule={2: "crash"}, seed=4, random_rate=0.5,
        random_kind="stall").materialize(20)


@pytest.mark.parametrize("seed", [0, 3, 11, 2024])
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_failure_plan_schedule_equals_reference(seed, rate):
    """The seeded layer draws the reference's schedule for the same
    seed, rate and window count, explicit entries included."""
    kw = dict(schedule={1: "device_lost"}, seed=seed, random_rate=rate,
              random_kind="stall")
    for n in (8, 50):
        assert FailurePlan(**kw).materialize(n) \
            == j_fault.FailurePlan(**kw).materialize(n)


def test_failure_plan_validates_kinds():
    with pytest.raises(ValueError):
        FailurePlan(schedule={1: "meteor"})
    with pytest.raises(ValueError):
        FailurePlan(random_rate=2.0)
    for k in FAULT_KINDS:
        FailurePlan(schedule={0: k})  # all documented kinds accepted
    assert FAULT_KINDS == j_fault.FAULT_KINDS


def test_injector_is_one_shot_per_window():
    inj = FailureInjector(FailurePlan(schedule={3: "crash"}))
    assert inj.maybe_fail(3) == "crash"
    assert inj.maybe_fail(3) is None  # replay after restart: no refire


def test_stall_does_not_consume_restart_budget(tmp_path):
    """A stalled window is re-dispatched in place: no restart, no
    backoff, nothing taken from max_restarts."""
    base = run(make_exp())
    got = run(make_exp(
        recovery=recovery(tmp_path, {2: "stall"}, max_restarts=0)))
    assert_bitwise(base, got)
    rep = got.recovery_report()
    assert rep["restarts"] == 0
    assert rep["stall_redispatches"] == 1
    assert got.telemetry.stall_redispatches == 1
    stall_events = [e for e in rep["events"]
                    if e["event"] == "fault" and e["kind"] == "stall"]
    assert len(stall_events) == 1
    assert stall_events[0]["stall_redispatch"] == 1


def test_max_restarts_declares_run_dead(tmp_path):
    plan = {w: "crash" for w in range(N_WINDOWS)}
    with pytest.raises(RuntimeError, match="declared dead"):
        run(make_exp(recovery=recovery(tmp_path, plan, max_restarts=2)))


@pytest.mark.parametrize("kw", [dict(max_windows=2),
                                dict(checkpoint_path="ck"),
                                dict(resume=True)])
def test_recovery_rejects_conflicting_simulate_args(tmp_path, kw):
    exp = make_exp(recovery=T.Recovery(ckpt_dir=str(tmp_path / "rec")))
    with pytest.raises(T.ExperimentError, match="owns checkpointing"):
        run(exp, **kw)


@pytest.mark.parametrize("bad,match", [
    (dict(cadence=0), "cadence"), (dict(keep_last=0), "keep_last"),
    (dict(max_restarts=-1), "max_restarts"),
    (dict(backoff_base_s=-1.0), "backoff"),
    (dict(inject={2: "crash"}), "FailurePlan"),
    (dict(namespace="bad_name"), "namespace")])
def test_recovery_validation_matches_reference(tmp_path, bad, match):
    """Recovery's checks and messages are the reference's."""
    msgs = []
    for cls in (J.Recovery, T.Recovery):
        with pytest.raises(ValueError, match=match) as e:
            cls(ckpt_dir=str(tmp_path), **bad).validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(T.ExperimentError, match=match):
        run(make_exp(recovery=T.Recovery(ckpt_dir=str(tmp_path), **bad)))


def test_engine_guard_raises_typed_invariant(tmp_path):
    """Direct guard drill: NaN-poison the pool mid-run and step — the
    engine raises InvariantViolation naming the check; with guards off
    the same poison sails through."""
    eng = build_engine(make_exp(), device="cpu")
    eng.run_window()
    RunSupervisor._poison_pool(eng)
    with pytest.raises(InvariantViolation, match="non_finite_stats"):
        eng.run_window()
    eng2 = build_engine(make_exp(), device="cpu")
    eng2.cfg = dataclasses.replace(eng2.cfg, guards=False)
    eng2.run_window()
    RunSupervisor._poison_pool(eng2)
    eng2.run_window()  # no guard, no raise


def test_recoverable_errors_are_typed():
    e = EngineCrash("boom", window=5)
    assert e.kind == "crash" and e.window == 5
    assert isinstance(e, Exception)


@pytest.mark.parametrize("name,extra", [
    ("EngineCrash", {}), ("DeviceLost", {"n_lost": 2}), ("EngineStall", {}),
    ("HostLost", {"worker": 3}), ("WorkerStall", {"worker": 1}),
    ("InvariantViolation", {"check": "negative_mean"})])
def test_typed_errors_match_reference(name, extra):
    """Every typed fault carries the reference's kind, base class and
    attributes."""
    t_err = getattr(t_fault, name)("boom", window=7, **extra)
    j_err = getattr(j_fault, name)("boom", window=7, **extra)
    assert isinstance(t_err, RecoverableError)
    assert (t_err.kind, t_err.window, str(t_err)) \
        == (j_err.kind, j_err.window, str(j_err))
    for attr, value in extra.items():
        assert getattr(t_err, attr) == getattr(j_err, attr) == value
    assert t_fault.FAULT_KINDS == j_fault.FAULT_KINDS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watchdogs_flag_as_reference(seed):
    """Both watchdogs flag the reference's windows and workers, with the
    same medians, on a seeded run of walls (a few spikes) and of worker
    frontiers (one slow worker, one retired)."""
    rng = np.random.default_rng(seed)
    tw, jw = t_straggler.WindowWatchdog(), j_straggler.WindowWatchdog()
    for w in range(80):
        wall = float(rng.uniform(0.01, 0.02) * (5 if rng.random() < 0.1
                                                 else 1))
        if w % 3:
            assert tw.observe(w, wall) == jw.observe(w, wall)
        else:
            n = int(rng.integers(1, 5))
            assert tw.observe_block(w, n, wall * n) \
                == jw.observe_block(w, n, wall * n)
    assert tw.flagged == jw.flagged and tw.flagged
    assert tw.straggler_rate() == jw.straggler_rate()
    tf = t_straggler.FrontierWatchdog(grace_windows=3)
    jf = j_straggler.FrontierWatchdog(grace_windows=3)
    front = np.zeros(5, np.int64)
    for step in range(60):
        k = int(rng.integers(0, 5))
        front[k] += 1 if k == 4 else int(rng.integers(1, 4))
        assert tf.observe(k, int(front[k])) == jf.observe(k, int(front[k]))
        if step == 40:
            tf.forget(2)
            jf.forget(2)
    assert tf.flagged == jf.flagged and tf.flagged
    assert tf.straggler_rate() == jf.straggler_rate()


def test_invariant_violation_is_the_reference_recoverable_kind():
    """The repaired type: the engine's guard raises a RecoverableError
    of kind "nan_pool" carrying .window and .check, like the
    reference's (a RuntimeError of its own, the supervisor could not
    catch it by type); `core.engine.InvariantViolation` is the same
    class."""
    from repro_torch.core.engine import InvariantViolation as EngineIV

    assert EngineIV is InvariantViolation
    eng = build_engine(make_exp(), device="cpu")
    eng.run_window()
    RunSupervisor._poison_pool(eng)
    with pytest.raises(RecoverableError) as ei:
        eng.run_window()
    e = ei.value
    assert isinstance(e, InvariantViolation)
    assert e.kind == j_fault.InvariantViolation.kind == "nan_pool"
    assert (e.window, e.check) == (1, "non_finite_stats")
    assert [c.__name__ for c in type(e).__mro__[:3]] == [
        c.__name__ for c in j_fault.InvariantViolation.__mro__[:3]]


def test_run_sim_with_failures_drill(tmp_path):
    """The minimal window-by-window drill of runtime.fault."""
    base = run(make_exp())

    def make_engine():
        return build_engine(make_exp(), device="cpu")

    recs, events = run_sim_with_failures(
        make_engine, str(tmp_path / "ck"),
        FailurePlan(schedule={1: "crash", 4: "crash"}), ckpt_every=2)
    assert events == [(1, "crash"), (4, "crash")]
    for a, b in zip(base.records, recs):
        assert a.mean.tobytes() == b.mean.tobytes()
        assert a.var.tobytes() == b.var.tobytes()


# --------------------------------------------------- sharded drills
def test_shard_loss_degrades_and_stays_bitwise(tmp_path):
    """Two device-loss faults on a 4-shard farm: the supervisor degrades
    4 -> 2 -> 1 shards (stat_blocks pinned), rebuilding on the first d
    entries of the device list, and the records match the clean 4-shard
    run bitwise."""
    part = T.Partitioning(n_shards=4, stat_blocks=4)
    base = run(make_exp(partitioning=part))
    got = run(make_exp(partitioning=part, recovery=recovery(
        tmp_path, {3: "device_lost", 6: "device_lost"})),
        device=["cpu"] * 4)
    assert_bitwise(base, got)
    rep = got.recovery_report()
    assert rep["restarts"] == 2
    assert rep["final_n_shards"] == 1
    shrinks = [(e["from_shards"], e["to_shards"])
               for e in rep["events"] if e["event"] == "degraded"]
    assert shrinks == [(4, 2), (2, 1)]
    assert len(got._engine.devices) == 1


def test_sharded_crash_drill_with_window_block(tmp_path):
    part = T.Partitioning(n_shards=4, stat_blocks=4)
    base = run(make_exp(partitioning=part, window_block=4))
    got = run(make_exp(partitioning=part, window_block=4, recovery=recovery(
        tmp_path, {5: "crash"}, cadence=4)))
    assert_bitwise(base, got)
    assert got.recovery_report()["restarts"] == 1
