"""Supersteps, the depth-K collector and the host-loop dispatch in the
port (`SimConfig.window_block`, `pipeline_depth`, `host_loop`): the
counterpart of tests/test_superstep.py, case for case.

The contract: queueing W windows as one dispatch, with the record ring
pulled per block by the pipelined collector, changes the dispatch/sync
profile and nothing else. Records, grouped per-point statistics,
trajectories and per-window step/leap telemetry are bitwise identical
for any window_block and pipeline_depth, on the unfused and the kernel
(plain twin) paths, dense and sparse, exact and tau; checkpoint/resume
works at block boundaries. The port's per-window runs are also held
against the reference's (means bitwise, var/ci90 to the ulp bound of
test_torch_reduction), whose own tests pin its W and K invariance.
"""
import os

import numpy as np
import pytest
import torch

import repro.api as J
import repro_torch.api as T
from repro.core.cwc.models import MODELS as J_MODELS
from repro_torch.api.result import SimulationResult
from repro_torch.core.cwc.models import MODELS as T_MODELS
from repro_torch.core.engine import (
    AUTO_DEPTH_MAX,
    AUTO_DEPTH_MIN,
    SimConfig,
    resolve_auto_depth,
)
from repro_torch.kernels.ops import FusedWindowTruncated

N_WINDOWS = 8
VAR_ULP = 12
CI90_ULP = 8


def make_exp(api=T, window_block=1, n_windows=N_WINDOWS, schema="iii",
             policy="on_demand", replicas=16, sweep=None, use_kernel=None,
             **kw):
    """The experiment of the tests; the port runs the kernel path (its
    plain twin here) unless use_kernel=False, the reference its jitted
    unfused path (its Pallas kernel would run in interpret mode)."""
    models = T_MODELS if api is T else J_MODELS
    if use_kernel is None:
        use_kernel = api is T
    return api.Experiment(
        model=models["lv2"](),
        ensemble=api.Ensemble.make(replicas=replicas, sweep=sweep),
        schedule=api.Schedule(t_end=0.05, n_windows=n_windows,
                              schema=schema, policy=policy),
        n_lanes=8, seed=7, window_block=window_block, use_kernel=use_kernel,
        **kw)


def run(exp, **kw):
    if isinstance(exp, T.Experiment):
        kw.setdefault("device", "cpu")
        return T.simulate(exp, **kw)
    return J.simulate(exp, **kw)


def ulp(a, b) -> int:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def assert_records_bitwise(a, b, ctx=""):
    assert len(a.records) == len(b.records), ctx
    for ra, rb in zip(a.records, b.records):
        assert (ra.t, ra.window, ra.n) == (rb.t, rb.window, rb.n), ctx
        for f in ("mean", "var", "ci90"):
            assert getattr(ra, f).tobytes() == getattr(rb, f).tobytes(), \
                (ctx, f)


def assert_bitwise(a, b, ctx=""):
    assert_records_bitwise(a, b, ctx)
    ta, tb = a.telemetry, b.telemetry
    assert ta.steps_per_window == tb.steps_per_window, ctx
    assert ta.leaps_per_window == tb.leaps_per_window, ctx


def assert_matches_reference(j, t, ctx=""):
    """The port's records against the reference's: means bitwise (sums
    of integer populations), var/ci90 within the ulp bound."""
    assert len(j.records) == len(t.records), ctx
    for a, b in zip(j.records, t.records):
        assert (a.t, a.window, a.n) == (b.t, b.window, b.n), ctx
        assert a.mean.tobytes() == b.mean.tobytes(), ctx
        assert ulp(a.var, b.var) <= VAR_ULP, ctx
        assert ulp(a.ci90, b.ci90) <= CI90_ULP, ctx
    assert j.telemetry.steps_per_window == t.telemetry.steps_per_window, ctx


_REF = {}


def reference(**kw):
    """The reference's per-window run of make_exp(**kw), cached."""
    key = tuple(sorted((k, str(v)) for k, v in kw.items()))
    if key not in _REF:
        _REF[key] = run(make_exp(J, **kw))
    return _REF[key]


_BASE = {}


def port_base(**kw):
    """The port's per-window run of make_exp(**kw), cached."""
    kw.setdefault("use_kernel", True)
    key = tuple(sorted((k, str(v)) for k, v in kw.items()))
    if key not in _BASE:
        _BASE[key] = run(make_exp(**kw))
    return _BASE[key]


# ------------------------------------------------------------- parity
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("method", ["exact", "tau_leap"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_records_bitwise_invariant_to_window_block(use_kernel, method,
                                                   sparse):
    """(window_block, pipeline_depth) in {(2, 1), (4, 2)} x unfused/twin
    x exact/tau x dense/sparse: bit-identical records and telemetry;
    window_block=1 is the per-window path, held against the
    reference's."""
    kw = dict(use_kernel=use_kernel, method=method, sparse=sparse)
    base = port_base(**kw)
    assert_matches_reference(reference(method=method), base, ctx=kw)
    for wb, depth in ((2, 1), (4, 2)):
        got = run(make_exp(window_block=wb, pipeline_depth=depth, **kw))
        assert_bitwise(base, got, ctx=(wb, depth, kw))
        assert (got.final_state() == base.final_state()).all()
        t = got.telemetry
        assert t.dispatches == t.host_syncs == N_WINDOWS // wb


def test_non_dividing_window_block_runs_short_final_block():
    got = run(make_exp(window_block=3))
    assert_bitwise(port_base(), got)
    assert got.windows_run == N_WINDOWS
    assert got.telemetry.dispatches == 3  # ceil(8 / 3)
    assert [b[:2] for b in got.telemetry.block_walls] == [
        (0, 3), (3, 3), (6, 2)]


def test_window_block_wider_than_grid_is_one_dispatch():
    got = run(make_exp(window_block=64))
    assert_bitwise(port_base(), got)
    assert got.telemetry.dispatches == 1
    assert got.telemetry.host_syncs == 1


def test_grouped_per_point_stats_invariant_to_window_block():
    """PER_POINT rides the same block pull (one sync per block) and
    stays bitwise, and the per-window path matches the reference's."""
    kw = dict(replicas=8, sweep={"die": [0.3, 1.2]},
              reduction=T.Reduction.PER_POINT)
    base = port_base(**kw)
    got = run(make_exp(window_block=4, **kw))
    assert got.telemetry.host_syncs == 2
    pb, pg = base.per_point(), got.per_point()
    for k in ("n", "mean", "var", "ci90"):
        assert pb[k].tobytes() == pg[k].tobytes(), k
    jp = reference(replicas=8, sweep={"die": [0.3, 1.2]},
                   reduction=J.Reduction.PER_POINT).per_point()
    assert jp["mean"].tobytes() == pb["mean"].tobytes()
    assert (jp["n"] == pb["n"]).all()


@pytest.mark.parametrize("schema", ["i", "ii"])
def test_buffering_schemas_keep_trajectories_bitwise(schema):
    base = port_base(schema=schema)
    got = run(make_exp(window_block=4, schema=schema))
    assert got.trajectories().shape == (16, N_WINDOWS, 2)
    assert (base.trajectories() == got.trajectories()).all()
    assert (reference(schema=schema).trajectories()
            == base.trajectories()).all()
    assert_bitwise(base, got)
    assert got.telemetry.host_syncs == 2  # the samples ride the pull


def test_record_trajectories_under_schema_iii():
    base = port_base(record_trajectories=True)
    got = run(make_exp(window_block=4, record_trajectories=True))
    assert (base.trajectories() == got.trajectories()).all()


def test_predictive_policy_composes_with_supersteps():
    """Predictive EMA costs update per window at collect time, so the
    cost state matches the per-window path's (and the reference's) at
    every block boundary; regrouping at block cadence never changes a
    trajectory."""
    base = port_base(policy="predictive")
    got = run(make_exp(window_block=4, policy="predictive"))
    assert_bitwise(base, got)
    ref = reference(policy="predictive")
    assert_matches_reference(ref, base)
    for res in (base, got):
        assert np.array_equal(ref._engine.scheduler._cost,
                              res._engine.scheduler._cost)


# ------------------------------------------------- depth-K pipelining
@pytest.mark.parametrize("depth", [2, 4, "auto"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_depth_k_records_bitwise(depth, use_kernel):
    """pipeline_depth only changes WHEN the oldest ring is collected,
    never what was dispatched: records, telemetry and trajectories are
    bitwise identical to the per-window path for any K, including the
    probed one."""
    base = port_base(use_kernel=use_kernel, record_trajectories=True)
    got = run(make_exp(window_block=2, use_kernel=use_kernel,
                       pipeline_depth=depth, record_trajectories=True))
    assert_bitwise(base, got, ctx=(depth, use_kernel))
    assert (base.trajectories() == got.trajectories()).all()
    t = got.telemetry
    if depth == "auto":
        probe = got._engine.depth_probe
        assert probe is not None and probe["depth"] == t.pipeline_depth
        assert AUTO_DEPTH_MIN <= t.pipeline_depth <= AUTO_DEPTH_MAX
    else:
        assert t.pipeline_depth == depth
    assert t.pipeline_depth_effective == t.pipeline_depth
    # pending holds up to depth+1 rings transiently (dispatch K+1
    # happens before the oldest pull), capped by the 4 total blocks
    assert t.peak_inflight_blocks >= min(t.pipeline_depth, 3)
    assert t.peak_inflight_blocks <= min(t.pipeline_depth + 1, 4)


def test_pipeline_depth_bounds_inflight_rings():
    """At depth K the collector lets K blocks queue before blocking on
    the oldest; run_block dispatches first, so pending peaks at K+1."""
    eng = T.build_engine(make_exp(window_block=2, n_windows=16,
                                  pipeline_depth=3), device="cpu")
    for expect_pending, expect_window in [(1, 0), (2, 0), (3, 0), (3, 2)]:
        eng.run_block()
        assert len(eng._pending) == expect_pending
        assert eng._window == expect_window
    eng.flush()
    assert not eng._pending and eng._window == 8
    assert eng.peak_inflight_blocks == 4


def test_pipeline_depth_validation():
    with pytest.raises(T.ExperimentError, match="pipeline_depth"):
        make_exp(window_block=2, pipeline_depth=0).validate()
    with pytest.raises(T.ExperimentError, match="pipeline_depth"):
        make_exp(window_block=2, pipeline_depth="deep").validate()
    with pytest.raises(ValueError, match="pipeline_depth"):
        SimConfig(window_block=2, pipeline_depth=0)
    with pytest.raises(ValueError, match="pipeline_depth"):
        SimConfig(window_block=2, pipeline_depth="never")
    SimConfig(window_block=2, pipeline_depth="auto")


def test_auto_depth_resolution_rule():
    from repro.core import engine as j_engine

    cases = [(1.0, 0.5), (1.0, 2.5), (1.0, 100.0), (0.0, 1.0), (2e-3, 7e-3)]
    assert [resolve_auto_depth(*c) for c in cases] == [2, 4, AUTO_DEPTH_MAX,
                                                       AUTO_DEPTH_MIN, 5]
    assert [resolve_auto_depth(*c) for c in cases] == [
        j_engine.resolve_auto_depth(*c) for c in cases]
    assert (AUTO_DEPTH_MIN, AUTO_DEPTH_MAX) == (
        j_engine.AUTO_DEPTH_MIN, j_engine.AUTO_DEPTH_MAX)


def test_held_snapshot_is_unchanged_by_later_blocks():
    """A ring snapshot holds the entry pool's tensors by reference, with
    no copy: no later block may write into them."""
    eng = T.build_engine(make_exp(window_block=2, pipeline_depth=3,
                                  use_kernel=True), device="cpu")
    eng.enable_snapshots()
    entry = eng._pool
    eng.run_block()
    snap, = eng._pending[0].snapshot  # the one shard's pool
    assert snap is entry  # held by reference, not copied
    before = [a.clone() for a in snap]
    eng.run_block()
    eng.run_block()
    assert eng._dispatched == 6
    assert not torch.equal(eng._pool.x, snap.x)  # the pool moved on
    for a, b in zip(before, snap):
        assert torch.equal(a, b)
    eng.flush()


# -------------------------------------------------- checkpoint/resume
def test_checkpoint_resume_at_block_boundary_is_bitwise(tmp_path):
    ck = str(tmp_path / "ck")
    clean = run(make_exp(window_block=4))
    run(make_exp(window_block=4), max_windows=4, checkpoint_path=ck)
    assert int(np.load(ck + ".npz")["window"]) == 4
    resumed = run(make_exp(window_block=4), checkpoint_path=ck, resume=True)
    assert_records_bitwise(clean, resumed)
    assert (clean.final_state() == resumed.final_state()).all()


def test_checkpoint_resumes_across_window_block_values(tmp_path):
    """A block-boundary checkpoint is a window-boundary checkpoint: any
    window_block dividing its index (1 included) resumes it bitwise."""
    ck = str(tmp_path / "ck")
    clean = port_base()
    run(make_exp(window_block=4), max_windows=4, checkpoint_path=ck)
    for wb in (1, 2, 4):
        resumed = run(make_exp(window_block=wb), checkpoint_path=ck,
                      resume=True)
        assert_records_bitwise(clean, resumed, ctx=wb)


def test_mid_block_resume_rejected_naming_the_knob(tmp_path):
    """A checkpoint at window 3 cannot seed a window_block=4 resume;
    the error names window_block. A dividing window_block is fine."""
    ck = str(tmp_path / "ck")
    run(make_exp(), max_windows=3, checkpoint_path=ck)
    with pytest.raises(T.ExperimentError, match="window_block"):
        run(make_exp(window_block=4), checkpoint_path=ck, resume=True)
    resumed = run(make_exp(window_block=3), checkpoint_path=ck, resume=True)
    assert_records_bitwise(port_base(), resumed)


def test_snapshot_checkpoint_saves_without_flushing_pipeline(tmp_path):
    """With snapshots on, checkpoint() while blocks are in flight saves
    the oldest ring's ENTRY snapshot (the collected frontier): the
    pipeline is untouched, and the file seeds a bitwise resume."""
    eng = T.build_engine(make_exp(window_block=2, pipeline_depth=2),
                         device="cpu")
    eng.enable_snapshots()
    for _ in range(3):
        eng.run_block()  # dispatch b0, b1, then b2 and collect b0
    assert len(eng._pending) == 2 and eng._window == 2
    ck = str(tmp_path / "ck")
    eng.checkpoint(ck)
    assert len(eng._pending) == 2 and eng._window == 2
    assert eng.n_snapshot_saves == 1 and eng.n_ckpt_flushes == 0
    assert len(eng.ckpt_pulls) == 1  # one wait: the pool's copy
    z = np.load(ck + ".npz")
    assert int(z["window"]) == 2 and len(z["rec_t"]) == 2
    eng.flush()
    resumed = run(make_exp(window_block=2), checkpoint_path=ck, resume=True)
    assert_records_bitwise(port_base(), resumed)


def test_checkpoint_without_snapshots_still_flushes(tmp_path):
    eng = T.build_engine(make_exp(window_block=4), device="cpu")
    eng.run_block()
    assert eng._dispatched == 4 and eng._window == 0  # pipelined
    ck = str(tmp_path / "ck")
    eng.checkpoint(ck)
    assert eng.n_ckpt_flushes == 1 and eng.n_snapshot_saves == 0
    assert eng._window == 4  # the flush
    z = np.load(ck + ".npz")
    assert int(z["window"]) == 4 and len(z["rec_t"]) == 4


def test_checkpointing_saves_on_every_block_boundary(tmp_path):
    """A checkpoint_path run saves after every collected block, on that
    block's boundary, from ring snapshots: no save ever flushes."""
    exp = make_exp(window_block=2, pipeline_depth=2)
    eng = T.build_engine(exp, device="cpu")
    saves = []
    orig = eng.checkpoint
    eng.checkpoint = lambda p: (orig(p), saves.append(eng._window))
    res = SimulationResult(exp, eng).resume(
        checkpoint_path=str(tmp_path / "ck"))
    assert saves == [2, 4, 6, 8]
    assert res.telemetry.ckpt_flushes == 0
    # every save but the last has a ring behind it to serve it
    assert res.telemetry.snapshot_saves == 3
    assert_records_bitwise(port_base(), res)


def test_max_windows_can_cut_a_block_short_and_realign():
    clean = run(make_exp(window_block=4))
    r = run(make_exp(window_block=4), max_windows=3)
    assert r.windows_run == 3
    r.resume()
    assert_bitwise(clean, r)
    assert [b[:2] for b in r.telemetry.block_walls] == [(0, 3), (3, 1),
                                                        (4, 4)]


def test_mid_block_cut_checkpoint_rolls_back_to_block_boundary(tmp_path):
    """A checkpoint at a mid-block max_windows cut (frontier 6 under
    wb=4) is served from the cut block's aligned ENTRY snapshot: the
    file lands on window 4, without a flush, and resumes bitwise."""
    ck = str(tmp_path / "ck")
    clean = run(make_exp(window_block=4))
    cut = run(make_exp(window_block=4), max_windows=6, checkpoint_path=ck)
    assert cut.windows_run == 6
    assert cut.telemetry.ckpt_flushes == 0
    assert int(np.load(ck + ".npz")["window"]) == 4
    resumed = run(make_exp(window_block=4), checkpoint_path=ck, resume=True)
    assert_records_bitwise(clean, resumed)


# ------------------------------------------------------- error paths
def test_truncation_raises_naming_the_failing_window():
    with pytest.raises(FusedWindowTruncated, match="window 0"):
        run(make_exp(window_block=4, use_kernel=True, kernel_chunk_steps=1,
                     kernel_max_chunks=1))


def test_truncation_drops_the_inflight_pipeline():
    """When block k truncates, block k+1 (dispatched from the partial
    pool) is dropped: no later accessor re-raises or turns it into
    records, and the cursor rewinds to the collected frontier."""
    eng = T.build_engine(make_exp(window_block=2, use_kernel=True,
                                  kernel_chunk_steps=1, kernel_max_chunks=1),
                         device="cpu")
    eng.run_block()
    with pytest.raises(FusedWindowTruncated):
        eng.run_block()  # dispatches block 1, then collects block 0
    assert not eng._pending
    assert eng.grouped_stats() == []
    assert eng.stream.records() == []
    assert eng._dispatched == eng._window == 0


def test_window_block_validation():
    with pytest.raises(T.ExperimentError, match="window_block"):
        make_exp(window_block=0).validate()
    with pytest.raises(T.ExperimentError, match="host_loop"):
        make_exp(window_block=4, host_loop=True).validate()
    with pytest.raises(ValueError, match="window_block"):
        SimConfig(window_block=0)
    with pytest.raises(ValueError, match="host_loop"):
        SimConfig(window_block=2, host_loop=True)
    SimConfig(window_block=1, host_loop=True)  # the baseline stays legal


def test_sinks_receive_records_in_window_order():
    seen = []
    run(make_exp(window_block=3, pipeline_depth=2,
                 sinks=(lambda rec: seen.append(rec.window),)))
    assert seen == list(range(N_WINDOWS))


# ----------------------------------------------------------- host loop
@pytest.mark.parametrize("use_kernel,sparse,sweep", [
    (False, False, None), (True, False, {"die": [0.3, 1.2]}),
    (True, True, None), (False, True, {"die": [0.3, 1.2]})])
def test_host_loop_bitwise_against_fused_path(use_kernel, sparse, sweep):
    """host_loop=True (a gather, an advance and a scatter per scheduler
    group, one kernel launch per group with use_kernel): the fused
    path's records and final pool, one dispatch per group and window."""
    replicas = 10 if sweep else 20  # groups of 8: a padded last group
    kw = dict(use_kernel=use_kernel, sparse=sparse, sweep=sweep,
              replicas=replicas, n_windows=3)
    fused = run(make_exp(**kw))
    hl = run(make_exp(host_loop=True, **kw))
    assert_bitwise(fused, hl)
    assert (fused.final_state() == hl.final_state()).all()
    assert hl.telemetry.dispatches == 3 * 3  # ceil(20 / 8) groups x 3


@pytest.mark.parametrize("window_block", [1, 4])
def test_guards_trip_on_a_poisoned_pool_unless_turned_off(window_block):
    """SimConfig.guards checks the statistics the collector already
    pulled, on the per-window and the superstep path alike; a trip
    drops the pipeline. guards=False lets the NaN record through."""
    from dataclasses import replace

    from repro_torch.core.engine import InvariantViolation

    for guards in (True, False):
        eng = T.build_engine(make_exp(window_block=window_block),
                             device="cpu")
        eng.cfg = replace(eng.cfg, guards=guards)
        eng._pool = eng._pool._replace(
            x=torch.full_like(eng._pool.x, float("nan")))
        if guards:
            with pytest.raises(InvariantViolation, match="non_finite"):
                eng.run()
            assert not eng._pending and eng._dispatched == eng._window == 0
        else:
            recs = eng.run()
            assert len(recs) == N_WINDOWS
            assert np.isnan(recs[0].mean).all()
