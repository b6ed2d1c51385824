"""The sharded farm in the port (`Partitioning(n_shards=K)`): the
counterpart of tests/test_sharded.py, case for case, on the CPU with
one explicit device for every shard.

The contract: a K-shard run advances K contiguous pool slices, each
through its own body, and reduces them through the same Welford block
stack, so its records, grouped per-point statistics, trajectories and
sketches are bitwise the unsharded run's at the same stat_blocks, for
K in {2, 4, 8}, exact and tau, dense and sparse, unfused and kernel
(plain twin), any window_block and depth. Checkpoints hold the global
pool and restore into any shard count, across the two packages.

The reference's own sharded runs need forced host devices, so they
run in one subprocess (as tests/test_sharded.py runs them), with a
sentinel that the body ran to its end. The port's lv2 ensembles here
run to t = 0.01 (the reference's tests: 1.0): the CPU twin pays each
SSA step in Python-level torch ops, once per shard.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import repro.api as J
import repro_torch.api as T
from repro.core.dispatch import Partitioning as JPartitioning
from repro_torch.api.run import build_engine
from repro_torch.core.cwc.models import MODELS
from repro_torch.core.engine import SimConfig, SimulationEngine
from repro_torch.kernels.ops import FusedWindowTruncated

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_END = 0.01
TAU_T_END = 0.1  # tau-leaping both leaps and falls back to exact steps
VAR_ULP = 12
CI90_ULP = 8


def make_exp(n_shards, stat_blocks=8, policy="on_demand", t_end=T_END,
             n_windows=4, schema="iii", **kw):
    """tests/test_sharded.py's experiment: lv2 over a 2-point sweep,
    PER_POINT, 32 instances, trajectories recorded."""
    kw.setdefault("record_trajectories", True)
    return T.Experiment(
        model=MODELS["lv2"](),
        ensemble=T.Ensemble.make(replicas=16, sweep={"die": [0.3, 1.2]}),
        schedule=T.Schedule(t_end=t_end, n_windows=n_windows,
                            schema=schema, policy=policy),
        reduction=T.Reduction.PER_POINT,
        n_lanes=8, seed=11,
        partitioning=T.Partitioning(n_shards=n_shards,
                                    stat_blocks=stat_blocks), **kw)


def run(exp, **kw):
    return T.simulate(exp, device="cpu", **kw)


def assert_bitwise(a, b, ctx="", resumed=False):
    """Records, per-point statistics and trajectories bit for bit, and
    the step/leap telemetry unless `b` was resumed (a restore restarts
    the per-window telemetry, as in the reference)."""
    assert len(a.records) == len(b.records), ctx
    for ra, rb in zip(a.records, b.records):
        assert (ra.t, ra.window, ra.n) == (rb.t, rb.window, rb.n), ctx
        for f in ("mean", "var", "ci90"):
            assert getattr(ra, f).tobytes() == getattr(rb, f).tobytes(), \
                (ctx, f)
    pa, pb = a.per_point(), b.per_point()
    for k in ("n", "mean", "var", "ci90"):
        assert pa[k].tobytes() == pb[k].tobytes(), (ctx, k)
    ta, tb = a.trajectories(), b.trajectories()
    assert (ta is None) == (tb is None), ctx
    if ta is not None:
        assert ta.tobytes() == tb.tobytes(), ctx
    if not resumed:
        assert a.telemetry.steps_per_window \
            == b.telemetry.steps_per_window, ctx
        assert a.telemetry.leaps_per_window \
            == b.telemetry.leaps_per_window, ctx


def ulp(a, b) -> int:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


# ------------------------------------------ the repaired Partitioning
VALIDATE_CASES = [
    dict(n_shards=0), dict(n_shards=2, axis=""), dict(n_shards=2, axis=None),
    dict(n_shards=3), dict(n_shards=2, stat_blocks=0),
    dict(n_shards=4, stat_blocks=6), dict(n_shards=2, stat_blocks=10),
    dict(n_shards=4, stat_blocks=8), dict(n_shards=1, stat_blocks=32)]


@pytest.mark.parametrize("case", VALIDATE_CASES,
                         ids=lambda c: ",".join(f"{k}={v!r}"
                                                for k, v in c.items()))
def test_partitioning_validate_matches_reference(case):
    """The reference's checks and messages, `axis` included (a port
    without the axis check let Partitioning(axis="") through)."""
    errs = []
    for cls in (JPartitioning, T.Partitioning):
        try:
            cls(**case).validate(32)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]


def test_partitioning_degrade_matches_reference():
    """degrade() gives the reference's shard count, pinned stat_blocks
    and errors over a grid of (n_instances, stat_blocks, n_shards,
    n_lost)."""
    seen = 0
    for n_inst in (24, 30, 32, 48):
        for blocks in (None, 4, 6, 8, 12):
            for k in (1, 2, 3, 4, 6, 8):
                try:
                    JPartitioning(n_shards=k,
                                  stat_blocks=blocks).validate(n_inst)
                except ValueError:
                    continue
                for lost in (0, 1, 2, 3, k):
                    got = []
                    for cls in (JPartitioning, T.Partitioning):
                        try:
                            p = cls(n_shards=k, axis="rows",
                                    stat_blocks=blocks).degrade(n_inst, lost)
                            got.append((p.n_shards, p.axis, p.stat_blocks))
                        except ValueError as e:
                            got.append(str(e))
                    assert got[0] == got[1], (n_inst, blocks, k, lost)
                    seen += 1
    assert seen > 100


def test_device_placement():
    """One device holds every shard; a list places shard k on entry k
    (entries may repeat); a list of the wrong length, and n_shards
    beyond the visible cards without an explicit device, are refused
    naming both explicit forms."""
    exp = make_exp(4)
    eng = build_engine(exp, device="cpu")
    assert [str(d) for d in eng.devices] == ["cpu"] * 4
    assert [p.x.shape[0] for p in eng._pools] == [8] * 4
    eng = build_engine(exp, device=["cpu"] * 4)
    assert len(eng._pools) == 4
    with pytest.raises(T.ExperimentError, match="one device per shard"):
        build_engine(exp, device=["cpu"] * 3)
    import torch

    if torch.cuda.device_count() < 4:
        with pytest.raises(T.ExperimentError,
                           match="device=<one device>.*list of 4 devices"):
            build_engine(exp)
    with pytest.raises(T.ExperimentError, match="host_loop"):
        build_engine(make_exp(2, host_loop=True), device="cpu")


# ------------------------------------------- tests/test_sharded.py
@pytest.fixture(scope="module")
def base():
    return run(make_exp(n_shards=1))


@pytest.fixture(scope="module")
def kernel_base():
    return run(make_exp(n_shards=1, use_kernel=True))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_sharded_bit_identical_to_fused_single_device(base, k):
    """The bar: K shards reproduce the unsharded run bit for bit —
    records, per-point statistics, trajectories — with one dispatch per
    window, whatever K."""
    shard = run(make_exp(n_shards=k))
    assert_bitwise(base, shard, k)
    assert shard.telemetry.dispatches == 4


def test_sharded_records_invariant_to_shard_count_without_pinning():
    """stat_blocks defaults to n_shards; pinned to 4, K = 2 and K = 4
    agree."""
    a = run(make_exp(n_shards=2, stat_blocks=4))
    b = run(make_exp(n_shards=4, stat_blocks=4))
    assert_bitwise(a, b)


def test_predictive_groups_stay_within_shards(base):
    """The predictive policy groups within shard blocks and reproduces
    the on_demand results bitwise."""
    pred = make_exp(n_shards=4, policy="predictive")
    assert_bitwise(base, run(pred))
    eng = build_engine(pred, device="cpu")
    eng.run_window()
    eng.run_window()
    assert eng.scheduler._cost.any()  # costs are not trivial
    per = eng.cfg.n_instances // 4
    for g in eng.scheduler.groups():
        assert len({int(i) // per for i in g}) == 1, g
    # each shard's permutation is local to its shard
    for p in eng._permutations():
        assert int(p.min()) >= 0 and int(p.max()) < per


def test_sharded_checkpoint_is_mesh_shape_agnostic_artifact(tmp_path,
                                                             base):
    """checkpoint() gathers the global pool; an 8-shard resume is
    bitwise."""
    ck = str(tmp_path / "ck")
    run(make_exp(n_shards=8), max_windows=2, checkpoint_path=ck)
    z = np.load(ck + ".npz")
    assert z["x"].shape[0] == 32  # the global pool, not a shard
    resumed = run(make_exp(n_shards=8), checkpoint_path=ck, resume=True)
    assert_bitwise(base, resumed, resumed=True)


def test_sharded_step_rebuilds_when_group_count_changes():
    """set_groups with another group count regroups the next window."""
    eng = build_engine(make_exp(n_shards=4), device="cpu")
    eng.run_window()
    assert eng.grouped_stats()[-1].mean.shape == (2, 2)
    eng.set_groups(np.arange(32, dtype=np.int32) % 4)
    eng.run_window()
    assert eng.grouped_stats()[-1].mean.shape == (4, 2)


def test_sharded_schema_ii_buffers_global_trajectories():
    """Schema ii assembles each window's samples in shard order."""
    sched = T.Schedule(t_end=T_END, n_windows=3, schema="ii")
    a = run(make_exp(n_shards=8).with_(schedule=sched))
    b = run(make_exp(n_shards=1).with_(schedule=sched))
    ta, tb = a.trajectories(), b.trajectories()
    assert ta.shape == (32, 3, 2)
    assert ta.tobytes() == tb.tobytes()


@pytest.mark.parametrize("k", [2, 4, 8])
def test_kernel_composes_with_sharded_dispatch(base, kernel_base, k):
    """The kernel body per shard (its plain twin here) reproduces the
    unsharded kernel run and the unfused run bit for bit, one dispatch
    per window and one launch per shard and window."""
    assert_bitwise(base, kernel_base)
    shard = run(make_exp(n_shards=k, use_kernel=True))
    assert_bitwise(kernel_base, shard, k)
    assert shard.telemetry.dispatches == 4
    assert len(shard._engine._dispatch._bodies) == k


@pytest.mark.parametrize("k", [2, 4, 8])
def test_tau_leap_composes_with_sharded_dispatch(k):
    """Method.TAU_LEAP per shard: bitwise across K and both bodies, and
    the same leaps per window."""
    base = run(make_exp(n_shards=1, method="tau_leap", t_end=TAU_T_END))
    assert sum(base.telemetry.leaps_per_window) > 0  # it leaps
    for kernel in (False, True):
        shard = run(make_exp(n_shards=k, method="tau_leap",
                             t_end=TAU_T_END, use_kernel=kernel))
        assert_bitwise(base, shard, (k, kernel))
        assert shard.telemetry.dispatches == 4


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("method", ["exact", "tau_leap"])
def test_sparse_composes_with_sharded_dispatch(k, method):
    """sparse=True per shard (the sparse exact and sparse tau twins):
    bitwise against the unsharded sparse run."""
    t_end = TAU_T_END if method == "tau_leap" else T_END
    base = run(make_exp(n_shards=1, sparse=True, method=method,
                        t_end=t_end, use_kernel=True))
    shard = run(make_exp(n_shards=k, sparse=True, method=method,
                         t_end=t_end, use_kernel=True))
    assert_bitwise(base, shard, (k, method))


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("wb", [2, 4])
def test_supersteps_compose_with_sharded_dispatch(base, k, wb):
    """window_block under sharding: bitwise against the per-window
    unsharded run, both bodies; dispatches = host syncs = blocks."""
    for kernel in (False, True):
        shard = run(make_exp(n_shards=k, window_block=wb,
                             use_kernel=kernel))
        assert_bitwise(base, shard, (k, wb, kernel))
        tele = shard.telemetry
        assert tele.dispatches == -(-4 // wb), (k, wb)
        assert tele.host_syncs == -(-4 // wb), (k, wb)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_depth_k_pipeline_composes_with_sharded_dispatch(base, depth):
    """pipeline_depth under sharding, on_demand and predictive: bitwise
    against the per-window unsharded run."""
    for policy in ("on_demand", "predictive"):
        shard = run(make_exp(n_shards=4, window_block=2,
                             pipeline_depth=depth, policy=policy))
        assert_bitwise(base, shard, (depth, policy))
        tele = shard.telemetry
        assert tele.pipeline_depth == depth
        assert tele.dispatches == 2 and tele.host_syncs == 2


def test_superstep_checkpoint_resumes_on_sharded_path(tmp_path, base):
    """A block-boundary file from an 8-shard superstep run resumes on 4
    shards, bitwise."""
    ck = str(tmp_path / "ck")
    run(make_exp(n_shards=8, window_block=2), max_windows=2,
        checkpoint_path=ck)
    assert int(np.load(ck + ".npz")["window"]) == 2
    resumed = run(make_exp(n_shards=4, window_block=2),
                  checkpoint_path=ck, resume=True)
    assert_bitwise(base, resumed, resumed=True)


@pytest.mark.parametrize("depth", [1, "auto"])
def test_restore_across_shard_counts_with_snapshots(tmp_path, base, depth):
    """A 4-shard run checkpointing every block from its ring snapshots
    (with blocks in flight) restores at 1 and at 2 shards, bitwise."""
    ck = str(tmp_path / "ck")
    part = run(make_exp(n_shards=4, window_block=2, pipeline_depth=depth),
               max_windows=2, checkpoint_path=ck)
    assert part.telemetry.ckpt_flushes == 0
    for k in (1, 2):
        resumed = run(make_exp(n_shards=k, window_block=2),
                      checkpoint_path=ck, resume=True)
        assert_bitwise(base, resumed, k, resumed=True)


def test_kernel_truncation_raises_under_sharded_dispatch():
    """A budget overrun on any shard surfaces, never a partial window."""
    eng = SimulationEngine(
        MODELS["lv2"](),
        SimConfig(n_instances=32, t_end=2.0, n_windows=2, n_lanes=8,
                  schema="iii", seed=5, use_kernel=True,
                  kernel_chunk_steps=1, kernel_max_chunks=1,
                  stat_blocks=8, n_shards=4), device="cpu")
    with pytest.raises(FusedWindowTruncated):
        eng.run_window()


def test_steered_sketched_sharded_run_bitwise():
    """Steering (early stop and reallocation across shards) and a
    sketch under 4 shards: records, sketches and the decision log equal
    the unsharded run's."""
    sk = T.SketchSpec(n_bins=8, lo=0.0, hi=600.0, thresholds=(150.0,))
    st = T.Steering(ci_rel_tol=0.0055, min_windows=2, reallocate=True)
    kw = dict(sketch=sk, steering=st, n_windows=6, t_end=0.06)
    base = run(make_exp(n_shards=1, use_kernel=True, **kw))
    shard = run(make_exp(n_shards=4, use_kernel=True, **kw))
    assert_bitwise(base, shard)
    for a, b in zip(base.sketches(), shard.sketches()):
        assert a.hist.tobytes() == b.hist.tobytes()
        assert a.rare.tobytes() == b.rare.tobytes()
    rep = shard.steering_report()
    assert rep == base.steering_report()
    # point 1 (shards 2 and 3) stops first and its lanes take donors of
    # point 0 from shards 0 and 1: moves across shards
    assert any(d["action"] == "reallocate" for d in rep["decisions"])


# ------------------------------------------------- against the reference
_J_BODY = """
import json, sys
import numpy as np
from repro.api import (Ensemble, Experiment, Partitioning, Reduction,
                       Schedule, simulate)
from repro.core.cwc.models import lotka_volterra

def make_exp(n_shards):
    return Experiment(
        model=lotka_volterra(2),
        ensemble=Ensemble.make(replicas=16, sweep={{"die": [0.3, 1.2]}}),
        schedule=Schedule(t_end={t_end}, n_windows=4, schema="iii"),
        reduction=Reduction.PER_POINT, n_lanes=8, seed=11,
        record_trajectories=True,
        partitioning=Partitioning(n_shards=n_shards, stat_blocks=8))

def recs(res):
    return dict(mean=np.stack([r.mean for r in res.records]).tolist(),
                var=np.stack([r.var for r in res.records]).tolist(),
                ci90=np.stack([r.ci90 for r in res.records]).tolist())

out = {{}}
out["clean4"] = recs(simulate(make_exp(4)))
simulate(make_exp(8), max_windows=2, checkpoint_path={j_ck!r})
out["resumed8"] = recs(simulate(make_exp(8), checkpoint_path={t_ck!r},
                                resume=True))
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's 4-shard clean run, a file it saved at 8 shards
    after window 2, and its 8-shard run resumed from the port's 4-shard
    file of window 2 — one subprocess on 8 forced host devices."""
    d = tmp_path_factory.mktemp("sharded_ref")
    t_ck, j_ck = str(d / "port"), str(d / "ref")
    run(make_exp(n_shards=4), max_windows=2, checkpoint_path=t_ck)
    body = textwrap.dedent(_J_BODY).format(t_end=T_END, j_ck=j_ck,
                                           t_ck=t_ck)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c",
                          body + '\nprint("SNIPPET-RAN")\n'],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "SNIPPET-RAN" in out.stdout, "the reference's body did not run"
    line = next(s for s in out.stdout.splitlines()
                if s.startswith("RESULT "))
    got = json.loads(line[len("RESULT "):])
    return {k: {f: np.asarray(v, np.float32) for f, v in r.items()}
            for k, r in got.items()}, j_ck


def assert_matches(ref, res, ctx=""):
    """Means bitwise (sums of integer populations), var and ci90
    within the pinned ulp bounds."""
    mean = np.stack([r.mean for r in res.records])
    assert mean.tobytes() == ref["mean"].tobytes(), ctx
    assert ulp(np.stack([r.var for r in res.records]), ref["var"]) \
        <= VAR_ULP, ctx
    assert ulp(np.stack([r.ci90 for r in res.records]), ref["ci90"]) \
        <= CI90_ULP, ctx


def test_four_shards_match_the_reference_sharded_run(reference_runs):
    refs, _ = reference_runs
    assert_matches(refs["clean4"], run(make_exp(n_shards=4)))


def test_reference_file_of_8_shards_resumes_on_4_port_shards(
        reference_runs, base):
    """A file the reference saved at 8 shards restores in the port at 4
    and ends bitwise equal to the port's clean run."""
    _, j_ck = reference_runs
    resumed = run(make_exp(n_shards=4), checkpoint_path=j_ck, resume=True)
    assert_bitwise(base, resumed, resumed=True)
    assert_matches(refs_clean(reference_runs), resumed)


def test_port_file_of_4_shards_resumes_on_8_reference_shards(
        reference_runs):
    """The reverse: the port's 4-shard file resumes in the reference at
    8 shards and ends as the reference's clean run (means bitwise)."""
    refs, _ = reference_runs
    assert refs["resumed8"]["mean"].tobytes() \
        == refs["clean4"]["mean"].tobytes()
    assert ulp(refs["resumed8"]["var"], refs["clean4"]["var"]) == 0


def refs_clean(reference_runs):
    return reference_runs[0]["clean4"]
