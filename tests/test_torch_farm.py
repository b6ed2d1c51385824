"""The multi-process farm in the port (`repro_torch.runtime.coordinator`
and `runtime.worker`) against the port's own single-process run and
against the reference's farm, case for case with tests/test_farm.py.

The contract: a farm of `Recovery.workers` worker PROCESSES, each a
RunSupervisor over one contiguous shard, gives records, per-point
stats, trajectories, the final populations, sketches and the steering
report bit for bit equal to the single-process run at the same pinned
statistics partition (`Partitioning(n_shards=1, stat_blocks=WORKERS)`),
whichever workers are SIGKILLed, SIGSTOPped, fed a corrupt checkpoint,
or retired and reassigned. Where a fault lands depends on timing (a
fault scheduled at window w fires at the first heartbeat past w), so
the counters assert `>= 1`; the data assertions are exact.

Against the reference: the five farm refusals message for message, the
two farms at the parity contract's tiers (means, counts, trajectories,
populations, sketches and the steering report bitwise; var and ci90
within an ulp bound), worker bundles through the other package's merge,
the shard seam's key rows, rates and rebased groups, and a worker
engine's partial stacks.

The experiment is the reference's mixed-variance immigration-death
sweep scaled as tests/test_torch_steering.py scales it (birth rates 2.5
and 40 over 80 replicas, against 50 and 800 over 4): the same relative
CIs and decisions at a twentieth of the events, which the port's CPU
twin pays step by step.
"""
import collections
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as J
import repro_torch.api as T
from repro.api.run import build_engine as j_build_engine
from repro.core.reactions import make_system as j_make_system
from repro.runtime import coordinator as j_coord
from repro.runtime.fault import FailurePlan as JFailurePlan
from repro_torch.ckpt import store as t_store
from repro_torch.core.cwc.compile import CompiledModel
from repro_torch.core.cwc.models import MODELS
from repro_torch.core.reactions import make_system as t_make_system
from repro_torch.runtime import coordinator as t_coord
from repro_torch.runtime.fault import FailurePlan

LAMS = [2.5, 40.0, 2.5, 40.0, 2.5, 40.0]
REPLICAS, N_WINDOWS, WORKERS = 80, 12, 3
# var / ci90 / m2 of the two packages: the reference's sums over
# instances run in XLA's order, the port's in torch's
VAR_ULP = 16
CI90_ULP = 8


def _exp(api=T, **kw):
    make = j_make_system if api is J else t_make_system
    model = make(["A"], [({}, {"A": 1}, LAMS[0]), ({"A": 1}, {}, 1.0)],
                 {"A": 0}, names=("birth", "death"))
    spec = dict(
        model=model,
        ensemble=api.Ensemble.make(replicas=REPLICAS,
                                   sweep={"birth": LAMS}),
        schedule=api.Schedule(t_end=12.0, n_windows=N_WINDOWS),
        reduction=api.Reduction.PER_POINT,
        n_lanes=8, seed=5, window_block=2,
        steering=api.Steering(ci_rel_tol=0.03, min_windows=4),
        sketch=api.SketchSpec(n_bins=8),
        record_trajectories=True,
        # the port's kernel path runs its plain twin here; the
        # reference's jitted unfused path gives the same bits
        use_kernel=api is T)
    spec.update(kw)
    return api.Experiment(**spec)


def _recovery(api, ckpt_dir, schedule=None, **kw):
    kw.setdefault("workers", WORKERS)
    kw.setdefault("heartbeat_s", 1.0)
    kw.setdefault("cadence", 4)
    kw.setdefault("keep_last", 3)
    kw.setdefault("backoff_base_s", 0.0)
    plan = JFailurePlan if api is J else FailurePlan
    inject = plan(schedule=schedule) if schedule is not None else None
    return api.Recovery(ckpt_dir=str(ckpt_dir), inject=inject, **kw)


def _farm(tmp_path, schedule=None, **kw):
    return T.simulate(_exp(recovery=_recovery(T, tmp_path / "farm",
                                              schedule, **kw)),
                      device="cpu")


@pytest.fixture(scope="module")
def single():
    """The port's uninterrupted single-process run, its statistics
    partition pinned to the farm's block count."""
    return T.simulate(_exp(partitioning=T.Partitioning(
        n_shards=1, stat_blocks=WORKERS)), device="cpu")


@pytest.fixture(scope="module")
def port_farm(tmp_path_factory):
    """(result, ckpt_dir) of a fault-free port farm."""
    d = tmp_path_factory.mktemp("port_farm")
    res = T.simulate(_exp(recovery=_recovery(T, d, heartbeat_s=2.0)),
                     device="cpu")
    return res, d


@pytest.fixture(scope="module")
def ref_farm(tmp_path_factory):
    """(result, ckpt_dir) of the reference's fault-free farm on the same
    Experiment."""
    d = tmp_path_factory.mktemp("ref_farm")
    res = J.simulate(_exp(J, recovery=_recovery(J, d, heartbeat_s=2.0)))
    return res, d


def assert_farm_bitwise(ref, farm, ctx=""):
    assert len(ref.records) == len(farm.records) == N_WINDOWS, ctx
    for ra, rb in zip(ref.records, farm.records):
        assert (ra.t, ra.window, ra.n) == (rb.t, rb.window, rb.n), ctx
        for f in ("mean", "var", "ci90"):
            assert np.asarray(getattr(ra, f)).tobytes() \
                == np.asarray(getattr(rb, f)).tobytes(), (ctx, f)
    ga, gb = ref.per_point(), farm.per_point()
    for f in ("n", "mean", "var", "ci90"):
        assert np.asarray(ga[f]).tobytes() == np.asarray(gb[f]).tobytes(), \
            (ctx, f)
    assert np.asarray(ref.trajectories()).tobytes() \
        == np.asarray(farm.trajectories()).tobytes(), ctx
    assert np.asarray(ref.final_state()).tobytes() \
        == np.asarray(farm.final_state()).tobytes(), ctx
    assert len(ref.sketches()) == len(farm.sketches()) == N_WINDOWS, ctx
    for sa, sb in zip(ref.sketches(), farm.sketches()):
        assert (np.asarray(sa.hist) == np.asarray(sb.hist)).all(), ctx
    assert ref.steering_report() == farm.steering_report(), ctx


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return float(np.max(np.abs(a.astype(np.float64) - b) / scale))


def assert_parity(ref, got, ctx=""):
    """The parity contract's tiers between the two packages' runs."""
    assert len(ref.records) == len(got.records), ctx
    for ra, rb in zip(ref.records, got.records):
        assert (ra.t, ra.window, ra.n) == (rb.t, rb.window, rb.n), ctx
        assert np.asarray(ra.mean).tobytes() == rb.mean.tobytes(), ctx
        assert _ulps(ra.var, rb.var) <= VAR_ULP, ctx
        assert _ulps(ra.ci90, rb.ci90) <= CI90_ULP, ctx
    ga, gb = ref.per_point(), got.per_point()
    for f in ("n", "mean"):
        assert np.asarray(ga[f]).tobytes() == np.asarray(gb[f]).tobytes(), \
            (ctx, f)
    assert _ulps(ga["var"], gb["var"]) <= VAR_ULP, ctx
    assert _ulps(ga["ci90"], gb["ci90"]) <= CI90_ULP, ctx
    assert np.asarray(ref.trajectories()).tobytes() \
        == np.asarray(got.trajectories()).tobytes(), ctx
    assert np.asarray(ref.final_state()).tobytes() \
        == np.asarray(got.final_state()).tobytes(), ctx
    for sa, sb in zip(ref.sketches(), got.sketches()):
        assert (np.asarray(sa.hist) == np.asarray(sb.hist)).all(), ctx
    assert ref.steering_report() == got.steering_report(), ctx


def _events(report, name):
    return [e for e in report["events"] if e["event"] == name]


# --------------------------------------------------------- fault-free
def test_farm_fault_free_is_bitwise(single, port_farm):
    farm, _ = port_farm
    assert_farm_bitwise(single, farm)
    rep = farm.recovery_report()
    assert rep["workers"] == WORKERS
    assert rep["restarts"] == 0 and rep["faults_by_kind"] == {}
    assert rep["reassignments"] == 0
    assert len(_events(rep, "worker_launched")) == WORKERS
    assert len(_events(rep, "worker_done")) == WORKERS
    assert all(e["quiet_s"] >= 0 for e in _events(rep, "worker_done"))
    assert sorted(rep["heartbeats"]) == list(range(WORKERS))
    assert all(h["max_gap_s"].get("run", 0.0) < 3 * 2.0
               and h["max_write_s"] >= 0
               for h in rep["heartbeats"].values())
    # steering forces lock-step in every worker, visibly
    assert rep["pipeline_depth_effective"] == 1
    assert sorted(rep["worker_reports"]) == list(range(WORKERS))
    assert [w["device"] for w in rep["per_worker"].values()] \
        == ["cpu"] * WORKERS
    # the farm really steered: the converged points stopped early
    assert farm.steering_report()["stopped_points"] == [1, 3, 5]
    # each worker's engine wall sits inside its process's lifetime
    for k in range(WORKERS):
        assert 0 < rep["worker_walls"][k] < rep["worker_lifetimes"][k]
    assert rep["merge_s"] > 0
    # telemetry merged over the workers: one dispatch and one host sync
    # per block each (steered runs take the block loop)
    tele = farm.telemetry
    assert tele.dispatches == tele.host_syncs == WORKERS * N_WINDOWS // 2
    assert tele.steps_per_window == single.telemetry.steps_per_window


# ------------------------------------------------------------- drills
def test_farm_sigkill_drill_restarts_and_stays_bitwise(single, tmp_path):
    """SIGKILL a worker mid-run: the coordinator sees the dead process
    (host_lost), restarts it, and the new worker resumes from its newest
    namespaced checkpoint."""
    farm = _farm(tmp_path, schedule={2: "host_lost"})
    assert_farm_bitwise(single, farm, "sigkill")
    rep = farm.recovery_report()
    assert rep["restarts"] >= 1
    assert rep["faults_by_kind"].get("host_lost", 0) >= 1
    inj = _events(rep, "fault_injected")
    assert inj and inj[0]["kind"] == "host_lost"
    assert _events(rep, "fault") and _events(rep, "restart_scheduled")
    assert len(_events(rep, "worker_done")) >= WORKERS


def test_farm_sigstop_stall_drill(single, tmp_path):
    """SIGSTOP freezes a worker and its heartbeat thread; the stale
    heartbeat passes 3 x heartbeat_s, and the coordinator kills the
    stopped process (SIGCONT, SIGKILL: worker_stall) and restarts it."""
    farm = _farm(tmp_path, schedule={2: "worker_stall"})
    assert_farm_bitwise(single, farm, "sigstop")
    rep = farm.recovery_report()
    assert rep["restarts"] >= 1
    assert rep["faults_by_kind"].get("worker_stall", 0) >= 1
    stalls = [e for e in _events(rep, "fault")
              if e["kind"] == "worker_stall"]
    assert stalls and "stale" in stalls[0]["error"]


def test_worker_supervisor_defaults_to_the_card(tmp_path, monkeypatch):
    """A WorkerSupervisor built with no device resolves to the CUDA
    device, as RunSupervisor does: on a host without one its build
    raises resolve_device's error instead of running on the CPU."""
    from repro_torch.runtime.worker import WorkerSupervisor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sup = WorkerSupervisor(_exp(steering=None), _recovery(T, tmp_path),
                           (0, REPLICAS // 2, 1), 0,
                           str(tmp_path / "hb.json"))
    assert sup.device is None
    with pytest.raises(RuntimeError, match="runs on a CUDA device by "
                       "default and none is available"):
        sup._build()


@pytest.mark.parametrize("phase,stalled", [("init", False), ("run", True),
                                           ("done", False)])
def test_stale_heartbeat_judged_by_phase(tmp_path, phase, stalled):
    """A live worker whose heartbeat is 2 s old at heartbeat_s = 0.5 (past
    the 1.5 s running limit): a running one is a worker_stall and is
    killed; one starting up ("init") or finished and exiting ("done")
    is held to the launch grace and left alone."""
    coord = t_coord.FarmCoordinator(
        _exp(), _recovery(T, tmp_path, heartbeat_s=0.5), device="cpu")
    slot = t_coord._Slot(0, torch.device("cpu"))
    sh = slot.shard = coord.shards[0]
    slot.proc = subprocess.Popen([sys.executable, "-c",
                                  "import time; time.sleep(60)"])
    try:
        slot.launch_t = sh.launch_t = time.time() - 10.0
        with open(sh.hb_path, "w") as f:
            f.write(json.dumps({"shard": 0, "window": N_WINDOWS,
                                "phase": phase}) + "\n")
        os.utime(sh.hb_path, (time.time() - 2.0,) * 2)
        coord._poll_slot(slot, collections.deque(), set())
        if stalled:
            assert coord._faults == {"worker_stall": 1}
            assert slot.proc is None and slot.restarts == 1
            faults = _events({"events": coord._events}, "fault")
            assert "stale" in faults[0]["error"]
        else:
            assert coord._faults == {} and slot.proc.poll() is None
    finally:
        if slot.proc is not None:
            slot.proc.kill()
            slot.proc.wait()


def test_farm_corrupt_checkpoint_drill(single, tmp_path):
    """Kill a worker AND truncate its newest checkpoint: the restarted
    worker's restore falls back past the corrupt file and still ends
    bitwise."""
    farm = _farm(tmp_path, schedule={3: "ckpt_corrupt"}, cadence=2)
    assert_farm_bitwise(single, farm, "corrupt")
    rep = farm.recovery_report()
    assert rep["restarts"] >= 1
    inj = _events(rep, "fault_injected")
    assert inj and inj[0]["kind"] == "ckpt_corrupt"
    shard = inj[0]["shard"]
    skipped = [e for e in rep["worker_reports"][shard]["events"]
               if e["event"] == "corrupt_checkpoint_skipped"]
    assert skipped, rep["worker_reports"][shard]["events"]


def test_farm_host_loss_reassigns_shard_to_survivor(single, tmp_path):
    """Past max_worker_restarts the slot is retired and its shard goes
    back on the queue; the first survivor that finishes takes it up in
    the same namespace and resumes from the retired worker's files."""
    farm = _farm(tmp_path, schedule={2: "host_lost"},
                 max_worker_restarts=0, heartbeat_s=2.0)
    assert_farm_bitwise(single, farm, "reassign")
    rep = farm.recovery_report()
    assert rep["reassignments"] >= 1
    assert any(w["retired"] for w in rep["per_worker"].values())
    retired = _events(rep, "worker_retired")
    moved = _events(rep, "shard_reassigned")
    assert retired and moved
    assert moved[0]["to_worker"] != moved[0]["from_worker"]
    assert any(len(w["shards_run"]) > 1
               for w in rep["per_worker"].values())


# --------------------------------------------- against the reference
_REFUSALS = [
    ("PROCESS", dict(partitioning="n_shards=2"), {}),
    ("whole stat blocks", dict(partitioning="stat_blocks=4"), {}),
    ("whole sweep points", dict(points=4), {}),
    ("reallocate", {}, dict(reallocate=True)),
    ("per-point", dict(reduction="ENSEMBLE"), {}),
]


@pytest.mark.parametrize("match,changes,steer", _REFUSALS,
                         ids=[r[0] for r in _REFUSALS])
def test_farm_refusals_match_reference(tmp_path, match, changes, steer):
    """The five farm refusals of `Experiment.validate`, message for
    message; nothing runs."""
    msgs = []
    for api in (J, T):
        kw = {}
        if "partitioning" in changes:
            n, v = changes["partitioning"].split("=")
            kw["partitioning"] = api.Partitioning(**{n: int(v)})
        if "reduction" in changes:
            kw["reduction"] = getattr(api.Reduction, changes["reduction"])
        exp = _exp(api, recovery=_recovery(api, tmp_path / "x"), **kw)
        if "points" in changes:  # whole stat blocks, not whole points
            exp = exp.with_(ensemble=api.Ensemble.make(
                replicas=60, sweep={"birth": LAMS[:changes["points"]]}))
        if steer:
            exp = exp.with_(steering=api.Steering(
                ci_rel_tol=0.03, min_windows=4, **steer))
        with pytest.raises(api.ExperimentError, match=match) as e:
            if api is J:
                J.simulate(exp)
            else:
                T.simulate(exp, device="cpu")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert not (tmp_path / "x").exists()


def test_farm_refuses_engine_internal_fault_kinds(tmp_path):
    """nan_pool and device_lost are the engine's faults: they drill the
    in-process supervisor, not the process farm; both packages refuse
    them alike."""
    msgs = []
    for api in (J, T):
        exp = _exp(api, recovery=_recovery(api, tmp_path / "x",
                                           {2: "nan_pool"}))
        with pytest.raises(ValueError, match="coordinator") as e:
            if api is J:
                J.simulate(exp)
            else:
                T.simulate(exp, device="cpu")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_farm_matches_reference_farm(port_farm, ref_farm):
    """The two packages' farms on one Experiment agree at the parity
    contract's tiers, with the same steering report and the same event
    story."""
    got, _ = port_farm
    ref, _ = ref_farm
    assert_parity(ref, got)
    rj, rt = ref.recovery_report(), got.recovery_report()
    for key in ("workers", "restarts", "faults_by_kind", "reassignments",
                "pipeline_depth_effective"):
        assert rj[key] == rt[key], key
    assert [e["event"] for e in rj["events"]].count("worker_done") \
        == [e["event"] for e in rt["events"]].count("worker_done")


def _bundles(load, ckpt_dir):
    return [load(os.path.join(str(ckpt_dir), f"shard{k:02d}__result.npz"))
            for k in range(WORKERS)]


def test_reference_bundles_through_port_merge(ref_farm):
    """The reference workers' result bundles, merged by the port, give
    the reference farm's result bit for bit."""
    ref, d = ref_farm

    def load(path):
        z = dict(t_store.verify(path))
        z["_meta"] = __import__("json").loads(str(z.pop("meta")))
        return z

    view = t_coord.merge_bundles(_exp(T), _bundles(load, d), "cpu")
    got = T.SimulationResult(_exp(T), view)
    assert_farm_bitwise(ref, got, "reference bundles")


def test_port_bundles_through_reference_merge(port_farm, tmp_path):
    """The port's workers' result bundles, merged by the reference's
    FarmCoordinator._merge, give the port farm's result bit for bit."""
    got, d = port_farm
    exp = _exp(J)
    fc = j_coord.FarmCoordinator(
        exp, _recovery(J, tmp_path / "unused"))
    for sh in fc.shards:
        sh.result_path = os.path.join(str(d), os.path.basename(
            sh.result_path))
        sh.bundle = fc._load_bundle(sh)
        assert sh.bundle is not None
    ref = J.SimulationResult(exp, fc._merge())
    assert_farm_bitwise(ref, got, "port bundles")


def test_shard_seam_matches_reference():
    """build_engine(shard=) takes the global key table's rows, the
    sweep's rates over the range and the group ids rebased to 0, and
    declares the same global stats layout as the reference's."""
    per = REPLICAS * len(LAMS) // WORKERS
    for k in range(WORKERS):
        shard = (k * per, (k + 1) * per, 1)
        je = j_build_engine(_exp(J), shard=shard)
        te = T.build_engine(_exp(T), device="cpu", shard=shard)
        assert np.asarray(je._pool.key).view(np.int32).tobytes() \
            == te._pool.key.numpy().tobytes()
        assert np.asarray(je.rates).tobytes() \
            == np.asarray(te.rates).tobytes()
        assert np.array_equal(je._group_ids, te._group_ids)
        assert te._group_ids.min() == 0
        assert je._stats_layout == te._stats_layout \
            == (WORKERS, k, len(LAMS), 2 * k)
        assert te.cfg.n_instances == per and te.cfg.stat_blocks == 1


@pytest.mark.parametrize("window_block", [1, 2])
def test_worker_partials_match_reference(window_block):
    """A worker engine's per-window block and grouped partials equal the
    reference worker engine's (counts and means bitwise, m2 within the
    var bound), on the per-window loop and on the block loop; the
    grouped stats folded through the global layout too; host syncs stay
    one per window (one per block under supersteps), partials included."""
    per = REPLICAS * len(LAMS) // WORKERS
    shard = (per, 2 * per, 2)
    kw = dict(window_block=window_block, steering=None,
              record_trajectories=False)
    je = j_build_engine(_exp(J, **kw), shard=shard)
    je.enable_block_partials()
    te = T.build_engine(_exp(T, **kw).with_(reduction=T.Reduction.ENSEMBLE),
                        device="cpu", shard=shard)
    te.enable_block_partials()
    te.run()
    assert te.n_host_syncs == N_WINDOWS // window_block
    assert te._grouped_partials == []
    tg = T.build_engine(_exp(T, **kw), device="cpu", shard=shard)
    tg.enable_block_partials()
    je.run()
    tg.run()
    for eng in (te, tg):
        assert len(eng._block_partials) == N_WINDOWS
        for a, b in zip(je._block_partials, eng._block_partials):
            assert np.asarray(a.n).tobytes() == b.n.tobytes()
            assert np.asarray(a.mean).tobytes() == b.mean.tobytes()
            assert _ulps(a.m2, b.m2) <= VAR_ULP
    assert len(tg._grouped_partials) == N_WINDOWS
    for a, b in zip(je._grouped_partials, tg._grouped_partials):
        assert b.n.shape == (2, 2, 1)
        assert np.asarray(a.n).tobytes() == b.n.tobytes()
        assert np.asarray(a.mean).tobytes() == b.mean.tobytes()
        assert _ulps(a.m2, b.m2) <= VAR_ULP
    for a, b in zip(je.grouped_stats(), tg.grouped_stats()):
        assert np.asarray(a.mean).tobytes() == b.mean.tobytes()
        assert _ulps(a.var, b.var) <= VAR_ULP


def test_worker_partials_same_on_both_loops():
    """Inside the port the block and grouped partials of the per-window
    loop and of the superstep loop are the same bits."""
    per = REPLICAS * len(LAMS) // WORKERS
    got = []
    for wb in (1, 4):
        eng = T.build_engine(_exp(T, window_block=wb, steering=None),
                             device="cpu", shard=(0, per, 1))
        eng.enable_block_partials()
        eng.run()
        got.append([np.stack(list(p)).tobytes() for p in
                    eng._block_partials + eng._grouped_partials])
    assert got[0] == got[1]


def test_worker_spec_loads_with_stdlib_pickle(tmp_path):
    """A CWCModel whose init_fn is a closure (lv8) does not pickle; the
    coordinator ships it compiled, and the spec loads with the standard
    library's pickle in a fresh interpreter and builds the same engine."""
    model = MODELS["lv8"]()
    with pytest.raises((AttributeError, pickle.PicklingError)):
        pickle.dumps(model)
    exp = T.Experiment(model=model, ensemble=T.Ensemble.make(replicas=8),
                       schedule=T.Schedule(t_end=0.01, n_windows=2))
    fc = t_coord.FarmCoordinator(
        exp, T.Recovery(ckpt_dir=str(tmp_path), workers=2), device="cpu")
    os.makedirs(tmp_path, exist_ok=True)
    sh = fc.shards[1]
    fc._write_spec(sh, torch.device("cpu"))
    code = ("import pickle, sys; s = pickle.load(open(sys.argv[1], 'rb')); "
            "print(type(s['experiment'].model).__name__, s['shard'], "
            "s['device'])")
    out = subprocess.run([sys.executable, "-c", code, sh.spec_path],
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(
                             Path(T.__file__).resolve().parents[2])))
    assert out.stdout.split() == ["CompiledModel", "(4,", "8,", "1)", "cpu"]
    with open(sh.spec_path, "rb") as f:
        spec = pickle.load(f)
    assert isinstance(spec["experiment"].model, CompiledModel)
    a = T.simulate(exp, device="cpu")
    b = T.simulate(spec["experiment"], device="cpu")
    assert a.obs_names == b.obs_names
    for ra, rb in zip(a.records, b.records):
        assert ra.mean.tobytes() == rb.mean.tobytes()


def test_worker_sent_to_a_missing_card_never_runs_on_cpu(tmp_path):
    """Workers told to use cuda:0 on a machine without a card fail; the
    coordinator sees lost hosts and finally a dead farm. Without a
    device and without a card the farm is refused at once."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    exp = _exp(T, recovery=_recovery(
        T, tmp_path / "farm", workers=2, max_worker_restarts=0),
        use_kernel=False)
    with pytest.raises(RuntimeError, match="farm dead"):
        T.simulate(exp, device="cuda:0")
    logs = "".join(open(tmp_path / "farm" / f"shard0{k}.log").read()
                   for k in range(2))
    assert "does not fall back to the CPU" in logs
    assert not any(n.endswith("__result.npz")
                   for n in os.listdir(tmp_path / "farm"))
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        T.simulate(exp)
