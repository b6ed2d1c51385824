"""Checkpoints in the port against the reference: the single-file store
(`repro_torch.ckpt.store` against `repro.ckpt.store`: digest, files
that verify across packages, corruption, namespaces, retention), the
engine's checkpoint file (keys, dtypes, shapes, values), resume across
packages in both directions, and the legacy and refused files.

Record means are exact sums of integer populations, so they are held
bit for bit; var and ci90 to the ulp bound of test_torch_reduction.
"""
import os

import numpy as np
import pytest

import repro.api as J
import repro_torch.api as T
from repro.ckpt import store as j_store
from repro.core.cwc.models import MODELS as J_MODELS
from repro_torch.ckpt import store as t_store
from repro_torch.core.cwc.models import MODELS as T_MODELS
from repro_torch.interop import to_reference_arrays

VAR_ULP = 12
CI90_ULP = 8
STORES = {"reference": j_store, "port": t_store}
POOL = ("x", "t", "key", "ctr", "ctr_hi", "steps", "leaps", "dead",
        "no_leap")


def ulp(a, b) -> int:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _arrays():
    rng = np.random.default_rng(3)
    return {"x": rng.random((5, 3), dtype=np.float32),
            "key": rng.integers(0, 2**32, (5, 2), dtype=np.uint32),
            "steps": rng.integers(0, 99, (5,), dtype=np.int32),
            "dead": rng.random(5) < 0.5, "window": np.int64(7),
            "cost": rng.random(5), "empty": np.zeros((0, 4), np.float32)}


# ------------------------------------------------------------- store
def test_digest_matches_reference():
    arrays = _arrays()
    assert t_store._digest_arrays(arrays) == j_store._digest_arrays(arrays)
    assert (t_store._CKPT_MAGIC, t_store._MAGIC_KEY, t_store._SHA_KEY) == (
        j_store._CKPT_MAGIC, j_store._MAGIC_KEY, j_store._SHA_KEY)
    arrays["x"] = arrays["x"].T  # layout-independent content digest
    assert t_store._digest_arrays(arrays) == j_store._digest_arrays(arrays)


@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port")])
def test_files_verify_across_packages(tmp_path, writer, reader):
    arrays = _arrays()
    path = STORES[writer].save_atomic(str(tmp_path / "ck"), arrays)
    assert path.endswith("ck.npz") and os.listdir(tmp_path) == ["ck.npz"]
    got = STORES[reader].verify(path, required=("x", "window"))
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        assert got[k].tobytes() == np.asarray(v).tobytes(), k


def _corrupt(path, mode):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    if mode == "truncated":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        return "unreadable"
    if mode == "bad_magic":
        arrays["__ckpt_magic__"] = np.frombuffer(b"NOT-A-CKPT", np.uint8)
        np.savez(path, **arrays)
        return "bad magic"
    if mode == "checksum":  # content changed, stored digest kept
        arrays["steps"] = arrays["steps"] + 1
        np.savez(path, **arrays)
        return "checksum mismatch"
    return "missing required key"


@pytest.mark.parametrize("package", ["reference", "port"])
@pytest.mark.parametrize("mode", ["truncated", "bad_magic", "checksum",
                                  "missing_key"])
def test_corruption_raises_naming_the_path(tmp_path, mode, package):
    """Each failure raises CheckpointCorrupt naming the path and the
    failure, with the same words in both packages; the port's verify
    reads files written by the reference's save_atomic."""
    path = j_store.save_atomic(str(tmp_path / "shard01__ckpt_00000002"),
                               _arrays())
    words = _corrupt(path, mode)
    store = STORES[package]
    with pytest.raises(store.CheckpointCorrupt, match=words) as e:
        store.verify(path, required=("x", "window", "nope"))
    assert "shard01__ckpt_00000002.npz" in str(e.value)


def test_missing_file_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        t_store.verify(str(tmp_path / "absent"))


# the namespaced stores of tests/test_ckpt.py, in both packages
def _save_ckpt(store, tmp_path, window, namespace=""):
    path = os.path.join(str(tmp_path),
                        store.checkpoint_name(window, namespace))
    return store.save_atomic(path, {"window": np.int64(window),
                                    "x": np.arange(4.0)})


@pytest.mark.parametrize("package", ["reference", "port"])
def test_namespaced_stores_coexist_in_one_dir(tmp_path, package):
    store = STORES[package]
    for w in (0, 2, 4):
        _save_ckpt(store, tmp_path, w, "shard00")
    for w in (0, 2):
        _save_ckpt(store, tmp_path, w, "shard01")
    _save_ckpt(store, tmp_path, 6)
    assert [w for w, _ in t_store.list_checkpoints(
        str(tmp_path), "shard00")] == [0, 2, 4]
    assert [w for w, _ in t_store.list_checkpoints(
        str(tmp_path), "shard01")] == [0, 2]
    assert [w for w, _ in t_store.list_checkpoints(str(tmp_path))] == [6]
    assert t_store.checkpoint_name(4, "shard00") == \
        j_store.checkpoint_name(4, "shard00") == "shard00__ckpt_00000004.npz"


@pytest.mark.parametrize("package", ["reference", "port"])
def test_retention_prunes_only_its_own_namespace(tmp_path, package):
    for w in (0, 2, 4, 6):
        _save_ckpt(STORES[package], tmp_path, w, "shard00")
        _save_ckpt(STORES[package], tmp_path, w, "shard01")
    removed = t_store.RetentionPolicy(keep_last=2).apply(
        str(tmp_path), "shard00")
    assert len(removed) == 2
    assert all("shard00__" in os.path.basename(p) for p in removed)
    assert [w for w, _ in t_store.list_checkpoints(
        str(tmp_path), "shard00")] == [4, 6]
    assert [w for w, _ in t_store.list_checkpoints(
        str(tmp_path), "shard01")] == [0, 2, 4, 6]
    with pytest.raises(ValueError, match="keep_last"):
        t_store.RetentionPolicy(keep_last=0).validate()


def test_listing_ignores_foreign_and_partial_files(tmp_path):
    _save_ckpt(t_store, tmp_path, 2, "shard00")
    for name in ("shard00__ckpt_4.npz.tmp.1234", "notackpt_3.npz",
                 "shard00__result.npz", "hb_shard00.json"):
        with open(os.path.join(str(tmp_path), name), "wb") as f:
            f.write(b"partial")
    for store in STORES.values():
        assert [w for w, _ in store.list_checkpoints(
            str(tmp_path), "shard00")] == [2]
        assert store.list_checkpoints(str(tmp_path)) == []


def test_namespace_rejects_underscores(tmp_path):
    with pytest.raises(ValueError, match="namespace"):
        t_store.list_checkpoints(str(tmp_path), "bad_name")
    with pytest.raises(ValueError, match="namespace"):
        t_store.checkpoint_name(2, "bad_name")


# ------------------------------------------------- engine checkpoints
CASES = {  # (model, method) -> t_end over 4 windows
    ("lv2", "exact"): 0.1, ("lv8", "exact"): 0.1, ("ecoli", "exact"): 20.0,
    ("transport", "exact"): 4.0, ("lv2", "tau_leap"): 1.5,
    ("lv8", "tau_leap"): 0.45, ("transport", "tau_leap"): 4.0}


def make_exp(api, name="lv2", method="exact", replicas=16, sweep=None,
             schema="iii", policy="on_demand", **kw):
    models = J_MODELS if api is J else T_MODELS
    return api.Experiment(
        model=models[name](),
        ensemble=api.Ensemble.make(replicas=replicas, sweep=sweep),
        schedule=api.Schedule(t_end=CASES.get((name, method), 0.1),
                              n_windows=4, schema=schema, policy=policy),
        n_lanes=8, seed=5, method=method,
        # the port's kernel path runs its plain twin here; the
        # reference's jitted unfused path gives the same bits
        use_kernel=api is T, **kw)


def run(exp, **kw):
    if isinstance(exp, T.Experiment):
        return T.simulate(exp, device="cpu", **kw)
    return J.simulate(exp, **kw)


def pool_arrays(res) -> dict:
    eng = res._engine
    if isinstance(res, T.SimulationResult):
        return to_reference_arrays(eng.system, eng._pool)[1]
    return {f: np.asarray(getattr(eng._pool, f)) for f in POOL}


def assert_same_run(clean, got, ctx):
    """Pool state bitwise; record means bitwise, var/ci90 to the ulp
    bound (bitwise where both come from one package)."""
    pa, pb = pool_arrays(clean), pool_arrays(got)
    for f in POOL:
        assert pa[f].dtype == pb[f].dtype, (ctx, f)
        assert pa[f].tobytes() == pb[f].tobytes(), (ctx, f)
    assert len(clean.records) == len(got.records) == 4, ctx
    for a, b in zip(clean.records, got.records):
        assert (a.t, a.window, a.n) == (b.t, b.window, b.n), ctx
        assert a.mean.tobytes() == b.mean.tobytes(), ctx
        assert ulp(a.var, b.var) <= VAR_ULP, ctx
        assert ulp(a.ci90, b.ci90) <= CI90_ULP, ctx


_CLEAN = {}


def clean_reference(name, method):
    if (name, method) not in _CLEAN:
        _CLEAN[name, method] = run(make_exp(J, name, method))
    return _CLEAN[name, method]


@pytest.mark.parametrize("name,method", list(CASES))
def test_reference_checkpoint_resumes_in_the_port(tmp_path, name, method):
    """A checkpoint the reference wrote after 2 windows, restored in the
    port and run to the end: the reference's uninterrupted run."""
    ck = str(tmp_path / "ck")
    run(make_exp(J, name, method), max_windows=2, checkpoint_path=ck)
    got = run(make_exp(T, name, method), checkpoint_path=ck, resume=True)
    assert got.completed
    assert_same_run(clean_reference(name, method), got, (name, method))
    if method == "tau_leap" and name != "transport":
        # transport's populations are too small to leap: every tau
        # iteration there takes the exact fallback
        assert sum(got.telemetry.leaps_per_window) > 0


@pytest.mark.parametrize("name,method", list(CASES))
def test_port_checkpoint_resumes_in_the_reference(tmp_path, name, method):
    """A checkpoint the port wrote (with supersteps, from a ring
    snapshot) after 2 windows, restored in the reference and run to the
    end: the reference's uninterrupted run."""
    ck = str(tmp_path / "ck")
    cut = run(make_exp(T, name, method, window_block=2, pipeline_depth=2),
              max_windows=2, checkpoint_path=ck)
    assert cut.telemetry.ckpt_flushes == 0
    got = run(make_exp(J, name, method), checkpoint_path=ck, resume=True)
    assert_same_run(clean_reference(name, method), got, (name, method))


BASE_KEYS = {"x", "t", "key", "ctr", "ctr_hi", "steps", "leaps", "dead",
             "no_leap", "window", "cost", "rates", "rec_t", "rec_window",
             "rec_mean", "rec_var", "rec_ci90", "rec_n"}


@pytest.mark.parametrize("kw,extra", [
    (dict(), set()),
    (dict(name="ecoli", schema="ii"), {"samples"}),
    (dict(policy="predictive"), set()),
    (dict(replicas=8, sweep={"die": [0.3, 1.2]}, per_point=True),
     {"group_ids", "grouped_n", "grouped_mean", "grouped_var",
      "grouped_ci90"}),
], ids=["iii", "samples", "predictive", "per_point"])
def test_port_file_has_the_reference_keys_dtypes_and_values(tmp_path, kw,
                                                            extra):
    """After the same windows the port's file has the reference's keys,
    dtypes and shapes, and its values bit for bit, apart from the
    variances and ci90s (held to the ulp bound)."""
    files = {}
    for api in (J, T):
        akw = dict(kw)
        if akw.pop("per_point", False):
            akw["reduction"] = api.Reduction.PER_POINT
        ck = str(tmp_path / api.__name__)
        run(make_exp(api, **akw), max_windows=3, checkpoint_path=ck)
        files[api] = j_store.verify(ck)
    jz, tz = files[J], files[T]
    assert sorted(jz) == sorted(tz) == sorted(BASE_KEYS | extra)
    for k in jz:
        assert jz[k].dtype == tz[k].dtype, k
        assert jz[k].shape == tz[k].shape, k
        if k in ("rec_var", "rec_ci90", "grouped_var", "grouped_ci90"):
            assert ulp(jz[k], tz[k]) <= VAR_ULP, k
        else:
            assert jz[k].tobytes() == tz[k].tobytes(), k
    assert int(tz["window"]) == 3 and tz["rec_t"].shape == (3,)
    if "policy" in kw:
        assert tz["cost"].any()


# ------------------------------------------------ legacy and refused
@pytest.mark.parametrize("drop", [
    ("ctr", "ctr_hi", "leaps", "no_leap"), ("ctr_hi", "leaps", "no_leap"),
    ()], ids=["no_counters", "no_high_words", "no_magic"])
def test_legacy_files_restore(tmp_path, drop):
    """Raw np.savez files (no magic tag: the legacy branch) without
    `ctr`, `ctr_hi`, `leaps` or `no_leap` restore with zeros or False,
    in both packages alike. Without `ctr` the streams restart at draw
    0 (not the uninterrupted run); without the rest the run is bitwise
    the uninterrupted one."""
    ck = str(tmp_path / "ck")
    run(make_exp(T), max_windows=2, checkpoint_path=ck)
    z = dict(t_store.verify(ck))
    for k in drop:
        del z[k]
    # one copy each: a resumed run checkpoints over its file
    for who in ("port", "reference"):
        np.savez(str(tmp_path / f"{who}.npz"), **z)
    got = run(make_exp(T), checkpoint_path=str(tmp_path / "port"),
              resume=True)
    if "ctr" in drop:
        ref = run(make_exp(J), checkpoint_path=str(tmp_path / "reference"),
                  resume=True)
        assert_same_run(ref, got, drop)
        assert pool_arrays(got)["x"].tobytes() != pool_arrays(
            clean_reference("lv2", "exact"))["x"].tobytes()
    else:
        assert_same_run(clean_reference("lv2", "exact"), got, drop)


@pytest.mark.parametrize("key,item", [
    ("sketch_hist", "item 12"), ("steer_stopped", "item 13"),
    ("bp_n", "item 16"), ("gpp_mean", "item 16")])
def test_files_of_unported_features_are_refused(tmp_path, key, item):
    ck = str(tmp_path / "ck")
    run(make_exp(T), max_windows=2, checkpoint_path=ck)
    z = dict(t_store.verify(ck))
    z[key] = np.zeros((2, 3), np.int32)
    t_store.save_atomic(ck, z)
    eng = T.build_engine(make_exp(T), device="cpu")
    with pytest.raises(T.ExperimentError,
                       match=f"{key}.*not ported.*{item}"):
        eng.restore(ck)
    assert eng._window == 0 and eng.stream.records() == []
    with pytest.raises(T.ExperimentError, match=item):
        run(make_exp(T), checkpoint_path=ck, resume=True)
