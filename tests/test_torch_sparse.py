"""Port parity: the sparse exact path and the Match kernel's twin.

Against the reference on the CPU, bit for bit: the sparse tables and the
packed recipe rows, the unfused sparse advance loop, the sparse window
kernel's plain twin against the reference's Pallas kernel in interpret
mode, the sparse chunk loop's chunk count and truncation flag,
`simulate(sparse=True)` pool state and record means, and the Match
kernel's twin against the reference's Pallas Match kernel.

XLA:CPU sums left to right only up to R=17 (cumsum), so models with more
reactions (ring8, R=56) are held bitwise inside the port instead: sparse
against the port's dense path. Record var/ci90 are held to the ulp bounds
of test_torch_api (XLA's float sum order over instances is not torch's).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as J
import repro_torch.api as T
from repro.core import gillespie as jg, reactions as jr
from repro.core.cwc.compile import compile_model as j_compile
from repro.core.cwc.models import MODELS as J_MODELS
from repro.kernels import ops as jops
from repro.kernels.propensity import propensity_call as j_propensity_call
from repro.kernels.propensity import reactant_onehots as j_onehots
from repro.kernels.ref import propensity_ref as j_propensity_ref
from repro.kernels.ssa_step import sparse_window_call as j_sparse_call
from repro_torch import interop
from repro_torch.core import gillespie as tg, reactions as tr
from repro_torch.core.cwc.compile import compile_model as t_compile
from repro_torch.core.cwc.models import MODELS as T_MODELS
from repro_torch.core.cwc.models import pentamer_system
from repro_torch.kernels import ops as tops
from repro_torch.kernels import propensity as tkp
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssa_step as tks

VAR_ULP = 12
CI90_ULP = 8
HORIZON = {"lv2": 0.5, "lv8": 0.05, "ecoli": 10.0, "transport": 2.0,
           "coef5": 0.5, "ring8": 0.25}
OUTS = ("x", "t", "dead", "steps", "ctr", "ctr_hi")


def coef5_pair():
    """The port's coefficient-5 system (`pentamer_system`: the dense path
    refuses it, the sparse path runs it) and the same arrays as a
    reference ReactionSystem."""
    ts = pentamer_system()
    return jr.ReactionSystem(**{f.name: getattr(ts, f.name)
                                for f in dataclasses.fields(ts)}), ts


def systems(name):
    """(reference system, port system) for a model name or "coef5"."""
    if name == "coef5":
        return coef5_pair()
    return j_compile(J_MODELS[name]())[0], t_compile(T_MODELS[name]())[0]


def model(api, name):
    if name == "coef5":
        return coef5_pair()[0 if api is J else 1]
    return (J_MODELS if api is J else T_MODELS)[name]()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a


def assert_bitwise(a, b, what=""):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape and (a == b).all(), what


def port_pool(js, jp):
    return interop.from_reference(
        {f: getattr(js, f) for f in interop.SYSTEM_FIELDS},
        {f: np.asarray(getattr(jp, f)) for f in jg.LaneState._fields},
        device="cpu")


def sweep(system, b, rng):
    return (system.rates[None] * rng.uniform(0.5, 1.5, (b, system.n_reactions))
            ).astype(np.float32)


def ulp(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


# ---------------------------------------------------------------- tables


@pytest.mark.parametrize("name", sorted(J_MODELS) + ["coef5"])
def test_sparse_tables_match_reference(name):
    js, ts = systems(name)
    ja, ta = jr.sparse_tables(js), tr.sparse_tables(ts)
    for f in ("reactant_idx", "reactant_coef", "rate_pad", "dep_idx",
              "delta_idx", "delta_val"):
        a, b = getattr(ja, f), getattr(ta, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert (a == b).all(), f
    assert ja.max_coef == ta.max_coef and ja.out_degree == ta.out_degree


@pytest.mark.parametrize("name,per_lane", [("ring8", False),
                                           ("lv8", True), ("coef5", True)])
def test_bind_sparse_step_tables_match_reference(name, per_lane, rng):
    """The packed recipe rows (int_tab, flt_tab) and padded rates."""
    js, ts = systems(name)
    rates = sweep(js, 6, rng) if per_lane else js.rates
    jb = jg.bind_sparse_step(jg.sparse_system_tensors(jr.sparse_tables(js)),
                             jnp.asarray(rates))
    tb = tg.bind_sparse_step(tg.sparse_system_tensors(tr.sparse_tables(ts)),
                             torch.from_numpy(rates))
    for a, b in zip(jb[:2], tb[:2]):
        assert a.dtype == b.numpy().dtype
        assert_bitwise(a, b.numpy())
    assert (jb[2] is None) == (tb[2] is None) == (not per_lane)
    if per_lane:
        assert_bitwise(jb[2], tb[2].numpy())
    assert jb[3:] == tb[3:]


def test_propensities_ref_matches_reference(rng):
    """The float64 oracle is the reference's exactly; the float32
    propensities (sparse unroll to max_coef) agree with it to rtol 1e-5,
    the reference's own tolerance (float32 rounding)."""
    js, ts = systems("coef5")
    x = np.asarray([[n, 3.0] for n in (0, 3, 4, 5, 9, 60)], np.float32)
    ref = tr.propensities_ref(x, ts)
    assert ref.dtype == np.float64
    assert (ref == jr.propensities_ref(x, js)).all()
    a = tr.propensities(torch.from_numpy(x),
                        torch.from_numpy(ts.reactant_idx),
                        torch.from_numpy(ts.reactant_coef),
                        torch.from_numpy(ts.rates), max_c=5)
    np.testing.assert_allclose(a.numpy(), ref, rtol=1e-5, atol=1e-8)


# ------------------------------------------------------- sparse window


def _sparse_args(js, ts, rates):
    """The reference's and the port's sparse kernel operands."""
    jsp = jg.sparse_system_tensors(jr.sparse_tables(js))
    tsp = tg.sparse_system_tensors(tr.sparse_tables(ts))
    ji, jf, jr2, max_c, d, k, _ = jg.bind_sparse_step(jsp, jnp.asarray(rates))
    tb = tops.bind_sparse_window(tsp, torch.from_numpy(rates))
    static = dict(max_c=max_c, d=d, k=k, packed_rates=jr2 is None)
    assert static == dict(max_c=tb.max_c, d=tb.d, k=tb.k,
                          packed_rates=tb.packed_rates)
    return ((jsp[0], jsp[1], ji, jf, jg.pad_rates(jnp.asarray(rates))),
            tuple(tb[:5]), static)


@pytest.mark.parametrize("name,per_lane", [
    ("lv8", False), ("lv8", True), ("ecoli", False), ("transport", True),
    ("coef5", False)])
def test_sparse_window_plain_matches_reference_kernel(name, per_lane, rng):
    """The twin against the reference's sparse Pallas kernel in
    interpret mode: the six window outputs, bit for bit."""
    js, ts = systems(name)
    b, n_steps = 40, 48
    jp = jg.init_lanes(js, b, seed=7)
    _, tp = port_pool(js, jp)
    rates = sweep(js, b, rng) if per_lane else js.rates
    jt, tt, static = _sparse_args(js, ts, rates)
    h = HORIZON[name]
    out_j = j_sparse_call(jp.x, jp.t, jp.dead.astype(jnp.int32), jp.key,
                          jp.ctr, jp.ctr_hi, *jt, h, n_steps=n_steps,
                          interpret=True, **static)
    before = tks.sparse_window_call.launches
    out_t = tks.sparse_window_call(tp.x, tp.t, tp.dead.to(torch.int32),
                                   tp.key, tp.ctr, tp.ctr_hi, *tt, h,
                                   n_steps=n_steps, **static)
    assert tks.sparse_window_call.launches == before  # CPU: the twin
    for j, t, what in zip(out_j, out_t, OUTS):
        assert_bitwise(j, t.numpy(), what)
    assert int(out_t[3].sum()) > 0


def test_sparse_twin_matches_dense_twin_on_ring8():
    """R=56: held inside the port — the sparse twin against the dense
    twin on one window, both cut by the same budget."""
    ts, _ = t_compile(T_MODELS["ring8"]())
    pool = tg.init_lanes(ts, 24, 3, device="cpu")
    tb = tops.bind_sparse_window(tg.sparse_system_tensors(
        tr.sparse_tables(ts)), torch.from_numpy(ts.rates))
    args = (pool.x, pool.t, pool.dead.to(torch.int32), pool.key, pool.ctr,
            pool.ctr_hi)
    for n_steps in (40, 4096):
        sp = tks.sparse_window_plain(
            *args, *tb[:5], 0.25, n_steps=n_steps, max_c=tb.max_c, d=tb.d,
            k=tb.k, packed_rates=tb.packed_rates)
        de = tks.ssa_window_plain(*args, *tg.system_tensors(ts, device="cpu"),
                                  0.25, n_steps=n_steps)
        for a, c, what in zip(sp, de, OUTS):
            assert_bitwise(a.numpy(), c.numpy(), what)


@pytest.mark.parametrize("name,per_lane,max_steps", [
    ("lv8", False, None), ("ecoli", True, None), ("coef5", False, 7)])
def test_sparse_advance_fn_matches_reference(name, per_lane, max_steps, rng):
    """The unfused sparse loop (`make_sparse_advance_fn`) against the
    reference's `make_advance_fn(sparse=...)`: the whole pool, bit for
    bit, run to the horizon or cut at max_steps."""
    js, ts = systems(name)
    b = 16
    jp = jg.init_lanes(js, b, seed=6)
    _, tp = port_pool(js, jp)
    rates = sweep(js, b, rng) if per_lane else js.rates
    h = np.float32(HORIZON[name])
    jsp = jg.sparse_system_tensors(jr.sparse_tables(js))
    jo = jg.make_advance_fn(None, None, max_steps, sparse=jsp)(
        jp, jnp.asarray(rates), jnp.float32(h))
    to = tg.make_sparse_advance_fn(
        tg.sparse_system_tensors(tr.sparse_tables(ts)), max_steps)(
        tp, torch.from_numpy(rates), torch.tensor(h))
    for f in ("x", "t", "ctr", "ctr_hi", "steps", "dead"):
        assert_bitwise(getattr(jo, f), getattr(to, f).numpy(), f)
    assert int(to.steps.sum()) > 0


def test_set_rates_rebinds_sparse_kernel_tables(rng):
    """Rates installed after the engine is built reach the sparse kernel
    path's bound tables: it matches the unfused sparse loop under the
    same rates, and differs from a run left at the model's rates."""
    ts, _ = t_compile(T_MODELS["ring8"]())
    exp = T.Experiment(model=T_MODELS["ring8"](),
                       ensemble=T.Ensemble.make(replicas=16),
                       schedule=T.Schedule(t_end=0.5, n_windows=2),
                       n_lanes=8, seed=3, sparse=True)
    rates = sweep(ts, 16, rng) * np.float32(2.0)

    def means(use_kernel, set_rates):
        eng = T.build_engine(exp.with_(use_kernel=use_kernel), device="cpu")
        if set_rates:
            eng.set_rates(rates)
        return [eng.run_window().mean.tobytes() for _ in range(2)]

    kernel = means(True, True)
    assert kernel == means(False, True)
    assert kernel != means(True, False)


@pytest.mark.parametrize("name", ["lv8", "ecoli", "coef5"])
def test_sparse_window_chunk_loop_matches_reference(name, rng):
    """Three windows with sweep rates through the sparse fused window:
    pool state, chunk count and truncation flag equal the reference's
    device-side chunk loop (chunk_steps=32)."""
    js, ts = systems(name)
    jp = jg.init_lanes(js, 16, seed=4)
    _, tp = port_pool(js, jp)
    rates = sweep(js, 16, rng)
    jt = jg.system_tensors(js, rates, require_dense=False)
    jsp = jg.sparse_system_tensors(jr.sparse_tables(js))
    tb = tops.bind_sparse_window(
        tg.sparse_system_tensors(tr.sparse_tables(ts)),
        torch.from_numpy(rates))
    jloop = jax.jit(partial(jops.sparse_window_chunk_loop, sp=jsp,
                            chunk_steps=32, max_chunks=64, interpret=True))
    for w in range(1, 4):
        h = np.float32(HORIZON[name] * w)
        jo = jloop(jp, jt, h)
        to = tops.sparse_window_chunk_loop(tp, tb, h, chunk_steps=32,
                                           max_chunks=64)
        jp, tp = jo.state, to.state
        for f in ("x", "t", "ctr", "ctr_hi", "steps", "dead"):
            assert_bitwise(getattr(jp, f), getattr(tp, f).numpy(), f)
        assert int(jo.n_chunks) == int(to.n_chunks) >= 1
        assert bool(jo.truncated) is bool(to.truncated) is False


def test_sparse_chunk_loop_truncation_matches_reference():
    """A budget too small for the window: both stop with live lanes,
    report the same chunk count, and hold the same partial state."""
    js, ts = systems("lv2")
    jp = jg.init_lanes(js, 8, seed=2)
    _, tp = port_pool(js, jp)
    jsp = jg.sparse_system_tensors(jr.sparse_tables(js))
    tb = tops.bind_sparse_window(
        tg.sparse_system_tensors(tr.sparse_tables(ts)),
        torch.from_numpy(ts.rates))
    jo = jops.sparse_window_chunk_loop(jp, jg.system_tensors(js), 0.5,
                                       sp=jsp, chunk_steps=4, max_chunks=3,
                                       interpret=True)
    to = tops.sparse_window_chunk_loop(tp, tb, 0.5, chunk_steps=4,
                                       max_chunks=3)
    assert bool(jo.truncated) and bool(to.truncated)
    assert int(jo.n_chunks) == int(to.n_chunks) == 3
    for f in ("x", "t", "ctr", "steps", "dead"):
        assert_bitwise(getattr(jo.state, f), getattr(to.state, f).numpy(), f)


def test_sparse_window_is_one_kernel_call(monkeypatch):
    """The sparse fused window reaches sparse_window_call exactly once,
    with the whole budget chunk_steps * max_chunks."""
    calls = []
    real = tops.sparse_window_call

    def spy(*a, **kw):
        calls.append(kw["n_steps"])
        return real(*a, **kw)

    monkeypatch.setattr(tops, "sparse_window_call", spy)
    ts, _ = t_compile(T_MODELS["ring8"]())
    pool = tg.init_lanes(ts, 8, 0, device="cpu")
    tb = tops.bind_sparse_window(
        tg.sparse_system_tensors(tr.sparse_tables(ts)),
        torch.from_numpy(ts.rates))
    out = tops.sparse_window_chunk_loop(pool, tb, 0.1, chunk_steps=16,
                                        max_chunks=8)
    assert calls == [128]
    assert not bool(out.truncated)


def test_sparse_window_call_rejects_other_devices():
    ts, _ = t_compile(T_MODELS["lv2"]())
    pool = tg.init_lanes(ts, 4, 0, device="meta")
    tb = tops.bind_sparse_window(
        tg.sparse_system_tensors(tr.sparse_tables(ts), device="meta"),
        torch.zeros(ts.n_reactions, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tks.sparse_window_call(
            pool.x, pool.t, pool.dead.to(torch.int32), pool.key, pool.ctr,
            pool.ctr_hi, *tb[:5], 0.1, n_steps=4, max_c=tb.max_c, d=tb.d,
            k=tb.k, packed_rates=tb.packed_rates)


# ------------------------------------------------------------ simulate


def _simulate_both(name, **kw):
    out = []
    for api in (J, T):
        exp = api.Experiment(
            model=model(api, name), ensemble=api.Ensemble.make(replicas=16),
            schedule=api.Schedule(t_end=3 * HORIZON[name], n_windows=3),
            n_lanes=8, seed=5, sparse=True, **kw)
        out.append(api.simulate(exp, **({} if api is J
                                         else {"device": "cpu"})))
    return out


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ["lv8", "ecoli", "transport", "coef5"])
def test_simulate_sparse_matches_reference(name, use_kernel):
    """simulate(sparse=True) against the reference's: record means and
    the final populations bit for bit, var/ci90 to the ulp bound, and
    the same events per window."""
    kw = dict(use_kernel=True, kernel_chunk_steps=64,
              kernel_max_chunks=4096) if use_kernel else {}
    jres, tres = _simulate_both(name, **kw)
    assert tres.completed and len(tres.records) == 3
    for a, b in zip(jres.records, tres.records):
        assert (a.t, a.window, a.n) == (b.t, b.window, b.n)
        assert a.mean.tobytes() == b.mean.tobytes()
        assert ulp(a.var, b.var) <= VAR_ULP
        assert ulp(a.ci90, b.ci90) <= CI90_ULP
    assert (tres.final_state() == jres.final_state()).all()
    jpool, tpool = jres._engine._pool, tres._engine._pool
    for f in ("t", "ctr", "ctr_hi", "steps", "dead"):
        assert_bitwise(getattr(jpool, f), getattr(tpool, f).numpy(), f)
    assert tres.telemetry.steps_per_window == \
        jres.telemetry.steps_per_window


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ring8_sparse_matches_port_dense(use_kernel):
    """R=56 is past XLA's left-to-right range, so ring8's sparse path is
    held against the port's own dense path: records, trajectories and
    events per window, bit for bit."""
    def run(sparse):
        return T.simulate(T.Experiment(
            model=T_MODELS["ring8"](), ensemble=T.Ensemble.make(replicas=32),
            schedule=T.Schedule(t_end=0.5, n_windows=2), n_lanes=16, seed=2,
            record_trajectories=True, use_kernel=use_kernel, sparse=sparse),
            device="cpu")

    dense, sparse = run(False), run(True)
    for a, b in zip(dense.records, sparse.records):
        for f in ("mean", "var", "ci90"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert (dense.trajectories() == sparse.trajectories()).all()
    assert dense.telemetry.steps_per_window == \
        sparse.telemetry.steps_per_window
    assert sum(sparse.telemetry.steps_per_window) > 0


def test_coef5_runs_sparse_only():
    exp = T.Experiment(model=pentamer_system(),
                       ensemble=T.Ensemble.make(replicas=4),
                       schedule=T.Schedule(t_end=1.0, n_windows=2))
    with pytest.raises(T.ExperimentError, match="sparse=True"):
        T.simulate(exp, device="cpu")
    res = T.simulate(exp.with_(sparse=True, use_kernel=True), device="cpu")
    assert res.completed and (res.final_state() >= 0).all()


# --------------------------------------------------------------- Match


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("name", ["lv8", "ecoli", "transport", "ring8"])
def test_propensity_plain_matches_reference_kernel(name, per_lane, rng):
    """The Match twin (rates last) against the reference's Pallas Match
    kernel in interpret mode, bit for bit; its oracle port against the
    reference's oracle bit for bit; and twin against oracle to rtol
    1e-6, the reference's own tolerance (the two orders can differ in
    the last bit)."""
    js, ts = systems(name)
    b = 33
    x = rng.integers(0, 50, (b, js.n_species)).astype(np.float32)
    rates = sweep(js, b, rng) if per_lane else js.rates
    e = tkp.reactant_onehots(ts)
    assert (e == j_onehots(js)).all()
    a_j = j_propensity_call(jnp.asarray(x), jnp.asarray(e),
                            jnp.asarray(js.reactant_coef.T, jnp.float32),
                            jnp.asarray(rates), interpret=True)
    tens = tops.system_kernel_tensors(ts, device="cpu")
    before = tkp.propensity_call.launches
    a_t = tops.propensity(torch.from_numpy(x), tens, torch.from_numpy(rates))
    assert tkp.propensity_call.launches == before  # CPU: the twin
    assert_bitwise(a_j, a_t.numpy())
    r_j = j_propensity_ref(jnp.asarray(x), jnp.asarray(js.reactant_idx),
                           jnp.asarray(js.reactant_coef), jnp.asarray(rates))
    r_t = tref.propensity_ref(torch.from_numpy(x), tens[0], tens[1],
                              torch.from_numpy(rates))
    assert_bitwise(r_j, r_t.numpy())
    np.testing.assert_allclose(a_t.numpy(), r_t.numpy(), rtol=1e-6)


def test_system_kernel_tensors_refuse_large_coefficients():
    with pytest.raises(ValueError, match="sparse=True"):
        tops.system_kernel_tensors(pentamer_system())
