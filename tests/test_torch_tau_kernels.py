"""Port parity: the tau-leap windows (`kernels.ssa_step.tau_window_call`,
`sparse_tau_window_call` and their plain twins) and their chunk loops.

Against the reference on the CPU, bit for bit: each twin against the
reference's Pallas kernel in interpret mode, and the chunk loops'
chunk count and truncation flag against the reference's device-side
chunk loop. Inside the port, always bitwise: tau-leaping with an
unreachable leap threshold is exact SSA, the sparse tau path is the
dense one, and any chunking or a second run with the same seed gives
the same result. On the CPU the wrappers run the twins and count no
launch.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.api as T
from repro.core import gillespie as jg
from repro.core import tau_leap as jt
from repro.core.cwc.compile import compile_model as j_compile
from repro.core.cwc.models import MODELS as J_MODELS
from repro.kernels import ops as jops
from repro.kernels.ssa_step import sparse_tau_window_call as j_sparse_tau
from repro.kernels.ssa_step import tau_window_call as j_tau
from repro_torch import interop
from repro_torch.core import gillespie as tg
from repro_torch.core import tau_leap as tt
from repro_torch.core.cwc.compile import compile_model as t_compile
from repro_torch.core.cwc.models import MODELS as T_MODELS
from repro_torch.core.cwc.models import pentamer_system
from repro_torch.core.reactions import make_system
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssa_step as tks

OUTS = ("x", "t", "dead", "steps", "leaps", "ctr", "ctr_hi")
POOL = ("x", "t", "dead", "ctr", "ctr_hi", "steps", "leaps")


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


def lv8_pool(b, rng, no_leap=False):
    """lv8 and a reference pool of b lanes with random large populations
    (so that lanes leap from the start) and a half-set no_leap mask."""
    js = j_compile(J_MODELS["lv8"]())[0]
    jp = jg.init_lanes(js, b, seed=7)
    jp = jp._replace(
        x=jnp.asarray(rng.integers(50, 800, (b, 8)).astype(np.float32)),
        no_leap=jnp.asarray((np.arange(b) % 2 == 1) if no_leap
                            else np.zeros(b, bool)))
    return js, jp


def _reference_tables(js, rates):
    idx, coef, delta, _ = jg.system_tensors(js)
    return (idx, coef, delta, jnp.asarray(rates),
            jnp.asarray(jt.gi_tables(js)), jnp.asarray(jt.reactant_mask(js)))


def _port_args(tp, tables, rates):
    return (tp.x, tp.t, tp.dead.to(torch.int32), tp.no_leap.to(torch.int32),
            tp.key, tp.ctr, tp.ctr_hi, *tables[:6], torch.from_numpy(rates),
            tables.gi, tables.rmask)


@pytest.mark.parametrize("sparse,per_lane,no_leap,b", [
    (False, False, False, 33), (False, True, True, 64),
    (True, False, True, 40), (True, True, False, 48)])
def test_tau_window_plain_matches_reference_kernel(sparse, per_lane, no_leap,
                                                   b, rng):
    """The dense and sparse twins against the reference's tau Pallas
    kernels in interpret mode on lv8: the seven window outputs, bit for
    bit; and the wrapper on CPU tensors is the twin (no launch)."""
    js, jp = lv8_pool(b, rng, no_leap)
    rates = (js.rates[None] * rng.uniform(0.5, 1.5, (b, js.n_reactions))
             ).astype(np.float32) if per_lane else js.rates
    idx, coef, delta, jrates, gi, rmask = _reference_tables(js, rates)
    n_steps, h = 40, 0.3
    common = (jp.x, jp.t, jp.dead.astype(jnp.int32),
              jp.no_leap.astype(jnp.int32), jp.key, jp.ctr, jp.ctr_hi)
    kw = dict(n_steps=n_steps, eps=0.03, fallback=10.0)
    ts, tp = port_pool(js, jp)
    tables = tt.tau_tables(ts, sparse=sparse)
    args = _port_args(tp, tables, np.asarray(rates))
    if sparse:
        out_j = j_sparse_tau(*common, idx, coef, delta, jrates, gi, rmask, h,
                             max_c=2, interpret=True, **kw)
        call, plain = tks.sparse_tau_window_call, tks.sparse_tau_window_plain
        kw["max_c"] = tables.max_c
    else:
        e, ck = jt.onehot_tensors(idx, coef, js.n_species)
        out_j = j_tau(*common, e, ck, delta, jrates, gi, rmask, h,
                      interpret=True, **kw)
        call, plain = tks.tau_window_call, tks.tau_window_plain
    before = call.launches
    out_t = call(*args, h, **kw)
    assert call.launches == before  # CPU: the twin
    for j, t, what in zip(out_j, out_t, OUTS):
        assert_bitwise(j, t.numpy(), what)
    assert int(out_t[4].sum()) > 0  # leaps
    p = plain(*args, h, **kw)
    for a, c in zip(out_t, p):
        assert torch.equal(a, c)
    # each lane's active iterations: live at the start of each
    assert int(out_t[7].max()) <= n_steps and int(out_t[7].min()) >= 1


@pytest.mark.parametrize("sparse", [False, True])
def test_tau_chunk_loop_matches_reference(sparse, rng):
    """Three windows with sweep rates through the tau fused window: pool
    state, chunk count and truncation flag equal the reference's
    device-side chunk loop (chunk_steps=16)."""
    js = j_compile(J_MODELS["lv8"]())[0]
    jp = jg.init_lanes(js, 16, seed=4)
    ts, tp = port_pool(js, jp)
    rates = (js.rates[None] * rng.uniform(0.5, 1.5, (16, js.n_reactions))
             ).astype(np.float32)
    jtens = jg.system_tensors(js, rates)
    gi, rmask = (jnp.asarray(jt.gi_tables(js)),
                 jnp.asarray(jt.reactant_mask(js)))
    loop = (partial(jops.sparse_tau_window_chunk_loop, max_c=2) if sparse
            else jops.tau_window_chunk_loop)
    jloop = jax.jit(partial(loop, gi=gi, rmask=rmask, eps=0.03,
                            fallback=10.0, chunk_steps=16, max_chunks=64,
                            interpret=True))
    tloop = tops.sparse_tau_window_chunk_loop if sparse \
        else tops.tau_window_chunk_loop
    tables = tt.tau_tables(ts, sparse=sparse)
    for w in range(1, 4):
        h = np.float32(0.2 * w)
        jo = jloop(jp, jtens, h)
        to = tloop(tp, tables, h, rates=torch.from_numpy(rates), eps=0.03,
                   fallback=10.0, chunk_steps=16, max_chunks=64)
        jp, tp = jo.state, to.state
        for f in POOL:
            assert_bitwise(getattr(jp, f), getattr(tp, f).numpy(), f)
        assert int(jo.n_chunks) == int(to.n_chunks) >= 1
        assert bool(jo.truncated) is bool(to.truncated) is False
    assert int(tp.leaps.sum()) > 0


@pytest.mark.parametrize("sparse", [False, True])
def test_tau_chunk_loop_truncation_matches_reference(sparse, rng):
    """A budget too small for the window (chunk_steps=4, max_chunks=3):
    both stop with live lanes, report the same chunk count, and hold the
    same partial state."""
    js, jp = lv8_pool(8, rng)
    ts, tp = port_pool(js, jp)
    gi, rmask = (jnp.asarray(jt.gi_tables(js)),
                 jnp.asarray(jt.reactant_mask(js)))
    loop = (partial(jops.sparse_tau_window_chunk_loop, max_c=2) if sparse
            else jops.tau_window_chunk_loop)
    jo = loop(jp, jg.system_tensors(js), 0.5, gi=gi, rmask=rmask, eps=0.03,
              fallback=10.0, chunk_steps=4, max_chunks=3, interpret=True)
    tloop = tops.sparse_tau_window_chunk_loop if sparse \
        else tops.tau_window_chunk_loop
    to = tloop(tp, tt.tau_tables(ts, sparse=sparse), 0.5,
               rates=torch.from_numpy(ts.rates), eps=0.03, fallback=10.0,
               chunk_steps=4, max_chunks=3)
    assert bool(jo.truncated) and bool(to.truncated)
    assert int(jo.n_chunks) == int(to.n_chunks) == 3
    for f in POOL:
        assert_bitwise(getattr(jo.state, f), getattr(to.state, f).numpy(), f)


def test_tau_window_is_one_kernel_call(monkeypatch):
    """The tau fused window reaches tau_window_call exactly once, with
    the whole budget chunk_steps * max_chunks and the pool's no_leap."""
    calls = []
    real = tops.tau_window_call

    def spy(*a, **kw):
        calls.append((kw["n_steps"], a[3].tolist()))
        return real(*a, **kw)

    monkeypatch.setattr(tops, "tau_window_call", spy)
    ts, _ = t_compile(T_MODELS["lv2"]())
    pool = tg.init_lanes(ts, 4, 0, device="cpu")
    pool = pool._replace(no_leap=torch.tensor([False, True, False, True]))
    out = tops.tau_window_chunk_loop(pool, tt.tau_tables(ts), 0.1,
                                     rates=torch.from_numpy(ts.rates),
                                     eps=0.03, fallback=10.0, chunk_steps=64,
                                     max_chunks=64)
    assert calls == [(4096, [0, 1, 0, 1])]
    assert not bool(out.truncated)
    assert torch.equal(out.state.no_leap, pool.no_leap)


@pytest.mark.parametrize("call", ["tau_window_call",
                                  "sparse_tau_window_call"])
def test_tau_window_calls_reject_other_devices(call):
    ts, _ = t_compile(T_MODELS["lv2"]())
    pool = tg.init_lanes(ts, 4, 0, device="meta")
    tables = tt.tau_tables(ts, device="meta")
    kw = dict(n_steps=4, eps=0.03, fallback=10.0)
    if call.startswith("sparse"):
        kw["max_c"] = tables.max_c
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(tks, call)(
            pool.x, pool.t, pool.dead.to(torch.int32),
            pool.no_leap.to(torch.int32), pool.key, pool.ctr, pool.ctr_hi,
            *tables[:6], torch.zeros(ts.n_reactions, device="meta"),
            tables.gi, tables.rmask, 0.1, **kw)


# ---------------------------------------------- bitwise inside the port


def _tau(model, **kw):
    kw.setdefault("method", T.Method.TAU_LEAP)
    kw.setdefault("record_trajectories", True)
    return T.simulate(T.Experiment(
        model=model, ensemble=T.Ensemble.make(replicas=kw.pop("replicas",
                                                                16)),
        schedule=T.Schedule(t_end=kw.pop("t_end", 0.5),
                            n_windows=kw.pop("windows", 3)),
        n_lanes=8, seed=kw.pop("seed", 5), **kw), device="cpu")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ["lv8", "ecoli", "pure_birth"])
def test_tau_with_unreachable_threshold_is_exact_ssa(name, use_kernel):
    """tau_fallback = inf: every step is the exact fallback, so the tau
    path reproduces exact SSA bit for bit — records, trajectories, the
    final pool, no leaps. Pure birth consumes no species (its Cao bound
    is vacuous), so only the clamped leap gate keeps it exact."""
    model = (make_system(["A"], [({}, {"A": 1}, 100.0)], {"A": 0})
             if name == "pure_birth" else T_MODELS[name]())
    t_end = {"lv8": 0.3, "ecoli": 20.0, "pure_birth": 0.5}[name]
    ex = _tau(model, method=T.Method.EXACT, use_kernel=use_kernel,
              t_end=t_end)
    tl = _tau(model, tau_fallback=float("inf"), use_kernel=use_kernel,
              t_end=t_end)
    assert sum(tl.telemetry.leaps_per_window) == 0
    assert (ex.means() == tl.means()).all()
    assert (ex.trajectories() == tl.trajectories()).all()
    for f in ("x", "t", "ctr", "ctr_hi", "steps", "dead"):
        assert torch.equal(getattr(ex._engine._pool, f),
                           getattr(tl._engine._pool, f)), f


@pytest.mark.parametrize("name,kw", [
    ("lv8", dict(t_end=0.45, replicas=8)),
    ("ecoli", dict(t_end=60.0, windows=2, replicas=8)),
    ("ring8", dict(t_end=1.0, windows=2, tau_fallback=3.0)),
])
def test_sparse_tau_matches_dense_tau(name, kw):
    """sparse=True against the dense tau path, through the kernels and
    (sparse) unfused: records, trajectories and the final pool, bit for
    bit, with leaps."""
    runs = [_tau(T_MODELS[name](), sparse=sparse, use_kernel=k, **dict(kw))
            for sparse, k in ((False, True), (True, True), (True, False))]
    base = runs[0]
    assert sum(base.telemetry.leaps_per_window) > 0
    for other in runs[1:]:
        assert (other.trajectories() == base.trajectories()).all()
        for a, b in zip(base.records, other.records):
            for f in ("mean", "var", "ci90"):
                assert getattr(a, f).tobytes() == getattr(b, f).tobytes()
        for f in ("steps_per_window", "leaps_per_window"):
            assert getattr(other.telemetry, f) == getattr(base.telemetry, f)
        assert torch.equal(other._engine._pool.t, base._engine._pool.t)


def test_tau_is_invariant_to_chunking_grouping_and_reruns():
    """Any kernel_chunk_steps / kernel_max_chunks and any lane grouping
    give the same bits, and a second run with the same seed repeats;
    another seed does not."""
    model = T_MODELS["lv8"]()
    kw = dict(t_end=0.45, replicas=8)
    base = _tau(model, use_kernel=True, **kw)
    assert sum(base.telemetry.leaps_per_window) > 0
    for other in (
            _tau(model, use_kernel=True, kernel_chunk_steps=8,
                 kernel_max_chunks=4096, **kw),
            _tau(model, use_kernel=True, kernel_chunk_steps=1000,
                 kernel_max_chunks=3, **kw),
            T.simulate(T.Experiment(
                model=model, ensemble=T.Ensemble.make(replicas=8),
                schedule=T.Schedule(t_end=0.45, n_windows=3), n_lanes=4,
                seed=5, method=T.Method.TAU_LEAP, record_trajectories=True),
                device="cpu"),
            _tau(model, use_kernel=True, **kw)):
        assert (other.trajectories() == base.trajectories()).all()
        assert other.telemetry.leaps_per_window == \
            base.telemetry.leaps_per_window
    assert (_tau(model, use_kernel=True, seed=6, **kw).trajectories()
            != base.trajectories()).any()


def test_tau_keeps_populations_nonnegative_and_conserved():
    """A fast pure death drives leap proposals negative: the retry and
    the exact fallback keep every count >= 0; 2A -> B leaps conserve
    A + 2B exactly."""
    death = make_system(["A"], [({"A": 1}, {}, 30.0)], {"A": 400})
    res = _tau(death, replicas=64, t_end=0.6, windows=6, tau_eps=0.2,
               use_kernel=True)
    assert (res.trajectories() >= 0).all()
    assert sum(res.telemetry.leaps_per_window) > 0
    dimer = make_system(["A", "B"], [({"A": 2}, {"B": 1}, 0.001)],
                          {"A": 3000, "B": 0})
    res = _tau(dimer, replicas=32, t_end=0.2, windows=2, use_kernel=True)
    x = res.final_state()
    assert sum(res.telemetry.leaps_per_window) > 0
    assert (x[:, 0] + 2 * x[:, 1] == 3000).all() and (x >= 0).all()


def test_tau_runs_coefficient_5_sparse_only():
    """The dense tau path refuses a reactant coefficient above 4 and
    points to sparse=True, which runs it (kernel and unfused agree)."""
    with pytest.raises(T.ExperimentError, match="sparse=True"):
        _tau(pentamer_system())
    a = _tau(pentamer_system(), sparse=True, use_kernel=True)
    b = _tau(pentamer_system(), sparse=True)
    assert (a.trajectories() == b.trajectories()).all()
    assert (a.final_state() >= 0).all()


@pytest.mark.parametrize("field,value,match", [
    ("tau_eps", 0.0, "tau_eps"), ("tau_fallback", -1.0, "tau_fallback")])
def test_tau_options_are_validated(field, value, match):
    with pytest.raises(T.ExperimentError, match=match):
        _tau(T_MODELS["lv2"](), **{field: value})
