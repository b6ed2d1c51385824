"""Port parity: adaptive tau-leaping (`repro_torch.core.tau_leap`) against
the reference's `repro.core.tau_leap` on the CPU.

Bit for bit against the reference: the port's float32 `exp_f32` against
XLA:CPU's `jnp.exp` (whole binades of the Poisson sampler's range), the
g_i and reactant-mask tables, the Poisson sampler, one `tau_step_core`
step on random pools, and `simulate(method=TAU_LEAP)` records and pool
state on models whose delta columns hold at most two nonzeros (lv2, lv8,
transport: a sum of two terms has one order, so XLA's dot order cannot
matter). Where a column holds more (ecoli, ring8) XLA:CPU's `lax.dot`
may sum in another order than the port's left-to-right column walk, so
the port's tau ensemble is held to the reference's statistically, and
its birth-death and dimerization moments to their analytic values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as J
import repro_torch.api as T
from repro.core import gillespie as jg, reactions as jr
from repro.core import tau_leap as jt
from repro.core.cwc.compile import compile_model as j_compile
from repro.core.cwc.models import MODELS as J_MODELS
from repro_torch import interop
from repro_torch.core import reactions as tr
from repro_torch.core import tau_leap as tt
from repro_torch.core.cwc.compile import compile_model as t_compile
from repro_torch.core.cwc.models import MODELS as T_MODELS
from repro_torch.core.cwc.models import pentamer_system
from repro_torch.core.mathf import exp_f32

F32 = np.float32
POOL = ("x", "t", "dead", "ctr", "ctr_hi", "steps", "leaps")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a


def assert_bitwise(a, b, what=""):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape and (a == b).all(), what


def _as_reference(ts):
    return jr.ReactionSystem(**{f: getattr(ts, f) for f in (
        "reactant_idx", "reactant_coef", "delta", "rates", "x0",
        "species_names", "reaction_names")})


def birth_death():
    """X(0)=0, birth 400, per-capita death 1 (tests/test_statistical.py)."""
    return tr.make_system(["A"], [({}, {"A": 1}, 400.0), ({"A": 1}, {}, 1.0)],
                          {"A": 0})


def systems(name):
    """(reference system, port system)."""
    if name == "coef5":
        ts = pentamer_system()
    elif name == "birth_death":
        ts = birth_death()
    else:
        return j_compile(J_MODELS[name]())[0], t_compile(T_MODELS[name]())[0]
    return _as_reference(ts), ts


# ------------------------------------------------------------------ exp


def _binade(lo, hi):
    """Every float32 from lo to hi (both negative, |lo| < |hi|)."""
    return np.arange(F32(lo).view(np.uint32), F32(hi).view(np.uint32) + 1,
                     dtype=np.uint32).view(F32)


@pytest.mark.parametrize("inputs", ["binade [-16, -8]", "binade [-1, -0.5]",
                                    "2^24 patterns over [-16, 0]"])
def test_exp_f32_matches_jnp_exp(inputs):
    """0 differences against jit(jnp.exp) on every float32 of two whole
    binades of the Poisson sampler's range exp(-lam), lam in [0, 16],
    and on 2^24 bit patterns drawn uniformly over [-16, 0] (every binade
    there), with 0.0 and -0.0."""
    if inputs.startswith("binade"):
        lo, hi = (-8.0, -16.0) if "16" in inputs else (-0.5, -1.0)
        x = _binade(lo, hi)
    else:
        rng = np.random.default_rng(13)
        top = int(F32(-16.0).view(np.uint32)) - 0x80000000
        x = (rng.integers(0, top + 1, 1 << 24).astype(np.uint32)
             | np.uint32(0x80000000)).view(F32)
    x = np.concatenate([x, np.asarray([0.0, -0.0], F32)])
    ref = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    got = exp_f32(torch.from_numpy(x)).numpy()
    n_diff = int((got.view(np.int32) != ref.view(np.int32)).sum())
    assert n_diff == 0, f"{n_diff} of {x.size} exps differ from jnp.exp"
    assert (exp_f32(torch.zeros(1)) == 1.0).all()


def test_exp_f32_wide_range_within_one_ulp(rng):
    """Beyond the sampler's range: normal results stay within 1 ulp of
    the float64 exp rounded to float32."""
    x = rng.uniform(-87.0, 88.0, 200_000).astype(F32)
    got = exp_f32(torch.from_numpy(x)).numpy()
    want = np.exp(x.astype(np.float64)).astype(F32)
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 1


# --------------------------------------------------------------- tables


@pytest.mark.parametrize("name", ["lv2", "lv8", "ecoli", "transport",
                                  "ring8", "coef5"])
def test_gi_tables_and_reactant_mask_match_reference(name):
    js, ts = systems(name)
    a, b = jt.gi_tables(js), tt.gi_tables(ts)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert_bitwise(a, b)
    assert_bitwise(jt.reactant_mask(js), tt.reactant_mask(ts))


@pytest.mark.parametrize("name", ["ecoli", "ring8", "coef5"])
def test_delta_columns_are_the_nonzeros_of_delta(name):
    """Each species' column, in ascending reaction order, pads (R, 0) at
    the end; scattering it back gives delta."""
    _, ts = systems(name)
    col_j, col_v = tt.delta_columns(ts.delta)
    r, s = ts.delta.shape
    back = np.zeros((r + 1, s), np.float32)
    for i in range(s):
        js = col_j[i][col_j[i] < r]
        assert (np.diff(js) > 0).all()
        assert (col_j[i][len(js):] == r).all()
        assert (col_v[i][len(js):] == 0).all()
        back[col_j[i], i] += col_v[i]
    assert (back[:r] == ts.delta).all() and (back[r] == 0).all()


def test_tau_tables_refuse_large_coefficients_dense_only():
    with pytest.raises(ValueError, match="sparse=True"):
        tt.tau_tables(pentamer_system())
    assert tt.tau_tables(pentamer_system(), sparse=True).max_c == 5


# -------------------------------------------------------------- sampler


def test_poisson_from_uniform_matches_reference():
    """Random (u, lam in [0, 16]) with the ends lam = 0 and 16, bit for
    bit; the early stop gives the 64-term loop's counts, entries with
    lam < 0 (never settled) included."""
    rng = np.random.default_rng(5)
    n = 1 << 18
    u = rng.uniform(0, 1, n).astype(F32)
    lam = rng.uniform(0, 16, n).astype(F32)
    lam[:512], lam[512:1024] = 0.0, 16.0
    u[:64] = F32(1.0) - F32(2.0 ** -23)
    ref = np.asarray(jax.jit(jt.poisson_from_uniform)(jnp.asarray(u),
                                                      jnp.asarray(lam)))
    got = tt.poisson_from_uniform(torch.from_numpy(u), torch.from_numpy(lam))
    assert_bitwise(ref, got.numpy())
    assert ref.max() > 30
    neg = -rng.uniform(0, 2, 256).astype(F32)
    ref = np.asarray(jax.jit(jt.poisson_from_uniform)(
        jnp.asarray(u[:256]), jnp.asarray(neg)))
    got = tt.poisson_from_uniform(torch.from_numpy(u[:256]),
                                  torch.from_numpy(neg))
    assert_bitwise(ref, got.numpy())


# ----------------------------------------------------------------- step


def _random_pool(js, b, rng, no_leap):
    """A reference pool with random populations, clocks, dead flags and
    draw counters (some about to carry into the high word)."""
    jp = jg.init_lanes(js, b, seed=3)
    ctr = rng.integers(0, 2 ** 32, b, dtype=np.uint64).astype(np.uint32)
    ctr[:6] = np.uint32(2 ** 32 - 3)
    return jp._replace(
        x=jnp.asarray(rng.integers(0, 600, (b, js.n_species)).astype(F32)),
        t=jnp.asarray(rng.uniform(0, 0.5, b).astype(F32)),
        ctr=jnp.asarray(ctr),
        ctr_hi=jnp.asarray(rng.integers(0, 9, b).astype(np.uint32)),
        dead=jnp.asarray(rng.uniform(size=b) < 0.1),
        no_leap=jnp.asarray((np.arange(b) % 2 == 1) if no_leap
                            else np.zeros(b, bool)))


def port_pool(js, jp):
    return interop.from_reference(
        {f: getattr(js, f) for f in interop.SYSTEM_FIELDS},
        {f: np.asarray(getattr(jp, f)) for f in jg.LaneState._fields},
        device="cpu")


@pytest.mark.parametrize("rates_kind", ["shared", "per_lane",
                                        "per_lane+no_leap"])
@pytest.mark.parametrize("name", ["lv8", "lv2", "transport", "birth_death"])
def test_tau_step_matches_reference(name, rates_kind):
    """One `make_tau_step` step on a random pool against the reference's,
    every pool leaf bit for bit: shared or per-lane rates, and a
    half-set no_leap mask."""
    js, _ = systems(name)
    rng = np.random.default_rng(len(name) * 7 + len(rates_kind))
    b = 96
    jp = _random_pool(js, b, rng, rates_kind.endswith("no_leap"))
    rates = js.rates if rates_kind == "shared" else (
        js.rates[None] * rng.uniform(0.5, 1.5, (b, js.n_reactions))
    ).astype(F32)
    step = jt.make_tau_step(jt.gi_tables(js), jt.reactant_mask(js), 0.03,
                            10.0)
    jo = jax.jit(step)(jp, jg.system_tensors(js, rates), jnp.float32(1.0))
    ts, tp = port_pool(js, jp)
    to = tt.make_tau_step(tt.tau_tables(ts), 0.03, 10.0)(
        tp, (None, None, None, torch.from_numpy(np.asarray(rates))),
        np.float32(1.0))
    for f in POOL:
        assert_bitwise(getattr(jo, f), getattr(to, f).numpy(), f)
    assert_bitwise(jo.key, to.key.numpy().view(np.uint32), "key")
    if name != "transport":  # transport's populations never leap
        assert int(to.leaps.sum()) > 0


@pytest.mark.parametrize("name,horizon", [("lv8", 0.3), ("ecoli", 60.0)])
def test_advance_to_matches_reference(name, horizon):
    """The standalone window advance, dense and sparse, against the
    reference's `advance_to` from the model's initial state."""
    js, ts = systems(name)
    jp = jg.init_lanes(js, 24, seed=8)
    jo = jt.advance_to(jp, js, horizon)
    for sparse in (False, True):
        _, tp = port_pool(js, jp)
        to = tt.advance_to(tp, ts, horizon, sparse=sparse)
        for f in POOL:
            assert_bitwise(getattr(jo, f), getattr(to, f).numpy(), f)
    assert int(to.leaps.sum()) > 0 and int(to.steps.sum()) > 0


# ------------------------------------------------------------- simulate


def _simulate_both(name, t_end, **kw):
    out = []
    for api in (J, T):
        models = J_MODELS if api is J else T_MODELS
        exp = api.Experiment(
            model=models[name](), ensemble=api.Ensemble.make(replicas=32),
            schedule=api.Schedule(t_end=t_end, n_windows=3), n_lanes=16,
            seed=5, method=api.Method.TAU_LEAP, **kw)
        out.append(api.simulate(exp, **({} if api is J
                                         else {"device": "cpu"})))
    return out


@pytest.mark.parametrize("name,t_end,kw", [
    ("lv8", 0.45, dict()),
    ("lv8", 0.45, dict(use_kernel=True)),
    ("lv2", 1.5, dict(sparse=True)),
    ("lv2", 1.5, dict(sparse=True, use_kernel=True, kernel_chunk_steps=64)),
])
def test_simulate_tau_matches_reference(name, t_end, kw):
    """simulate(method=TAU_LEAP) against the reference: record means, the
    final pool and the steps and leaps per window, bit for bit."""
    jres, tres = _simulate_both(name, t_end, **kw)
    assert tres.completed and len(tres.records) == 3
    for a, b in zip(jres.records, tres.records):
        assert (a.t, a.window, a.n) == (b.t, b.window, b.n)
        assert a.mean.tobytes() == b.mean.tobytes()
    jpool, tpool = jres._engine._pool, tres._engine._pool
    for f in POOL:
        assert_bitwise(getattr(jpool, f), getattr(tpool, f).numpy(), f)
    for f in ("steps_per_window", "leaps_per_window"):
        assert getattr(tres.telemetry, f) == getattr(jres.telemetry, f), f
    assert sum(tres.telemetry.leaps_per_window) > 0


# ---------------------------------------------------------- statistical


def _final(api, model, seed, **kw):
    exp = api.Experiment(
        model=model, ensemble=api.Ensemble.make(replicas=256),
        schedule=api.Schedule(**kw.pop("schedule")), n_lanes=64, seed=seed,
        method=api.Method.TAU_LEAP, use_kernel=True, **kw)
    res = api.simulate(exp, **({} if api is J else {"device": "cpu"}))
    return res


@pytest.mark.parametrize("name,kw", [
    ("ecoli", dict(schedule=dict(t_end=80.0, n_windows=2))),
    ("ring8", dict(schedule=dict(t_end=1.0, n_windows=2), sparse=True,
                   tau_fallback=3.0)),
])
def test_tau_ensemble_agrees_with_reference(name, kw):
    """Where XLA's dot order may differ from the port's: the port's tau
    ensemble against the reference's on independent streams (seeds 21
    and 22), per observable at the end: a two-sample z-test on the mean
    (|z| < 4, the bound of tests/test_statistical.py) and a variance
    ratio within [0.6, 1.67]. Both ensembles must leap."""
    j = _final(J, J_MODELS[name](), 21, **dict(kw))
    t = _final(T, T_MODELS[name](), 22, **dict(kw))
    assert sum(j.telemetry.leaps_per_window) > 0
    assert sum(t.telemetry.leaps_per_window) > 0
    a, b = j.final_state(), t.final_state()
    n = a.shape[0]
    for i in range(a.shape[1]):
        va, vb = a[:, i].var(), b[:, i].var()
        if va + vb == 0:
            assert a[0, i] == b[0, i]
            continue
        z = (a[:, i].mean() - b[:, i].mean()) / np.sqrt(va / n + vb / n)
        assert abs(z) < 4.0, (name, i, a[:, i].mean(), b[:, i].mean(), z)
        if min(va, vb) > 1.0:
            assert 0.6 < va / vb < 1.67, (name, i, va, vb)


def test_birth_death_tau_moments_match_poisson_transient():
    """The port's tau-leaping on birth-death: mean and variance at each
    window against the analytic Poisson transient m(t) = 400 (1 -
    e^-t), the bounds of tests/test_statistical.py (|z| < 4)."""
    n = 512
    res = T.simulate(T.Experiment(
        model=birth_death(), ensemble=T.Ensemble.make(replicas=n),
        schedule=T.Schedule(t_end=2.0, n_windows=4), n_lanes=64, seed=11,
        method=T.Method.TAU_LEAP, use_kernel=True), device="cpu")
    for rec in res.records:
        m = 400.0 * (1 - np.exp(-rec.t))
        z_mean = (rec.mean[0] - m) / np.sqrt(m / n)
        z_var = (rec.var[0] - m) / (m * np.sqrt(2.0 / (n - 1)))
        assert abs(z_mean) < 4.0 and abs(z_var) < 4.0, (rec.t, z_mean, z_var)
    assert sum(res.telemetry.leaps_per_window) > 0


def _cme_dimerization(t_end, n0=8000, c=3e-5, steps=3000):
    """Mean and variance of A at t_end for 2A -> B from A(0)=n0: the
    chemical master equation on its finite ladder, RK4."""
    kmax = n0 // 2
    x = n0 - 2 * np.arange(kmax + 1)
    ak = np.maximum(c * x * (x - 1) / 2.0, 0.0)
    p = np.zeros(kmax + 1)
    p[0] = 1.0
    h = t_end / steps

    def deriv(p):
        d = -ak * p
        d[1:] += ak[:-1] * p[:-1]
        return d

    for _ in range(steps):
        k1 = deriv(p)
        k2 = deriv(p + h / 2 * k1)
        k3 = deriv(p + h / 2 * k2)
        k4 = deriv(p + h * k3)
        p = p + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    mean = (p * x).sum()
    return mean, (p * x * x).sum() - mean * mean


def test_dimerization_tau_moments_match_master_equation():
    """2A -> B: the port's tau-leaping mean within |z| < 4 of the master
    equation's and its variance within [0.7, 1.4] of it (the reference's
    bounds: explicit tau-leaping inflates the variance by O(tau)); A + 2B
    is conserved by every leap."""
    n = 256
    system = tr.make_system(["A", "B"], [({"A": 2}, {"B": 1}, 3e-5)],
                            {"A": 8000, "B": 0})
    res = T.simulate(T.Experiment(
        model=system, ensemble=T.Ensemble.make(replicas=n),
        schedule=T.Schedule(t_end=1.0, n_windows=2), n_lanes=64, seed=11,
        method=T.Method.TAU_LEAP, tau_eps=0.02, use_kernel=True),
        device="cpu")
    for rec in res.records:
        am, av = _cme_dimerization(rec.t)
        assert abs((rec.mean[0] - am) / np.sqrt(av / n)) < 4.0
        assert 0.7 < rec.var[0] / av < 1.4, (rec.t, rec.var[0], av)
    assert sum(res.telemetry.leaps_per_window) > 0
    x = res.final_state()
    assert (x[:, 0] + 2 * x[:, 1] == 8000).all()
