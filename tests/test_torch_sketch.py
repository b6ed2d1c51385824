"""Streaming sketches in the port (`repro_torch.stats.sketch`, the
engine's per-window and superstep paths) against the reference: the
unit cases of tests/test_sketch.py, the binning against the reference
ENGINE's jitted sketch (which multiplies by the float32 reciprocal of
the bin width) on widths whose reciprocal is inexact and on values at
the bin edges, `simulate(..., sketch=...)` histograms for exact and
tau, dense and sparse, and the port's own invariance across
window_block and pipeline depth.

Sketch counts are integers of equal observables, so every comparison
here is bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as J
import repro_torch.api as T
from repro.api.run import build_engine as j_build_engine
from repro.core.cwc.models import MODELS as J_MODELS
from repro.stats import sketch as js
from repro_torch.core.cwc.models import MODELS as T_MODELS
from repro_torch.stats import sketch as ts


def port_sketch(obs, gids, n_groups, params):
    """The port's window_sketch on CPU tensors, as numpy."""
    thr = (torch.as_tensor(params.thresholds) if params.n_thr else None)
    hist, rare = ts.window_sketch(
        torch.as_tensor(obs), torch.as_tensor(gids), n_groups,
        torch.as_tensor(params.lo), torch.as_tensor(params.inv_width),
        params.n_bins, thr)
    return hist.numpy(), (None if rare is None else rare.numpy())


def engine_sketch(obs, gids, n_groups, params):
    """The reference engine's sketch: `window_sketch` jitted with the
    bin geometry closed over as constants (engine._sketch_eval)."""
    thr = params.thresholds if params.n_thr else None
    fn = jax.jit(lambda o, g: js.window_sketch(
        o, g, n_groups, params.lo, params.width, params.n_bins, thr))
    hist, rare = fn(jnp.asarray(obs), jnp.asarray(gids))
    return np.asarray(hist), (None if rare is None else np.asarray(rare))


def resolve_both(spec_kw, obs0):
    jp = js.SketchSpec(**spec_kw).resolve(obs0)
    tp = ts.SketchSpec(**spec_kw).resolve(obs0)
    for f in ("lo", "width", "thresholds"):
        assert getattr(jp, f).tobytes() == getattr(tp, f).tobytes(), f
    assert jp.n_bins == tp.n_bins
    assert tp.inv_width.tobytes() == (np.float32(1) / tp.width).tobytes()
    return jp, tp


# ------------------------------------------------------------- unit
def test_window_sketch_matches_numpy_binning_and_reference():
    """Clamped tails, per-group counts, totals preserved: the port's
    counts equal the numpy formula and the reference's eager call
    (power-of-two widths, where division and the reciprocal agree)."""
    rng = np.random.default_rng(3)
    n_i, n_obs, n_bins, n_groups = 64, 2, 8, 3
    obs = rng.uniform(-5.0, 45.0, (n_i, n_obs)).astype(np.float32)
    gids = rng.integers(0, n_groups, n_i).astype(np.int32)
    lo = np.zeros(n_obs, np.float32)
    width = np.full(n_obs, 32.0 / n_bins, np.float32)
    thr = np.asarray([10.0, 40.0], np.float32)
    params = ts.SketchParams(lo, width, n_bins, thr, np.float32(1) / width)

    hist, rare = port_sketch(obs, gids, n_groups, params)
    assert hist.dtype == rare.dtype == np.int32
    assert hist.shape == (n_groups, n_obs, n_bins)
    assert rare.shape == (n_groups, n_obs, 2)
    jh, jr = js.window_sketch(obs, gids, n_groups, lo, width, n_bins,
                              thresholds=thr)
    assert hist.tobytes() == np.asarray(jh).tobytes()
    assert rare.tobytes() == np.asarray(jr).tobytes()
    b = np.clip(np.floor((obs - lo) / width), 0, n_bins - 1).astype(int)
    for g in range(n_groups):
        sel = gids == g
        for o in range(n_obs):
            ref = np.bincount(b[sel, o], minlength=n_bins)
            assert (hist[g, o] == ref).all(), (g, o)
            for k, level in enumerate(thr):
                assert rare[g, o, k] == (obs[sel, o] >= level).sum()
        assert hist[g].sum(axis=-1).tolist() == [sel.sum()] * n_obs


def test_window_sketch_merge_is_a_partition_sum():
    """Sketching two disjoint halves and adding the int32 counts is the
    full-pool sketch bit for bit."""
    rng = np.random.default_rng(7)
    obs = rng.uniform(0.0, 30.0, (40, 1)).astype(np.float32)
    gids = rng.integers(0, 2, 40).astype(np.int32)
    lo, width = np.zeros(1, np.float32), np.full(1, 2.0, np.float32)
    params = ts.SketchParams(lo, width, 16, np.zeros(0, np.float32),
                             np.float32(1) / width)
    full, none = port_sketch(obs, gids, 2, params)
    assert none is None
    a, _ = port_sketch(obs[:13], gids[:13], 2, params)
    b, _ = port_sketch(obs[13:], gids[13:], 2, params)
    assert (a + b == full).all()
    jf, _ = js.window_sketch(obs, gids, 2, lo, width, 16)
    assert full.tobytes() == np.asarray(jf).tobytes()


@pytest.mark.parametrize("case", ["gamma", "bimodal"])
def test_host_estimators_match_reference(case):
    """quantiles_from_hist within one bin width of np.quantile (the
    documented bound) and equal to the reference's; bimodality_from_hist
    flags as the reference does."""
    if case == "bimodal":
        uni = np.zeros(16, int)
        uni[6:10] = (30, 60, 55, 20)
        bi = np.zeros(16, int)
        bi[2:4] = (50, 45)
        bi[11:13] = (40, 48)
        hists = np.stack([uni, bi])
        flags = ts.bimodality_from_hist(hists)
        assert flags.tolist() == [False, True]
        assert flags.tolist() == js.bimodality_from_hist(hists).tolist()
        return
    rng = np.random.default_rng(11)
    x = rng.gamma(4.0, 5.0, 4096).astype(np.float32)
    lo = np.zeros(1, np.float32)
    width = np.full(1, 100.0 / 64, np.float32)
    params = ts.SketchParams(lo, width, 64, np.zeros(0, np.float32),
                             np.float32(1) / width)
    hist, _ = port_sketch(x[:, None], np.zeros(4096, np.int32), 1, params)
    q = ts.quantiles_from_hist(hist, lo, width)
    assert q.tobytes() == js.quantiles_from_hist(hist, lo, width).tobytes()
    for k, p in enumerate((0.1, 0.5, 0.9)):
        err = abs(q[0, 0, k] - np.quantile(x, p))
        assert err <= float(width[0]), (p, err, float(width[0]))


def test_spec_validation_matches_reference():
    for kw in (dict(n_bins=1), dict(lo=5.0, hi=5.0),
               dict(lo=[0.0, 1.0, 2.0], hi=[4.0, 5.0])):
        for mod in (js, ts):
            with pytest.raises(ValueError):
                mod.SketchSpec(**kw).validate()
    obs0 = np.asarray([1000.0, 3.0])
    resolve_both(dict(n_bins=32), obs0)  # hi from the model's t=0 state
    resolve_both(dict(n_bins=5, lo=[1.0, -2.0], hi=[9.0, 30.0],
                      thresholds=(4.0, 7.5)), obs0)


# ------------------------------------- against the reference engine
SPECS = {
    "hi1000_32": dict(n_bins=32, hi=1000.0, thresholds=(500.0,)),
    "hi3.3_1e5_7": dict(n_bins=7, hi=[3.3, 1e5], thresholds=(1.0, 5e4)),
    "lo-2.5_hi0.7_3": dict(n_bins=3, lo=-2.5, hi=0.7),
}


def _edge_values(params, rng, n_random):
    """Random values over and around [lo, hi], NaN and both infinities
    (XLA and the port both put NaN in bin 0), plus every bin edge
    lo + k * width and the float32s on either side of it."""
    lo, width = params.lo, params.width
    hi = lo + width * params.n_bins
    n_obs = lo.shape[0]
    rand = rng.uniform(lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo),
                       (n_random, n_obs)).astype(np.float32)
    rand[:3] = np.asarray([np.nan, np.inf, -np.inf])[:, None]
    edges = params.edges().T.astype(np.float32)  # (n_bins + 1, n_obs)
    near = [edges, np.nextafter(edges, np.float32(np.inf)),
            np.nextafter(edges, np.float32(-np.inf))]
    return np.concatenate([rand, *near]).astype(np.float32)


@pytest.mark.parametrize("spec", list(SPECS))
def test_binning_matches_reference_engine_path(spec):
    """The port's bins against the reference engine's jitted sketch,
    bit for bit, on 200,000 random values and on every bin edge and its
    float32 neighbours. Where the reciprocal of the width is inexact
    the engine's counts differ from true division's, and the port
    follows the engine."""
    rng = np.random.default_rng(17)
    jp, tp = resolve_both(SPECS[spec], np.asarray([1000.0, 1000.0]))
    obs = _edge_values(tp, rng, 200_000)
    gids = rng.integers(0, 3, obs.shape[0]).astype(np.int32)
    hist, rare = port_sketch(obs, gids, 3, tp)
    jh, jr = engine_sketch(obs, gids, 3, jp)
    assert hist.tobytes() == jh.tobytes()
    assert (rare is None) == (jr is None)
    if rare is not None:
        assert rare.tobytes() == jr.tobytes()
    assert (hist.sum(axis=-1) == np.bincount(gids, minlength=3)[:, None]
            ).all()
    if spec == "hi1000_32":
        # the case is sensitive to the rule: division bins differently
        fin = obs[np.isfinite(obs).all(axis=1)]
        div = np.floor((fin - tp.lo) / tp.width)
        mul = np.floor((fin - tp.lo) * tp.inv_width)
        assert (div != mul).any()


def test_binning_matches_reference_engine_sketch_eval():
    """The same through the reference's own `engine._sketch_eval()` and
    the port engine's `_sketch_eval`, grouped by a sweep's points."""
    sk = dict(n_bins=7, hi=[3.3, 1e5], thresholds=(2.0,))
    engines = [build(api.Experiment(
        model=models["lv2"](),
        ensemble=api.Ensemble.make(replicas=512,
                                   sweep={"die": [0.3, 1.2]}),
        schedule=api.Schedule(t_end=0.1, n_windows=2),
        reduction=api.Reduction.PER_POINT, sketch=api.SketchSpec(**sk)),
        **({} if api is J else {"device": "cpu"}))
        for api, models, build in ((J, J_MODELS, j_build_engine),
                                   (T, T_MODELS, T.build_engine))]
    rng = np.random.default_rng(5)
    obs = _edge_values(engines[1]._sketch, rng, 1024 - 3 * 8)
    assert obs.shape == (1024, 2)
    jh, jr = engines[0]._sketch_eval()(jnp.asarray(obs))
    th, tr = engines[1]._sketch_eval(torch.as_tensor(obs))
    assert th.numpy().tobytes() == np.asarray(jh).tobytes()
    assert tr.numpy().tobytes() == np.asarray(jr).tobytes()


# -------------------------------------------------- simulate(sketch=)
SIM_T_END = {"exact": 0.1, "tau_leap": 1.5}


def make_exp(api, method="exact", sparse=False, window_block=1,
             pipeline_depth=1, **kw):
    models = J_MODELS if api is J else T_MODELS
    return api.Experiment(
        model=models["lv2"](),
        ensemble=api.Ensemble.make(replicas=16, sweep={"die": [0.3, 1.2]}),
        schedule=api.Schedule(t_end=SIM_T_END[method], n_windows=4),
        reduction=api.Reduction.PER_POINT, n_lanes=8, seed=11,
        method=method, sparse=sparse, window_block=window_block,
        pipeline_depth=pipeline_depth,
        sketch=api.SketchSpec(n_bins=16, hi=1500.0, thresholds=(900.0,)),
        # the port's kernel path runs its plain twin here; the
        # reference's jitted unfused path gives the same bits
        use_kernel=api is T, **kw)


def run(exp, **kw):
    if isinstance(exp, T.Experiment):
        return T.simulate(exp, device="cpu", **kw)
    return J.simulate(exp, **kw)


def stack(res):
    sks = res.sketches()
    return (np.stack([s.hist for s in sks]),
            np.stack([s.rare for s in sks]))


_RUNS = {}


def cached(api, method, sparse):
    key = (api.__name__, method, sparse)
    if key not in _RUNS:
        _RUNS[key] = run(make_exp(api, method, sparse))
    return _RUNS[key]


@pytest.mark.parametrize("method,sparse", [
    ("exact", False), ("exact", True), ("tau_leap", False),
    ("tau_leap", True)])
def test_simulate_sketches_match_reference(method, sparse):
    """Per-window histograms and rare counts of a PER_POINT sweep equal
    the reference's bit for bit; record means too (equal pools); one
    host sync per window on the per-window path with the sketch."""
    ref, got = cached(J, method, sparse), cached(T, method, sparse)
    (jh, jr), (th, tr) = stack(ref), stack(got)
    assert th.dtype == tr.dtype == np.int32
    assert th.shape == (4, 2, 2, 16) and tr.shape == (4, 2, 2, 1)
    assert th.tobytes() == jh.tobytes()
    assert tr.tobytes() == jr.tobytes()
    assert (th.sum(axis=-1) == 16).all()
    for a, b in zip(ref.records, got.records):
        assert a.mean.tobytes() == b.mean.tobytes()
    assert got.telemetry.host_syncs == 4 + 4  # the pull + grouped stats
    if method == "tau_leap":
        assert sum(got.telemetry.leaps_per_window) > 0


@pytest.mark.parametrize("window_block,pipeline_depth", [
    (3, 1), (3, 4), (1, 4)])
def test_sketches_bitwise_across_supersteps(window_block, pipeline_depth):
    """The port's case for tests/test_superstep.py::
    test_depth_k_sketches_and_grouped_bitwise: sketches, grouped
    statistics and records bitwise for any window_block and depth (the
    counts ride the ring's packed rows); and equal to the reference's."""
    base = cached(T, "exact", False)
    got = run(make_exp(T, window_block=window_block,
                       pipeline_depth=pipeline_depth))
    for a, b in zip(stack(base), stack(got)):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(stack(cached(J, "exact", False)), stack(got)):
        assert a.tobytes() == b.tobytes()
    pa, pb = base.per_point(), got.per_point()
    for f in ("n", "mean", "var", "ci90"):
        assert pa[f].tobytes() == pb[f].tobytes(), f
    for a, b in zip(base.records, got.records):
        for f in ("mean", "var", "ci90"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    if window_block > 1:
        assert got.telemetry.host_syncs == 2  # one per block


@pytest.mark.parametrize("method", ["exact", "tau_leap"])
def test_streaming_sketch_is_a_recount_and_reads_only(method):
    """End to end, both methods (tests/test_sketch.py's statistical
    case): each window's histogram is the recount of the same
    trajectory samples under the reciprocal rule, its quantiles within
    one bin width of np.quantile, and a run without the sketch has the
    same records (a sketch reads and never writes) and host syncs (the
    counts ride the window's one pull)."""
    from repro_torch.core.reactions import make_system

    model = make_system(["A"], [({}, {"A": 1}, 200.0), ({"A": 1}, {}, 1.0)],
                        {"A": 0})
    exp = T.Experiment(
        model=model, ensemble=T.Ensemble.make(replicas=256),
        schedule=T.Schedule(t_end=2.0, n_windows=4), n_lanes=64, seed=11,
        method=method, record_trajectories=True, use_kernel=True,
        sketch=T.SketchSpec(n_bins=48, hi=300.0, thresholds=(150.0,)))
    res = run(exp)
    plain = run(exp.with_(sketch=None))
    assert res.telemetry.host_syncs == plain.telemetry.host_syncs
    for a, b in zip(res.records, plain.records):
        for f in ("mean", "var", "ci90"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    traj = res.trajectories()
    pr = res._engine._sketch
    for w, sk in enumerate(res.sketches()):
        samples = traj[:, w, 0]
        b = np.clip(np.floor((samples - pr.lo[0]) * pr.inv_width[0]),
                    0, pr.n_bins - 1).astype(int)
        assert (sk.hist[0, 0] == np.bincount(b, minlength=pr.n_bins)).all()
        assert sk.rare[0, 0, 0] == (samples >= 150.0).sum()
        q = ts.quantiles_from_hist(sk.hist, pr.lo, pr.width)
        for k, p in enumerate((0.1, 0.5, 0.9)):
            err = abs(q[0, 0, k] - np.quantile(samples, p))
            assert err <= float(pr.width[0]), (method, w, p, err)
