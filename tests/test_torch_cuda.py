"""The port on the card: each CUDA kernel (dense SSA window, sparse SSA
window, Match, dense and sparse tau-leap windows) against its plain
twin, the sparse kernels against the dense ones, the tau kernel with an
unreachable leap threshold against the exact kernel, and the
fused-kernel engine paths against the unfused ones, bit for bit on one
device.

Every test needs a CUDA device and nvcc and skips itself without them.
The file imports neither JAX nor the reference package, so it runs
where only the port's dependencies are installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.api as T
from repro_torch.core import gillespie as tg
from repro_torch.core import tau_leap as tt
from repro_torch.core.cwc.compile import cell_ring_model, compile_model
from repro_torch.core.cwc.models import MODELS, pentamer_system
from repro_torch.core.reactions import make_system, sparse_tables
from repro_torch.kernels import ops as tops
from repro_torch.kernels import propensity as tkp
from repro_torch.kernels import ssa_step as tks

HORIZON = {"lv8": 0.05, "ecoli": 10.0, "transport": 2.0, "ring8": 0.25,
           "coef5": 0.5, "ring80": 0.1, "lattice8x8": 0.1, "ring256": 0.05,
           "inert": 1.0, "quartic": 1.0, "wide": 2.0}
OUTS = ("x", "t", "dead", "steps", "ctr", "ctr_hi")
TAU_OUTS = ("x", "t", "dead", "steps", "leaps", "ctr", "ctr_hi",
            "iterations")


def _system(name):
    if name == "coef5":  # a reactant coefficient above MAX_COEF
        return pentamer_system()
    if name == "quartic":  # reactant coefficients 3 and 4: dense-capable
        return make_system(
            ["A", "B", "C"],
            [({}, {"A": 1}, 20.0), ({"A": 3}, {"B": 1}, 2e-3),
             ({"B": 4}, {"C": 1}, 1e-3), ({"A": 1, "B": 2}, {"C": 1}, 1e-4),
             ({"C": 1}, {}, 0.1), ({"B": 1}, {}, 0.05)],
            {"A": 50, "B": 20})
    if name == "inert":  # every propensity zero from the start
        return make_system(["A", "B"], [({"A": 2}, {"B": 1}, 1.0),
                                        ({"B": 1}, {}, 0.5)], {"A": 1})
    if name == "wide":  # a reaction changes six species (D = 6)
        return make_system(
            ["A", "B", "C", "D", "E", "F"],
            [({}, {"A": 1}, 5.0),
             ({"A": 1}, {"B": 1, "C": 1, "D": 1, "E": 1, "F": 1}, 1.0),
             ({"B": 1}, {}, 0.3), ({"C": 1, "D": 1}, {}, 0.01),
             ({"E": 2}, {"F": 1}, 0.01), ({"F": 1}, {}, 0.2)], {"A": 10})
    if name == "ring256":  # R = 1,792: the carry does not fit on chip
        return compile_model(cell_ring_model(256))[0]
    return compile_model(MODELS[name]())[0]


def _assert_bitwise(outs_a, outs_b, what):
    for a, c, f in zip(outs_a, outs_b, OUTS):
        if a.dtype == torch.float32:
            a, c = a.view(torch.int32), c.view(torch.int32)
        assert torch.equal(a, c), (what, f)


def _sparse_args(system, b, rates, device):
    """The pool and sparse kernel operands of one window."""
    pool = tg.init_lanes(system, b, 3, device=device)
    sp = tg.sparse_system_tensors(sparse_tables(system), device=device)
    r = torch.as_tensor(system.rates if rates is None else rates,
                        device=device)
    tb = tops.bind_sparse_window(sp, r)
    args = (pool.x, pool.t, pool.dead.to(torch.int32), pool.key, pool.ctr,
            pool.ctr_hi, *tb[:5])
    return args, dict(max_c=tb.max_c, d=tb.d, k=tb.k,
                      packed_rates=tb.packed_rates)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _rates(system, b, rng, per_lane):
    if not per_lane:
        return None
    return (system.rates[None] * rng.uniform(0.5, 1.5, (b, system.n_reactions))
            ).astype(np.float32)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_twin(cuda):
    """The CUDA kernel against its plain twin, bitwise, with shared and
    per-lane rates and a budget cut; shapes above the kernel's caps
    raise."""
    rng = np.random.default_rng(0)
    for name, per_lane, n_steps in (("lv8", True, 4096),
                                    ("ecoli", False, 4096),
                                    ("transport", True, 4096),
                                    ("lv8", False, 16)):
        ts, _ = compile_model(MODELS[name]())
        b = 4096
        pool = tg.init_lanes(ts, b, 3, device=cuda)
        tens = tg.system_tensors(ts, _rates(ts, b, rng, per_lane),
                                 device=cuda)
        args = (pool.x, pool.t, pool.dead.to(torch.int32), pool.key,
                pool.ctr, pool.ctr_hi, *tens, HORIZON[name])
        before = tks.ssa_window_call.launches
        k = tks.ssa_window_call(*args, n_steps=n_steps)
        assert tks.ssa_window_call.launches == before + 1
        p = tks.ssa_window_plain(*args, n_steps=n_steps)
        torch.cuda.synchronize()
        for a, c in zip(k, p):
            if a.dtype == torch.float32:
                a, c = a.view(torch.int32), c.view(torch.int32)
            assert torch.equal(a, c), name
    big = torch.zeros((4, tks.MAX_S + 1), device=cuda)
    with pytest.raises(ValueError, match="S <="):
        tks.ssa_window_call(big, *args[1:6],
                            *tg.system_tensors(ts, device=cuda), 0.1,
                            n_steps=4)


@pytest.mark.cuda
def test_cuda_sparse_kernel_matches_plain_twin(cuda):
    """The sparse CUDA kernel against its plain twin, bitwise: ring8
    (R=56), ecoli, a coefficient-5 system, per-lane rates and a budget
    cut; and against the dense kernel on ecoli."""
    rng = np.random.default_rng(1)
    b = 4096
    for name, per_lane, n_steps in (("ring8", False, 4096),
                                    ("ecoli", False, 4096),
                                    ("coef5", False, 4096),
                                    ("transport", True, 4096),
                                    ("ring8", True, 8)):
        ts = _system(name)
        args, static = _sparse_args(ts, b, _rates(ts, b, rng, per_lane),
                                    cuda)
        before = tks.sparse_window_call.launches
        k = tks.sparse_window_call(*args, HORIZON[name], n_steps=n_steps,
                                   **static)
        assert tks.sparse_window_call.launches == before + 1
        p = tks.sparse_window_plain(*args, HORIZON[name], n_steps=n_steps,
                                    **static)
        torch.cuda.synchronize()
        _assert_bitwise(k, p, name)
        assert int(k[3].sum()) > 0, name
        live = (k[1] < HORIZON[name]) & (k[2] == 0)
        assert bool(live.any()) == (n_steps == 8), name
    ts = _system("ecoli")
    args, static = _sparse_args(ts, b, None, cuda)
    sparse = tks.sparse_window_call(*args, 20.0, n_steps=4096, **static)
    dense = tks.ssa_window_call(*args[:6], *tg.system_tensors(ts,
                                                              device=cuda),
                                20.0, n_steps=4096)
    torch.cuda.synchronize()
    _assert_bitwise(sparse, dense, "ecoli sparse vs dense")


def _negative_sweep(ts, b, rng):
    """Sweep rates with the first "dimerise1" reaction's rate negated:
    its propensity falls below 0, and the a0 fold's running sum is no
    longer monotone."""
    rates = _rates(ts, b, rng, True)
    j = next(i for i, n in enumerate(ts.reaction_names)
             if n.startswith("dimerise1"))
    rates[:, j] = -rates[:, j]
    return rates


@pytest.mark.cuda
@pytest.mark.parametrize("name,rates,route,n_steps", [
    ("ring80", "shared", "shared", 4096),
    ("lattice8x8", "sweep", "shared", 4096),
    ("ring256", "shared", "hbm", 4096),
    ("ring8", "negative", "shared", 4096),
    ("inert", "shared", "shared", 4096),
    ("wide", "sweep", "shared", 4096),
    ("ring80", "sweep", "shared", 8),  # a budget cut: lanes still live
])
def test_cuda_sparse_kernel_routes_match_plain_twin(cuda, name, rates,
                                                    route, n_steps):
    """The sparse kernel's route follows from the shape (the carry in
    shared memory up to R = 1,728, in HBM above), and each case is
    bitwise its plain twin: per-lane rates, a negative rate (the scan
    from row 0), all lanes dead from the start, more than four changed
    species (the general update), a budget cut. ring256 runs more lanes
    than the HBM route's one-wave grid holds, so threads take further
    lanes from the ticket and re-seed their scratch regions."""
    rng = np.random.default_rng(5)
    ts = _system(name)
    b = 65536 if name == "ring256" else 4096
    assert tks.sparse_window_route(ts.n_reactions)[0] == route
    r = (None if rates == "shared" else _rates(ts, b, rng, True)
         if rates == "sweep" else _negative_sweep(ts, b, rng))
    args, static = _sparse_args(ts, b, r, cuda)
    h = HORIZON[name]
    k = tks.sparse_window_call(*args, h, n_steps=n_steps, **static)
    p = tks.sparse_window_plain(*args, h, n_steps=n_steps, **static)
    torch.cuda.synchronize()
    _assert_bitwise(k, p, name)
    if name == "ring256":
        assert tks.sparse_window_call.grid_lanes < b
    live = (k[1] < h) & (k[2] == 0)
    assert bool(live.any()) == (n_steps == 8), name
    if name == "inert":
        assert int(k[3].sum()) == 0 and bool((k[2] == 1).all())
    else:
        assert int(k[3].sum()) > 0, name


@pytest.mark.cuda
def test_cuda_dense_kernel_coefficients_3_and_4(cuda):
    """Reactant coefficients 3 and 4 keep the comb factor's division by
    c!: the dense kernel against its twin and the sparse kernel, shared
    and per-lane rates."""
    rng = np.random.default_rng(7)
    ts = _system("quartic")
    b = 4096
    for per_lane in (False, True):
        pool = tg.init_lanes(ts, b, 3, device=cuda)
        rates = _rates(ts, b, rng, per_lane)
        tens = tg.system_tensors(ts, rates, device=cuda)
        args = (pool.x, pool.t, pool.dead.to(torch.int32), pool.key,
                pool.ctr, pool.ctr_hi, *tens, HORIZON["quartic"])
        k = tks.ssa_window_call(*args, n_steps=4096)
        p = tks.ssa_window_plain(*args, n_steps=4096)
        sargs, static = _sparse_args(ts, b, rates, cuda)
        sp = tks.sparse_window_call(*sargs, HORIZON["quartic"],
                                    n_steps=4096, **static)
        torch.cuda.synchronize()
        _assert_bitwise(k, p, f"quartic per_lane={per_lane}")
        _assert_bitwise(k, sp, f"quartic sparse per_lane={per_lane}")
        assert int(k[3].sum()) > 0


@pytest.mark.cuda
def test_cuda_propensity_kernel_matches_plain_twin(cuda):
    """The Match kernel against its plain twin, bitwise, with shared and
    per-lane rates."""
    rng = np.random.default_rng(2)
    for name in ("lv8", "ring8", "transport"):
        ts = _system(name)
        tens = tops.system_kernel_tensors(ts, device=cuda)
        x = torch.as_tensor(rng.integers(0, 200, (3000, ts.n_species))
                            .astype(np.float32), device=cuda)
        for per_lane in (False, True):
            rates = torch.as_tensor(
                _rates(ts, 3000, rng, True) if per_lane else ts.rates,
                device=cuda)
            before = tkp.propensity_call.launches
            k = tops.propensity(x, tens, rates)
            assert tkp.propensity_call.launches == before + 1
            p = tkp.propensity_plain(x, tens[0], tens[1], rates)
            torch.cuda.synchronize()
            assert torch.equal(k.view(torch.int32), p.view(torch.int32)), \
                (name, per_lane)


@pytest.mark.cuda
def test_cuda_simulate_sparse_kernel_path_matches_unfused(cuda):
    """simulate(sparse=True) on the card: the sparse kernel path (one
    launch per window) against the unfused sparse loop and the dense
    kernel path, records and final pool bit for bit."""
    exp = T.Experiment(model=MODELS["ring8"](),
                       ensemble=T.Ensemble.make(replicas=256),
                       schedule=T.Schedule(t_end=0.5, n_windows=2),
                       n_lanes=128, seed=4, sparse=True)
    before = tks.sparse_window_call.launches
    fused = T.simulate(exp.with_(use_kernel=True))  # default device
    assert tks.sparse_window_call.launches == before + 2
    unfused = T.simulate(exp, device=cuda)
    dense = T.simulate(exp.with_(sparse=False, use_kernel=True), device=cuda)
    for other in (unfused, dense):
        for a, b in zip(fused.records, other.records):
            for f in ("mean", "var", "ci90"):
                assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
        assert (fused.final_state() == other.final_state()).all()
    assert sum(fused.telemetry.steps_per_window) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("reduction", ["ensemble", "per_point"])
def test_cuda_simulate_kernel_path_matches_unfused(cuda, reduction):
    """simulate() on the card: the fused kernel path (one launch per
    window, on the default device) and the unfused group loop give the
    same records, per-point statistics and final pool."""
    per_point = reduction == "per_point"
    sweep = {"reproduce": [0.8, 1.2], "die": [0.5, 0.7]} if per_point \
        else None
    exp = T.Experiment(
        model=MODELS["lv2"](),
        ensemble=T.Ensemble.make(replicas=64, sweep=sweep),
        schedule=T.Schedule(t_end=0.3, n_windows=3), n_lanes=128, seed=5,
        reduction=T.Reduction.PER_POINT if per_point
        else T.Reduction.ENSEMBLE)
    before = tks.ssa_window_call.launches
    fused = T.simulate(exp.with_(use_kernel=True))  # default device
    assert tks.ssa_window_call.launches == before + 3
    assert "device=cuda" in repr(fused)
    unfused = T.simulate(exp, device=cuda)
    assert tks.ssa_window_call.launches == before + 3
    for a, b in zip(fused.records, unfused.records):
        for f in ("mean", "var", "ci90"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert fused.telemetry.steps_per_window == \
        unfused.telemetry.steps_per_window
    assert (fused.final_state() == unfused.final_state()).all()
    if per_point:
        pf, pu = fused.per_point(), unfused.per_point()
        for f in ("n", "mean", "var", "ci90"):
            assert pf[f].tobytes() == pu[f].tobytes(), f


def _tau_args(system, b, rates, device, sparse, no_leap=False):
    """The pool and tau kernel operands of one window."""
    pool = tg.init_lanes(system, b, 3, device=device)
    tb = tt.tau_tables(system, sparse=sparse, device=device)
    r = torch.as_tensor(system.rates if rates is None else rates,
                        device=device)
    nl = (torch.arange(b, device=device) % 2 if no_leap
          else torch.zeros(b, device=device)).to(torch.int32)
    return (pool.x, pool.t, pool.dead.to(torch.int32), nl, pool.key,
            pool.ctr, pool.ctr_hi, *tb[:6], r, tb.gi, tb.rmask), tb.max_c


def _assert_tau_bitwise(outs_a, outs_b, what):
    for a, c, f in zip(outs_a, outs_b, TAU_OUTS):
        if a.dtype == torch.float32:
            a, c = a.view(torch.int32), c.view(torch.int32)
        assert torch.equal(a, c), (what, f)


@pytest.mark.cuda
def test_cuda_tau_kernels_match_plain_twins(cuda):
    """The dense and sparse tau-leap kernels against their plain twins,
    bitwise: shared and per-lane rates, a half-set no_leap mask, a lower
    leap threshold (ring8 leaps only below the default), a coefficient-5
    system (sparse only) and a budget cut; the dense kernel refuses
    shapes above its caps."""
    rng = np.random.default_rng(3)
    b = 4096
    cases = [  # (model, per-lane rates, sparse, fallback, no_leap, steps)
        ("lv8", False, False, 10.0, False, 4096),
        ("lv8", True, False, 10.0, True, 4096),
        ("ecoli", False, False, 10.0, False, 4096),
        ("transport", True, False, 10.0, False, 4096),
        ("lv8", False, False, 10.0, False, 16),
        ("ring8", False, True, 3.0, False, 4096),
        ("ring8", True, True, 3.0, True, 4096),
        ("coef5", False, True, 3.0, False, 4096),
        ("lv8", True, True, 10.0, False, 16),
    ]
    horizon = {"lv8": 0.3, "ecoli": 100.0, "transport": 2.0, "ring8": 0.5,
               "coef5": 0.5}
    leaps = 0
    for name, per_lane, sparse, fb, no_leap, n_steps in cases:
        ts = _system(name)
        args, max_c = _tau_args(ts, b, _rates(ts, b, rng, per_lane), cuda,
                                sparse, no_leap)
        call, plain, static = (
            (tks.sparse_tau_window_call, tks.sparse_tau_window_plain,
             {"max_c": max_c}) if sparse else
            (tks.tau_window_call, tks.tau_window_plain, {}))
        kw = dict(n_steps=n_steps, eps=0.03, fallback=fb, **static)
        before = call.launches
        k = call(*args, horizon[name], **kw)
        assert call.launches == before + 1
        p = plain(*args, horizon[name], **kw)
        torch.cuda.synchronize()
        _assert_tau_bitwise(k, p, (name, per_lane, sparse))
        leaps += int(k[4].sum())
        live = (k[1] < horizon[name]) & (k[2] == 0)
        assert bool(live.any()) == (n_steps == 16), name
    assert leaps > 0
    big = _system("lattice8x8")  # S = 256 > 64
    args, _ = _tau_args(big, 8, None, cuda, False)
    with pytest.raises(ValueError, match="sparse=True"):
        tks.tau_window_call(*args, 0.1, n_steps=4, eps=0.03, fallback=10.0)


@pytest.mark.cuda
def test_cuda_tau_kernel_without_leaps_is_the_exact_kernel(cuda):
    """tau_fallback = inf: the dense tau kernel never leaps and gives the
    exact kernel's window, bit for bit, on lv8 (shared and per-lane
    rates) and ecoli."""
    rng = np.random.default_rng(4)
    b = 4096
    for name, per_lane in (("lv8", False), ("lv8", True), ("ecoli", False)):
        ts = _system(name)
        rates = _rates(ts, b, rng, per_lane)
        args, _ = _tau_args(ts, b, rates, cuda, False)
        tau = tks.tau_window_call(*args, HORIZON[name], n_steps=4096,
                                  eps=0.03, fallback=float("inf"))
        exact = tks.ssa_window_call(
            *args[:3], *args[4:7], *tg.system_tensors(ts, rates, device=cuda),
            HORIZON[name], n_steps=4096)
        torch.cuda.synchronize()
        assert int(tau[4].sum()) == 0
        _assert_bitwise((tau[0], tau[1], tau[2], tau[3], tau[5], tau[6]),
                        exact, name)
        assert int(exact[3].sum()) > 0


@pytest.mark.cuda
def test_cuda_sparse_tau_kernel_matches_dense_tau_kernel(cuda):
    """The sparse tau kernel against the dense one on ecoli and lv8:
    the same window, bit for bit, leaps included."""
    for name, h in (("ecoli", 100.0), ("lv8", 0.3)):
        ts = _system(name)
        args, max_c = _tau_args(ts, 4096, None, cuda, True)
        sparse = tks.sparse_tau_window_call(*args, h, n_steps=4096, eps=0.03,
                                            fallback=10.0, max_c=max_c)
        dense = tks.tau_window_call(*args, h, n_steps=4096, eps=0.03,
                                    fallback=10.0)
        torch.cuda.synchronize()
        _assert_tau_bitwise(sparse, dense, name)
        assert int(dense[4].sum()) > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True])
def test_cuda_simulate_tau_kernel_path_matches_unfused(cuda, sparse):
    """simulate(method=TAU_LEAP) on the card: the tau kernel path (one
    launch per window) against the unfused tau loop, records, telemetry
    and final pool bit for bit."""
    exp = T.Experiment(model=MODELS["lv8"](),
                       ensemble=T.Ensemble.make(replicas=512),
                       schedule=T.Schedule(t_end=0.6, n_windows=3),
                       n_lanes=128, seed=6, method=T.Method.TAU_LEAP,
                       sparse=sparse)
    call = tks.sparse_tau_window_call if sparse else tks.tau_window_call
    before = call.launches
    fused = T.simulate(exp.with_(use_kernel=True))  # default device
    assert call.launches == before + 3
    unfused = T.simulate(exp, device=cuda)
    for a, b in zip(fused.records, unfused.records):
        for f in ("mean", "var", "ci90"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    for f in ("steps_per_window", "leaps_per_window"):
        assert getattr(fused.telemetry, f) == getattr(unfused.telemetry, f)
    assert sum(fused.telemetry.leaps_per_window) > 0
    assert (fused.final_state() == unfused.final_state()).all()
