"""The port on the card: each CUDA kernel (dense SSA window, sparse SSA
window, Match, dense and sparse tau-leap windows) against its plain
twin, the sparse kernels against the dense ones, the tau kernel with an
unreachable leap threshold against the exact kernel, the persistent
lanes' ticket, the fused-kernel engine paths against the unfused
ones, and each window kernel's path through supersteps (pinned rings,
one host sync per block), through a checkpoint and resume, and through
four shards on the one card (restores across shard counts, supervised
drills), and a farm of two worker processes on the one card, bit for
bit on one device.

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
from repro_torch.core import reduction as tred
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
            assert tkp.propensity_call.route == "shared"
            p = tkp.propensity_plain(x, tens[0], tens[1], rates)
            torch.cuda.synchronize()
            assert torch.equal(k.view(torch.int32), p.view(torch.int32)), \
                (name, per_lane)


def _match_tables(name, rng):
    """(S, idx, coef, rates) int32/float32 numpy tables of a Match case:
    a system's, or raw tables ("raw6": M = 6 slots, coefficients up to
    7; "table70000": 70,000 species, R = 300, coefficients up to 6)."""
    if name in ("raw6", "table70000"):
        s, r, m, c = ((50, 33, 6, 7) if name == "raw6"
                      else (70_000, 300, 4, 6))
        idx = rng.integers(0, s, (r, m)).astype(np.int32)
        coef = rng.integers(1, c + 1, (r, m)).astype(np.int32)
        coef[rng.random((r, m)) < 0.3] = 0
        return s, idx, coef, rng.uniform(0.1, 2.0, r).astype(np.float32)
    ts = _system(name)
    return (ts.n_species, ts.reactant_idx.astype(np.int32),
            ts.reactant_coef.astype(np.int32), ts.rates)


def _match_populations(rng, b, s, extreme):
    """Counts in [0, 300); `extreme` adds negatives, NaN, 2^24 and more,
    1e30 (squared: inf) and +-inf."""
    x = rng.integers(0, 300, (b, s)).astype(np.float32)
    if extreme:
        u = rng.random((b, s))
        x[u < 0.05] = -rng.integers(1, 6, int((u < 0.05).sum()))
        x[(u >= 0.05) & (u < 0.08)] = np.nan
        big = (u >= 0.08) & (u < 0.14)
        x[big] = rng.choice(np.float32([2**24, 2**24 + 2, 3e7, 1e30, np.inf,
                                        -np.inf]), int(big.sum()))
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,extreme,offset,route", [
    ("ring80", 65_536 + 5, False, 0, "shared"),  # a ragged last tile
    ("ring80", 7, False, 0, "shared"),  # fewer lanes than one tile
    ("lv8", 1001, False, 0, "shared"),  # R = 9: stores not all 16 bytes
    ("ring80", 3000, True, 0, "shared"),
    ("ring80", 3000, True, 3, "shared"),  # x and rates off 16 bytes
    ("quartic", 3000, True, 0, "shared"),  # coefficients 3 and 4
    ("raw6", 777, True, 0, "global"),  # six slots a reaction
    ("table70000", 300, True, 0, "global"),
])
def test_cuda_propensity_kernel_routes_match_plain_twin(cuda, name, b,
                                                        extreme, offset,
                                                        route):
    """The Match kernel on each route against its plain twin, bit for
    bit, shared and per-lane rates: ragged tiles, R not a multiple of 4,
    negative, NaN, huge and infinite populations, coefficients up to 7,
    operands not 16-byte aligned, a system too large for shared
    memory."""
    rng = np.random.default_rng(7)
    s, idx, coef, shared = _match_tables(name, rng)
    r = idx.shape[0]
    tens = (torch.as_tensor(idx, device=cuda),
            torch.as_tensor(coef, device=cuda))
    xs = _match_populations(rng, b, s, extreme).reshape(-1)
    x = torch.as_tensor(np.concatenate([np.zeros(offset, np.float32), xs]),
                        device=cuda)[offset:].view(b, s)
    for per_lane in (False, True):
        rl = (shared[None] * rng.uniform(0.5, 1.5, (b, r))).astype(
            np.float32).reshape(-1)
        rates = (torch.as_tensor(np.concatenate(
            [np.zeros(offset, np.float32), rl]), device=cuda)[offset:]
                 .view(b, r) if per_lane
                 else torch.as_tensor(shared, device=cuda))
        before = tkp.propensity_call.launches
        k = tkp.propensity_call(x, *tens, rates)
        assert tkp.propensity_call.launches == before + 1
        assert tkp.propensity_call.route == route
        assert tkp.propensity_call.tile == tkp.match_lanes_per_tile(
            s, r, idx.shape[1])
        p = tkp.propensity_plain(x, *tens, rates)
        torch.cuda.synchronize()
        assert torch.equal(k.view(torch.int32), p.view(torch.int32)), \
            (name, b, per_lane)
        if extreme:
            assert bool(torch.isnan(p).any()) and bool(torch.isinf(p).any())


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
@pytest.mark.parametrize("name,sparse,rates,no_leap,n_steps,b", [
    ("ring80", True, "sweep", True, 4096, 16384),
    ("ring80", True, "shared", False, 1, 16384),  # a budget cut
    ("lattice8x8", True, "sweep", False, 4096, 16384),
    ("ring256", True, "shared", False, 4096, 8192),
    ("ring8", True, "negative", False, 4096, 16384),
    ("ring8", False, "negative", False, 4096, 1 << 19),
    ("lv8", False, "sweep", True, 4096, 1 << 19),
])
def test_cuda_tau_kernels_take_lanes_from_the_ticket(cuda, name, sparse,
                                                     rates, no_leap,
                                                     n_steps, b):
    """The redesigned tau kernels against their plain twins, bitwise, with
    more lanes than one wave of the grid holds (lanes come from the
    ticket: 16,384 warps' lanes are more than the sparse kernel's one
    wave of 132 SMs x 2 blocks x 16, and 2^19 thread lanes more than the
    dense kernel's 132 x 10 x 128): per-lane rates with half the lanes
    pinned to exact steps, a budget cut, lattice8x8 and ring256 (the
    sparse kernel's lanes a block follow the shape), and a negative rate
    in a sweep (negative Poisson means, the scan from row 0)."""
    rng = np.random.default_rng(6)
    ts = _system(name)
    r = (None if rates == "shared" else _rates(ts, b, rng, True)
         if rates == "sweep" else _negative_sweep(ts, b, rng))
    args, max_c = _tau_args(ts, b, r, cuda, sparse, no_leap)
    call, plain, static = (
        (tks.sparse_tau_window_call, tks.sparse_tau_window_plain,
         {"max_c": max_c}) if sparse else
        (tks.tau_window_call, tks.tau_window_plain, {}))
    fb = 3.0 if name == "ring8" else 10.0
    h = HORIZON[name]
    kw = dict(n_steps=n_steps, eps=0.03, fallback=fb, **static)
    k = call(*args, h, **kw)
    assert call.grid_lanes < b
    p = plain(*args, h, **kw)
    torch.cuda.synchronize()
    _assert_tau_bitwise(k, p, (name, sparse, rates))
    assert int(k[4].sum()) > 0, name
    live = (k[1] < h) & (k[2] == 0)
    assert bool(live.any()) == (n_steps == 1), name


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


def _pool_equal(a, b, what):
    for f, x, y in zip(tg.LaneState._fields, a, b):
        assert torch.equal(x, y), (what, f)


def _records_equal(a, b, what):
    assert len(a.records) == len(b.records), what
    for ra, rb in zip(a.records, b.records):
        assert (ra.t, ra.window, ra.n) == (rb.t, rb.window, rb.n), what
        for f in ("mean", "var", "ci90"):
            assert getattr(ra, f).tobytes() == getattr(rb, f).tobytes(), \
                (what, f)


_CARD_CASES = [  # model, method, sparse, sweep: one per window kernel
    ("lv8", "exact", False, None),
    ("lv8", "exact", True, {"reproduce": [0.8, 1.2]}),
    ("ring8", "exact", True, None),
    ("lv8", "tau_leap", False, {"reproduce": [0.8, 1.2]}),
    ("ring8", "tau_leap", True, None),
]


def _card_exp(name, method, sparse, sweep, **kw):
    return T.Experiment(
        model=MODELS[name](),
        ensemble=T.Ensemble.make(replicas=256, sweep=sweep),
        schedule=T.Schedule(t_end=6 * HORIZON[name], n_windows=6),
        n_lanes=128, seed=8, use_kernel=True, method=method, sparse=sparse,
        **kw)


def _window_call(method, sparse):
    if method == "tau_leap":
        return tks.sparse_tau_window_call if sparse else tks.tau_window_call
    return tks.sparse_window_call if sparse else tks.ssa_window_call


@pytest.mark.cuda
@pytest.mark.parametrize("name,method,sparse,sweep", _CARD_CASES)
def test_cuda_kernel_path_checkpoint_resumes_bitwise(cuda, tmp_path, name,
                                                     method, sparse, sweep):
    """A kernel-path run in supersteps of 2 at depth 2, checkpointed at
    window 2 while two blocks are in flight (the save served from the
    oldest ring's entry snapshot, on a side stream) and resumed in a
    fresh engine — which rebinds the kernel's tables to the restored
    rates — ends with the uninterrupted run's pool and records, bit for
    bit. The entry pool, held by reference, is unchanged after every
    block ran: no kernel writes a pool leaf in place."""
    exp = _card_exp(name, method, sparse, sweep, window_block=2,
                    pipeline_depth=2)
    clean = T.simulate(exp)
    eng = T.build_engine(exp)
    eng.enable_snapshots()
    entry = eng._pool
    held = [a.clone() for a in entry]
    for _ in range(3):
        eng.run_block()  # dispatch b0, b1, then b2 and collect b0
    assert len(eng._pending) == 2 and eng._window == 2
    ck = str(tmp_path / "ck")
    eng.checkpoint(ck)
    assert len(eng._pending) == 2 and eng._window == 2
    assert eng.n_snapshot_saves == 1 and eng.n_ckpt_flushes == 0
    assert len(eng.ckpt_pulls) == 1
    assert int(np.load(ck + ".npz")["window"]) == 2
    eng.flush()
    assert eng._window == 6
    for f, a, b in zip(tg.LaneState._fields, held, entry):
        assert torch.equal(a, b), (name, f)
    call = _window_call(method, sparse)
    before = call.launches
    resumed = T.simulate(exp, checkpoint_path=ck, resume=True)
    assert call.launches == before + 4
    per_lane = resumed._engine._rates_dev.ndim == 2
    assert per_lane == (sweep is not None)
    _pool_equal(clean._engine._pool, resumed._engine._pool, name)
    _records_equal(clean, resumed, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name,method,sparse,sweep", _CARD_CASES)
def test_cuda_supersteps_bitwise_one_sync_per_block(cuda, name, method,
                                                    sparse, sweep):
    """window_block=3 at pipeline_depth=2 on the card (rings copied into
    pinned host memory, waited on by event) against the per-window
    path: records and pool bit for bit, one launch per window, one
    dispatch and one host sync per block."""
    base = T.simulate(_card_exp(name, method, sparse, sweep))
    call = _window_call(method, sparse)
    before = call.launches
    got = T.simulate(_card_exp(name, method, sparse, sweep, window_block=3,
                               pipeline_depth=2))
    assert call.launches == before + 6
    t = got.telemetry
    assert t.dispatches == t.host_syncs == 2
    assert t.peak_inflight_blocks == 2
    _records_equal(base, got, name)
    assert got.telemetry.steps_per_window == base.telemetry.steps_per_window
    _pool_equal(base._engine._pool, got._engine._pool, name)


VAR_ULP = 12
CI90_ULP = 8


def _ulp(a, b) -> int:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.cuda
def test_cuda_steered_sketched_sweep_matches_cpu(cuda):
    """A steered, sketched lv8 sweep on the card (one kernel launch per
    window, the decision applied on the device, the per-lane rates of
    the moved lanes copied and the kernel tables rebound) against the
    same run on the CPU's plain twin: decision log, sketches and pool
    bit for bit; record means bitwise (sums of populations below 2^24),
    var and ci90 within the ulp bound of the port's parity tests (the
    card sums in another order)."""
    def exp(steering=None):
        return T.Experiment(
            model=MODELS["lv8"](),
            ensemble=T.Ensemble.make(replicas=256,
                                     sweep={"die": [0.4, 1.0]}),
            schedule=T.Schedule(t_end=0.6, n_windows=6),
            reduction=T.Reduction.PER_POINT, n_lanes=128, seed=4,
            use_kernel=True, window_block=2,
            sketch=T.SketchSpec(n_bins=16, thresholds=(500.0,)),
            steering=steering)

    base = T.simulate(exp(), device="cpu")
    pp = base.per_point()
    rel = (pp["ci90"][1].astype(np.float64) / np.maximum(
        np.abs(pp["mean"][1].astype(np.float64)), 1.0)).max(axis=1)
    tol = float(np.sqrt(rel.min() * rel.max()))
    steer = T.Steering(ci_rel_tol=tol, min_windows=2, reallocate=True,
                       bimodality=True)
    cpu = T.simulate(exp(steer), device="cpu")
    before = tks.ssa_window_call.launches
    card = T.simulate(exp(steer), device=cuda)
    assert tks.ssa_window_call.launches == before + 6
    rep = cpu.steering_report()
    assert rep["stopped_points"]
    assert any(d["action"] == "reallocate" for d in rep["decisions"])
    assert card.steering_report() == rep
    assert card.telemetry.host_syncs == card.telemetry.dispatches == 3
    assert len(card.sketches()) == len(cpu.sketches()) == 6
    for a, b in zip(card.sketches(), cpu.sketches()):
        assert a.hist.tobytes() == b.hist.tobytes()
        assert a.rare.tobytes() == b.rare.tobytes()
    for f, x, y in zip(tg.LaneState._fields, card._engine._pool,
                       cpu._engine._pool):
        assert torch.equal(x.cpu(), y), f
    assert torch.equal(card._engine._rates_dev.cpu(), cpu._engine._rates_dev)
    for a, b in zip(card.records, cpu.records):
        assert (a.t, a.window, a.n) == (b.t, b.window, b.n)
        assert a.mean.tobytes() == b.mean.tobytes()
        assert _ulp(a.var, b.var) <= VAR_ULP
        assert _ulp(a.ci90, b.ci90) <= CI90_ULP


def _sharded(exp, n_shards, stat_blocks=8):
    return exp.with_(partitioning=T.Partitioning(n_shards=n_shards,
                                                 stat_blocks=stat_blocks))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_blocks", [(131072, 8), (262144, 2),
                                           (1048576, 1), (1000, 4)])
def test_cuda_blocked_welford_is_the_masked_fold_bitwise(cuda, rows,
                                                         n_blocks):
    """On the card the unmasked block fold gives the masked fold's
    (update_batch into an empty accumulator) n, mean and m2 bit for
    bit, at the main path's block shapes: its sums read fresh copies,
    as the masked products are."""
    rng = np.random.default_rng(rows + n_blocks)
    obs = torch.as_tensor(rng.integers(0, 5000, (rows * n_blocks, 8)),
                          device=cuda)
    xb = obs.reshape(n_blocks, rows, 8)
    parts = [tred.update_batch(
        tred.init_welford((8,), cuda), x) for x in xb]
    want = [torch.stack(leaf) for leaf in zip(*parts)]
    got = tred.blocked_welford(obs, n_blocks)
    for a, b in zip(want, got):
        assert a.cpu().numpy().tobytes() \
            == b.contiguous().cpu().numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("name,method,sparse,sweep", _CARD_CASES)
def test_cuda_four_shards_on_one_card_match_unsharded(cuda, name, method,
                                                      sparse, sweep):
    """Four shards on cuda:0 (each its own kernel launch on the one
    stream, each bound to its own rate slice), in supersteps of 2 at
    depth 2, against the unsharded per-window run at the same
    stat_blocks: records and pool bit for bit, launches = windows x 4,
    one dispatch and one host sync per block."""
    base = T.simulate(_sharded(_card_exp(name, method, sparse, sweep), 1),
                      device=cuda)
    call = _window_call(method, sparse)
    before = call.launches
    got = T.simulate(_sharded(_card_exp(name, method, sparse, sweep,
                                        window_block=2, pipeline_depth=2),
                              4), device=cuda)
    assert call.launches == before + 6 * 4
    assert got.telemetry.dispatches == got.telemetry.host_syncs == 3
    assert [str(d) for d in got._engine.devices] == [str(cuda)] * 4
    _records_equal(base, got, name)
    _pool_equal(base._engine._pool, got._engine._pool, name)


@pytest.mark.cuda
def test_cuda_restore_across_shard_counts(cuda, tmp_path):
    """A 4-shard run on the card saved at window 2 from a ring snapshot
    while a block is in flight (each shard's leaves copied at its row
    offset on the side stream) restores at 1 and at 2 shards and ends
    with the 4-shard run's records and pool."""
    exp = _card_exp("lv8", "exact", False, {"reproduce": [0.8, 1.2]},
                    window_block=2, pipeline_depth=2)
    clean = T.simulate(_sharded(exp, 4), device=cuda)
    eng = T.build_engine(_sharded(exp, 4), device=cuda)
    eng.enable_snapshots()
    for _ in range(3):
        eng.run_block()
    assert len(eng._pending) == 2 and eng._window == 2
    ck = str(tmp_path / "ck")
    eng.checkpoint(ck)
    assert eng.n_snapshot_saves == 1 and eng.n_ckpt_flushes == 0
    eng.flush()
    assert [r.mean.tobytes() for r in eng.stream.records()] \
        == [r.mean.tobytes() for r in clean.records]
    for k in (1, 2):
        resumed = T.simulate(_sharded(exp, k), device=cuda,
                             checkpoint_path=ck, resume=True)
        _records_equal(clean, resumed, k)
        _pool_equal(clean._engine._pool, resumed._engine._pool, k)


@pytest.mark.cuda
def test_cuda_supervised_drills_on_shards(cuda, tmp_path):
    """Supervised 4-shard runs on cuda:0: a crash then a corrupt newest
    file, and two device losses (4 -> 2 -> 1 shards), each end with the
    clean run's records."""
    exp = _sharded(_card_exp("lv8", "exact", False, None), 4)
    clean = T.simulate(exp, device=cuda)
    for label, plan in (("crash", {2: "crash", 4: "ckpt_corrupt"}),
                        ("loss", {1: "device_lost", 4: "device_lost"})):
        rec = T.Recovery(ckpt_dir=str(tmp_path / label), cadence=2,
                         keep_last=2, inject=T.FailurePlan(schedule=plan))
        got = T.simulate(exp.with_(recovery=rec), device=cuda)
        _records_equal(clean, got, label)
        rep = got.recovery_report()
        assert rep["restarts"] == 2, label
        if label == "loss":
            assert rep["final_n_shards"] == 1


@pytest.mark.cuda
def test_cuda_farm_of_two_workers_matches_single_process(cuda, tmp_path):
    """Two worker processes, both on cuda:0 (each its own CUDA context),
    on a per-point lv8 sweep: records, per-point stats and the final
    populations bit for bit equal to the single-process run on the card
    at the same stat_blocks; each worker launched its window kernel once
    per window (its own counter)."""
    exp = _card_exp("lv8", "exact", False, {"reproduce": [0.8, 1.2]},
                    reduction=T.Reduction.PER_POINT)
    base = T.simulate(_sharded(exp, 1, stat_blocks=2), device=cuda)
    got = T.simulate(exp.with_(recovery=T.Recovery(
        ckpt_dir=str(tmp_path / "farm"), workers=2, heartbeat_s=2.0)),
        device=cuda)
    _records_equal(base, got, "farm")
    pa, pb = base.per_point(), got.per_point()
    for f in ("n", "mean", "var", "ci90"):
        assert pa[f].tobytes() == pb[f].tobytes(), f
    assert base.final_state().tobytes() == got.final_state().tobytes()
    rep = got.recovery_report()
    assert rep["restarts"] == 0
    assert [w["device"] for w in rep["per_worker"].values()] \
        == [str(cuda)] * 2
    assert [rep["kernel_launches"][k]["ssa_window"] for k in range(2)] \
        == [6, 6]
