"""The generated dense exact-SSA window kernel on the card.

`ssa_window_generated` (the network compiled into the kernel,
`kernels/netgen.py`) against the table kernel `ssa_window_tables`
(`csrc/ssa_window.cu`) and the plain twin `ssa_window_plain`, bit for
bit in x, t, dead, steps and the counters: lv2, lv4, lv8, ecoli,
transport and ring8, shared and per-lane rates, a budget cut so lanes
stop mid-window, B = 1000 (not a multiple of the block), dead lanes, a
lane at the horizon and lanes holding -0 populations. `ssa_window_call`
launches the generated kernel and counts; a second bind of a network
with other rates, and a run of the engine, compile nothing.

Every test needs a CUDA device and nvcc and skips itself without them.
The file imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_generated.py
"""
import numpy as np
import pytest
import torch

import repro_torch.api as T
from repro_torch.core import gillespie as tg
from repro_torch.core.cwc.compile import compile_model
from repro_torch.core.cwc.models import MODELS
from repro_torch.kernels import build
from repro_torch.kernels import ssa_step as tks

NAMES = ("lv2", "lv4", "lv8", "ecoli", "transport", "ring8")
HORIZON = {"lv2": 0.5, "lv4": 0.2, "lv8": 0.05, "ecoli": 10.0,
           "transport": 2.0, "ring8": 0.25}
OUTS = ("x", "t", "dead", "steps", "ctr", "ctr_hi")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _assert_bitwise(outs_a, outs_b, what):
    for a, c, f in zip(outs_a, outs_b, OUTS):
        if a.dtype == torch.float32:
            a, c = a.view(torch.int32), c.view(torch.int32)
        assert torch.equal(a, c), (what, f)


def _window_args(name, b, per_lane, device):
    """A window's operands: lane 20 + s holds a -0 population of species
    s, lane 7 only -0s, lane 11 is dead, lane 13 sits at the horizon."""
    ts = compile_model(MODELS[name]())[0]
    rng = np.random.default_rng(11)
    rates = ((ts.rates[None] * rng.uniform(0.5, 1.5, (b, ts.n_reactions)))
             .astype(np.float32) if per_lane else None)
    pool = tg.init_lanes(ts, b, 11, device=device)
    x = pool.x.clone()
    m = min(ts.n_species, 16)
    x[20 + torch.arange(m), torch.arange(m)] = -0.0
    x[7, :] = -0.0
    dead = pool.dead.to(torch.int32).clone()
    dead[11] = 1
    t = pool.t.clone()
    t[13] = HORIZON[name]
    return (x, t, dead, pool.key, pool.ctr, pool.ctr_hi,
            *tg.system_tensors(ts, rates, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("per_lane, n_steps",
                         [(False, 4096), (True, 4096), (False, 3),
                          (True, 3)])
def test_cuda_generated_kernel_matches_table_kernel_and_twin(
        cuda, name, per_lane, n_steps):
    """Generated, table kernel and plain twin agree bit for bit; the -0
    lane that fires nothing keeps its -0s."""
    args = _window_args(name, 1000, per_lane, cuda)
    h = HORIZON[name]
    gen = tks.ssa_window_generated(*args, h, n_steps=n_steps)
    tab = tks.ssa_window_tables(*args, h, n_steps=n_steps)
    plain = tks.ssa_window_plain(*args, h, n_steps=n_steps)
    torch.cuda.synchronize()
    _assert_bitwise(gen, tab, f"{name} generated vs tables")
    _assert_bitwise(gen, plain, f"{name} generated vs twin")
    assert int(gen[3][7]) == 0 and torch.signbit(gen[0][7]).all()
    assert int(gen[3].sum()) > 0


@pytest.mark.cuda
def test_cuda_call_launches_the_generated_kernel(cuda):
    """`ssa_window_call` launches the generated kernel, bound here or by
    the caller, and counts each launch in `.launches`."""
    args = _window_args("lv8", 1000, False, cuda)
    net = tks.bind_network(*args[6:9])
    launches = tks.ssa_window_call.launches
    out = tks.ssa_window_call(*args, HORIZON["lv8"], n_steps=64)
    bound = tks.ssa_window_call(*args, HORIZON["lv8"], n_steps=64, net=net)
    assert tks.ssa_window_call.launches == launches + 2
    gen = tks.ssa_window_generated(*args, HORIZON["lv8"], n_steps=64,
                                   net=net)
    _assert_bitwise(out, gen, "lv8 call")
    _assert_bitwise(bound, gen, "lv8 call, bound")


@pytest.mark.cuda
def test_cuda_second_bind_compiles_nothing(cuda):
    """A network bound once binds again, with other rates, from the
    process's cache; the engine's runs of it, a sweep's per-lane rates
    included, compile nothing more."""
    ts = compile_model(MODELS["lv8"]())[0]
    tks.bind_network(*tg.system_tensors(ts, device=cuda)[:3])
    compiles, hits = build.load_network.compiles, build.load_network.hits
    rates = (ts.rates * 1.5).astype(np.float32)
    net = tks.bind_network(*tg.system_tensors(ts, rates, device=cuda)[:3])
    assert build.load_network.compiles == compiles
    assert build.load_network.hits == hits + 1
    args = _window_args("lv8", 1000, True, cuda)
    _assert_bitwise(
        tks.ssa_window_generated(*args, 0.05, n_steps=256, net=net),
        tks.ssa_window_tables(*args, 0.05, n_steps=256), "rebound")
    for sweep in (None, {"die": (0.3, 0.9)}):
        exp = T.Experiment(model=MODELS["lv8"](),
                           ensemble=T.Ensemble.make(replicas=2048,
                                                    sweep=sweep),
                           schedule=T.Schedule(t_end=0.5, n_windows=2),
                           n_lanes=1024, use_kernel=True)
        launches = tks.ssa_window_call.launches
        T.simulate(exp, device=cuda)
        assert tks.ssa_window_call.launches == launches + 2
    assert build.load_network.compiles == compiles
