"""The generated dense exact-SSA window kernel (`kernels/netgen.py`) on
the CPU.

The generator must spell each model's structure as the tables hold it:
every reaction's reactant slots in slot order and its nonzero delta
entries. The library's digest must ignore the rates and follow every
structural entry, the generator must take every shape the dense
kernels take, the engine must bind the generated kernel for the exact
path (and the dependency mask for tau), and the CPU path must never
reach nvcc.

The generated source is also built with g++ against a CPU stand-in for
the CUDA runtime (`tests/cuda_stub/cuda_runtime.h`: a thread a lane, a
barrier a block, two one-block SMs, so lanes past the first wave come
from the ticket) and run against the plain twin, bit for bit: shared and
per-lane rates, a budget cut mid-window, dead lanes, a lane at the
horizon and lanes holding -0 populations. On the card the same cases run
in `tests/test_torch_cuda_generated.py`.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.api as T
from repro_torch.core import dispatch as tdisp
from repro_torch.core import gillespie as tg
from repro_torch.core.cwc.compile import compile_model
from repro_torch.core.cwc.models import MODELS
from repro_torch.kernels import build, netgen
from repro_torch.kernels import ssa_step as tks

NAMES = ("lv2", "lv4", "lv8", "ecoli", "transport", "ring8")
HORIZON = {"lv2": 0.5, "lv4": 0.2, "lv8": 0.05, "ecoli": 10.0,
           "transport": 2.0, "ring8": 0.25}
STUB = Path(__file__).resolve().parent / "cuda_stub"
OUTS = ("x", "t", "dead", "steps", "ctr", "ctr_hi")


def _tables(name, rates=None):
    ts = compile_model(MODELS[name]())[0]
    return ts, tg.system_tensors(ts, rates, device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_network_holds_the_tables_structure(name):
    """Each reaction's slots are its (species, coefficient) pairs with a
    coefficient above 0, in slot order; its changes are delta's nonzero
    entries, in species order, with their float32 values."""
    ts, (idx, coef, delta, _) = _tables(name)
    net = netgen.network(idx, coef, delta)
    assert (net.n_species, net.n_reactions) == (ts.n_species,
                                                ts.n_reactions)
    for j in range(ts.n_reactions):
        assert net.slots[j] == tuple(
            (int(i), int(c)) for i, c in zip(ts.reactant_idx[j],
                                             ts.reactant_coef[j]) if c > 0)
        nz = np.flatnonzero(ts.delta[j])
        assert net.changes[j] == tuple(
            (int(q), float(np.float32(ts.delta[j, q]))) for q in nz)


@pytest.mark.parametrize("name", NAMES)
def test_source_spells_every_slot_and_change(name):
    """The source's Match line of reaction r multiplies its rate by one
    comb factor a slot, in slot order; its Update block adds exactly its
    nonzero delta entries; S and R are its constants."""
    _, (idx, coef, delta, _) = _tables(name)
    net = netgen.network(idx, coef, delta)
    src = netgen.window_source(net)
    assert f"constexpr int S = {net.n_species};" in src
    assert f"constexpr int R = {net.n_reactions};" in src
    for r in range(net.n_reactions):
        (line,) = re.findall(rf"^  a\[{r}\] = (.*);$", src, re.M)
        assert line.count("__fmul_rn(") == len(net.slots[r])
        assert re.findall(r"comb_factor\(x\[(\d+)\], (\d+),", line) == [
            (str(s), str(c)) for s, c in net.slots[r]]
        assert line.startswith("__fmul_rn(" * len(net.slots[r])
                               + f"k[{r}]")
        blocks = re.findall(rf"^  if \(j == {r}\) \{{ (.*) \}}$", src, re.M)
        adds = re.findall(r"x\[(\d+)\] = __fadd_rn\(x\[\1\], ([^)]*)\);",
                          blocks[0]) if blocks else []
        assert [(int(s), float(v.rstrip("f"))) for s, v in adds] == list(
            net.changes[r])


@pytest.mark.parametrize("name", NAMES)
def test_digest_ignores_rates_and_follows_structure(name):
    """One library for any rates; another for any change of a slot's
    species, a slot's coefficient or a delta entry."""
    ts, (idx, coef, delta, _) = _tables(name)
    rng = np.random.default_rng(0)
    other = ts.rates * rng.uniform(0.5, 2.0, ts.rates.shape)
    _, (idx2, coef2, delta2, _) = _tables(name, other.astype(np.float32))

    def lib(i, c, d):
        return build.network_library_path(
            netgen.window_source(netgen.network(i, c, d)))

    base = lib(idx, coef, delta)
    assert lib(idx2, coef2, delta2) == base
    j = next(j for j in range(ts.n_reactions) if coef[j, 0] > 0)
    moved = idx.clone()
    moved[j, 0] = (moved[j, 0] + 1) % ts.n_species
    heavier = coef.clone()
    heavier[j, 0] += 1
    changed = delta.clone()
    changed[j, 0] += 1.0
    variants = [lib(moved, coef, delta), lib(idx, heavier, delta),
                lib(idx, coef, changed)]
    assert len({base, *variants}) == 4
    assert netgen.network_name(netgen.network(idx, coef, changed)) != \
        netgen.network_name(netgen.network(idx, coef, delta))


@pytest.mark.parametrize("s", [1, 8, 32, tks.MAX_S])
def test_source_at_the_dense_caps(s):
    """Every shape the dense kernels take, up to R = MAX_R reactions,
    gets its own source: S and R as constants, a Match line a reaction
    and an Update block a reaction that changes something."""
    r = tks.MAX_R
    j = torch.arange(r)
    idx = torch.zeros((r, 4), dtype=torch.int32)
    coef = torch.zeros_like(idx)
    idx[:, 0], coef[:, 0] = j % s, 1
    delta = torch.zeros((r, s), dtype=torch.float32)
    delta[j, j % s] = -1.0
    delta[j, (j + 1) % s] += 1.0  # S = 1: the reactions change nothing
    net = netgen.network(idx, coef, delta)
    src = netgen.window_source(net)
    assert f"constexpr int S = {s};" in src
    assert f"constexpr int R = {r};" in src
    assert len(re.findall(r"^  a\[\d+\] = ", src, re.M)) == r
    assert len(re.findall(r"^  if \(j == \d+\) \{", src, re.M)) == (
        0 if s == 1 else r)


class _CardRates:
    """Stands in for rates on the card: `_ShardBody` binds the kernels'
    operands only for CUDA rates."""

    is_cuda = True


@pytest.mark.parametrize("method", ["exact", "tau"])
def test_engine_binds_each_dense_kernel_once(monkeypatch, method):
    """The exact path binds the network's generated kernel, the tau path
    its dependency mask; each once a body, whatever the rates."""
    bound = []
    monkeypatch.setattr(tdisp, "bind_network",
                        lambda *t: bound.append("net") or "net")
    monkeypatch.setattr(tdisp, "dense_dep_mask",
                        lambda *t: bound.append("dep_mask") or "dep_mask")
    exp = T.Experiment(model=MODELS["lv8"](),
                       ensemble=T.Ensemble.make(replicas=16),
                       schedule=T.Schedule(t_end=0.2, n_windows=2),
                       n_lanes=8, use_kernel=True,
                       method=(T.Method.TAU_LEAP if method == "tau"
                               else T.Method.EXACT))
    eng = T.build_engine(exp, device="cpu")
    body = tdisp._ShardBody(eng, torch.device("cpu"))
    want = {"exact": "net", "tau": "dep_mask"}[method]
    for _ in range(3):
        assert body._dense_bound(_CardRates()) == {want: want}
    assert bound == [want]
    assert body._dense_bound(torch.ones(9)) == {}


def test_cpu_path_never_calls_nvcc(monkeypatch):
    """The kernel path on the CPU runs the twins: nothing binds, builds
    or loads a generated kernel."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the kernel build")

    compiles = build.load_network.compiles
    for mod, attr in ((build, "_nvcc"), (build, "nvcc_path"),
                      (build, "load_network"), (tks, "bind_network"),
                      (tdisp, "bind_network")):
        monkeypatch.setattr(mod, attr, refuse)
    exp = T.Experiment(model=MODELS["lv8"](),
                       ensemble=T.Ensemble.make(replicas=64),
                       schedule=T.Schedule(t_end=0.2, n_windows=2),
                       n_lanes=32, use_kernel=True)
    res = T.simulate(exp, device="cpu")
    assert len(res.records) == 2
    ts, tens = _tables("lv8")
    pool = tg.init_lanes(ts, 8, 0, device="cpu")
    tks.ssa_window_call(pool.x, pool.t, pool.dead.to(torch.int32), pool.key,
                        pool.ctr, pool.ctr_hi, *tens, 0.05, n_steps=8)
    monkeypatch.undo()
    assert build.load_network.compiles == compiles


# ---------------------------------------------------------------------------
# the generated source on the CPU stub


@pytest.fixture(scope="module")
def stub_kernels(tmp_path_factory):
    """name -> the generated kernel's C launcher, built by g++ against
    the CPU stub runtime."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the generated source on the CPU")
    out = tmp_path_factory.mktemp("netgen_stub")
    built = {}

    def get(name):
        if name not in built:
            _, (idx, coef, delta, _) = _tables(name)
            src = netgen.window_source(netgen.network(idx, coef, delta))
            src, n = re.subn(
                r"ssa_window_kernel<<<(\w+), (\w+), 0, "
                r"\(cudaStream_t\)stream>>>\(p\);",
                r"stub_launch(ssa_window_kernel, \1, \2, p);", src)
            assert n == 1
            cpp, so = out / f"{name}.cpp", out / f"{name}.so"
            cpp.write_text(src)
            subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off",
                            "-pthread", "-shared", "-fPIC", f"-I{STUB}",
                            f"-I{build.CSRC}", "-o", str(so), str(cpp)],
                           check=True, capture_output=True)
            fn = ctypes.CDLL(str(so)).ssa_window_net_launch
            fn.argtypes = tks._NET_ARGTYPES
            fn.restype = ctypes.c_int
            built[name] = fn
        return built[name]

    return get


def _stub_window(fn, x, t, dead, key, ctr, ctr_hi, rates, horizon, n_steps):
    outs = (torch.empty_like(x), torch.empty_like(t), torch.empty_like(dead),
            torch.empty_like(dead), torch.empty_like(ctr),
            torch.empty_like(ctr_hi))
    ticket = torch.zeros((1,), dtype=torch.int32)
    err = fn(*(a.data_ptr() for a in (x, t, dead, key, ctr, ctr_hi, rates)),
             int(rates.ndim == 2), float(np.float32(horizon)), int(n_steps),
             x.shape[0], ticket.data_ptr(), *(o.data_ptr() for o in outs),
             None)
    assert err == 0
    return outs


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("per_lane, n_steps",
                         [(False, 4096), (True, 4096), (False, 3)])
def test_generated_source_matches_plain_twin_on_cpu_stub(stub_kernels, name,
                                                         per_lane, n_steps):
    """300 lanes (256 from the grid, 44 from the ticket), bit for bit
    against `ssa_window_plain`: lane 20 + s holds a -0 population of
    species s, lane 7 only -0s (so it fires nothing), lane 11 is dead,
    lane 13 sits at the horizon."""
    ts = compile_model(MODELS[name]())[0]
    b = 300
    rng = np.random.default_rng(3)
    rates = ((ts.rates[None] * rng.uniform(0.5, 1.5, (b, ts.n_reactions)))
             .astype(np.float32) if per_lane else None)
    pool = tg.init_lanes(ts, b, 3, device="cpu")
    tens = tg.system_tensors(ts, rates, device="cpu")
    x = pool.x.clone()
    m = min(ts.n_species, 16)
    x[20 + torch.arange(m), torch.arange(m)] = -0.0
    x[7, :] = -0.0
    dead = pool.dead.to(torch.int32).clone()
    dead[11] = 1
    t = pool.t.clone()
    t[13] = HORIZON[name]
    args = (x, t, dead, pool.key, pool.ctr, pool.ctr_hi)
    k = _stub_window(stub_kernels(name), *args, tens[3], HORIZON[name],
                     n_steps)
    p = tks.ssa_window_plain(*args, *tens, HORIZON[name], n_steps=n_steps)
    for a, c, f in zip(k, p, OUTS):
        if a.dtype == torch.float32:
            a, c = a.view(torch.int32), c.view(torch.int32)
        assert torch.equal(a, c), f
    assert int(k[3][20:20 + m].sum()) > 0 and int(k[3][7]) == 0
    assert torch.signbit(k[0][7]).all()
