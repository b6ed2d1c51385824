"""The port's CWC layer and sequential oracle against the reference's.

The six cases of tests/test_cwc.py run against the port: the term walk,
compile shapes, the oracle's matchset against the compiled propensities,
the oracle runs, the oracle against the port's engine (statistically)
and mass conservation under transport. Then parity: both oracles draw
from numpy's `default_rng`, so for one model, grid and seed the port's
`simulate` gives the reference's trajectory bit for bit, and
`build_matchset` / `matchset_rates` give the reference's rates on the
same terms. `csv_sink` writes the reference's text for the same
records, and `run_reference_trajectory` (one lane through `advance_to`,
the dense exact SSA, bitwise for R <= 17) the reference's populations.
"""
import gc

import numpy as np
import pytest
import torch

from repro.core import gillespie as j_gillespie
from repro.core import stream as j_stream
from repro.core.cwc import models as j_models
from repro.core.cwc import reference as j_ref
from repro.core.cwc.compile import compile_model as j_compile
from repro_torch.core import gillespie as t_gillespie
from repro_torch.core import stream as t_stream
from repro_torch.core.cwc import models as t_models
from repro_torch.core.cwc import reference
from repro_torch.core.cwc.compile import compile_model
from repro_torch.core.cwc.models import (
    ecoli_gene_regulation,
    lotka_volterra,
    membrane_transport,
)
from repro_torch.core.cwc.terms import comp, term
from repro_torch.core.engine import SimConfig, SimulationEngine
from repro_torch.core.reactions import propensities

MODEL_FNS = ("lotka_volterra", "ecoli_gene_regulation", "membrane_transport")
GRIDS = {"lotka_volterra": np.linspace(0.5, 5.0, 10),
         "ecoli_gene_regulation": np.linspace(1.0, 10.0, 10),
         "membrane_transport": np.linspace(1.0, 10.0, 10)}


def _models(fn_name):
    """(reference model, port model) of one model function."""
    if fn_name == "lotka_volterra":
        return j_models.lotka_volterra(2), t_models.lotka_volterra(2)
    return getattr(j_models, fn_name)(), getattr(t_models, fn_name)()


def _parse_path(ctx: str):
    if "[" not in ctx:
        return ()
    inside = ctx[ctx.index("[") + 1:ctx.index("]")]
    return tuple(int(p) for p in inside.split("."))


def _term_for_state(model, species_names, x):
    """The model's initial term with its contents overwritten by the
    state vector x (species names are "<ctx>/<atom>")."""
    t0 = model.initial_term()
    by_path = {pth: content for pth, _, content in t0.walk()}
    for i, name in enumerate(species_names):
        ctx, atom = name.rsplit("/", 1)
        c = by_path[_parse_path(ctx)].atoms
        if x[i] > 0:
            c[atom] = int(x[i])
        elif atom in c:
            del c[atom]
    return t0


# ----------------------------------------------- tests/test_cwc.py's six


def test_term_walk_and_counts():
    t = term({"a": 3}, comps=[comp("cell", wrap={"m": 1},
                                   content=term({"b": 2}))])
    paths = [p for p, _, _ in t.walk()]
    assert paths == [(), (0,)]
    assert t.total_atoms() == 3 + 2 + 1


def test_compile_shapes():
    sys, _ = compile_model(lotka_volterra(2))
    assert sys.n_species == 2 and sys.n_reactions == 3
    sys, _ = compile_model(ecoli_gene_regulation())
    assert sys.n_species == 4 and sys.n_reactions == 6
    sys, _ = compile_model(membrane_transport())
    assert sys.n_species == 4 and sys.n_reactions == 3


@pytest.mark.parametrize("model_fn", [lotka_volterra, ecoli_gene_regulation,
                                      membrane_transport])
def test_compiled_propensities_match_reference_matchset(model_fn, rng):
    """The oracle's total match rate equals the sum of the port's
    compiled propensities on random states."""
    model = model_fn()
    sys, _ = compile_model(model)
    for _ in range(5):
        x = rng.integers(0, 30, sys.n_species).astype(np.float32)
        t0 = _term_for_state(model, sys.species_names, x)
        ref_total = sum(m.rate for m in reference.build_matchset(
            t0, model.rules))
        a = propensities(torch.from_numpy(x[None]),
                         torch.from_numpy(sys.reactant_idx.astype(np.int32)),
                         torch.from_numpy(sys.reactant_coef.astype(np.int32)),
                         torch.from_numpy(sys.rates.astype(np.float32)))
        assert abs(float(a.sum()) - ref_total) < 1e-3 * max(1.0, ref_total)


def test_reference_simulator_runs():
    out = reference.simulate(ecoli_gene_regulation(),
                             np.linspace(1, 10, 10), seed=0)
    assert out.shape == (10, 2)
    assert (out >= 0).all()


def test_reference_vs_tensor_engine_statistical():
    """Means of the sequential oracle and of the port's engine agree
    within CI on the E. coli model."""
    model = ecoli_gene_regulation()
    grid = np.linspace(2, 10, 5)
    n_ref = 30
    ref = np.stack([reference.simulate(model, grid, seed=s)
                    for s in range(n_ref)])  # (n, T, 2)
    cfg = SimConfig(n_instances=256, t_end=10.0, n_windows=5, n_lanes=256,
                    schema="iii", seed=1)
    recs = SimulationEngine(model, cfg, device="cpu").run()
    for w in range(5):
        m_t = recs[w].mean
        m_r = ref[:, w].mean(axis=0)
        sd_r = ref[:, w].std(axis=0) / np.sqrt(n_ref)
        err = np.abs(m_t - m_r)
        assert (err < 5 * sd_r + 2.0).all(), (w, m_t, m_r, sd_r)


def test_transport_conserves_mass():
    cfg = SimConfig(n_instances=32, t_end=20.0, n_windows=4, n_lanes=32,
                    schema="iii", seed=2)
    eng = SimulationEngine(membrane_transport(), cfg, device="cpu")
    eng.run()
    x = eng._pool.x.numpy()  # columns: ⊤/a, ⊤/b, cell/a, cell/b
    names = eng.system.species_names
    a_tot = x[:, names.index("⊤/a")] + x[:, names.index("cell[0]/a")]
    b_tot = x[:, names.index("⊤/b")] + x[:, names.index("cell[0]/b")]
    assert ((a_tot + 2 * b_tot) == 500).all()


# --------------------------------------------- bitwise against the oracle


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("fn_name", MODEL_FNS)
def test_oracle_trajectory_bitwise(fn_name, seed):
    j_model, t_model = _models(fn_name)
    grid = GRIDS[fn_name]
    want = j_ref.simulate(j_model, grid, seed=seed)
    got = reference.simulate(t_model, grid, seed=seed)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fn_name", MODEL_FNS)
def test_matchset_rates_bitwise(fn_name, rng):
    """`matchset_rates` and the `build_matchset` rate list (in walk
    order) on the initial term and on random states."""
    j_model, t_model = _models(fn_name)
    sys, _ = compile_model(t_model)
    assert sys.species_names == j_compile(j_model)[0].species_names
    states = [None] + [rng.integers(0, 40, sys.n_species) for _ in range(8)]
    for x in states:
        if x is None:
            jt, tt = j_model.initial_term(), t_model.initial_term()
        else:
            jt = _term_for_state(j_model, sys.species_names, x)
            tt = _term_for_state(t_model, sys.species_names, x)
        assert reference.matchset_rates(t_model, tt) == \
            j_ref.matchset_rates(j_model, jt)
        jms = j_ref.build_matchset(jt, j_model.rules)
        tms = reference.build_matchset(tt, t_model.rules)
        assert [m.rate for m in tms] == [m.rate for m in jms]
        assert [(m.rule.name, m.path, m.child_index) for m in tms] == \
            [(m.rule.name, m.path, m.child_index) for m in jms]


def _contents(t):
    return [(path, label, dict(c.atoms)) for path, label, c in t.walk()]


@pytest.mark.parametrize("fn_name", MODEL_FNS)
def test_apply_match_bitwise(fn_name):
    """Each match of the initial term, applied to a fresh term in both
    packages, leaves the same contents."""
    j_model, t_model = _models(fn_name)
    jms = j_ref.build_matchset(j_model.initial_term(), j_model.rules)
    tms = reference.build_matchset(t_model.initial_term(), t_model.rules)
    assert len(tms) == len(jms) > 0
    for i in range(len(tms)):
        jt, tt = j_model.initial_term(), t_model.initial_term()
        j_ref.apply_match(jt, j_ref.build_matchset(jt, j_model.rules)[i])
        reference.apply_match(tt, reference.build_matchset(
            tt, t_model.rules)[i])
        assert _contents(tt) == _contents(jt)
        assert _contents(tt) != _contents(t_model.initial_term())


# ------------------------------------------------ csv_sink and the trajectory


def _records(n_obs, n=6):
    return [t_stream.StatsRecord(
        t=0.5 * w, window=w, mean=np.arange(n_obs, dtype=np.float32) * w,
        var=np.full(n_obs, 1.0 / (w + 3), np.float32),
        ci90=np.full(n_obs, np.float32(np.pi) * w, np.float32), n=10)
        for w in range(n)]


def test_csv_sink_writes_the_reference_text(tmp_path):
    """The same records through both packages' stream and `csv_sink`."""
    names = ["a", "b", "c"]
    texts = []
    for pkg in (j_stream, t_stream):
        path = str(tmp_path / f"{pkg.__name__}.csv")
        stream = pkg.StatsStream(maxlen=4)
        stream.attach(pkg.csv_sink(path, names))
        for rec in _records(len(names)):
            stream.emit(pkg.StatsRecord(**vars(rec)))
        assert stream.dropped == 2  # bounded buffer, every row written
        stream.close()
        texts.append(open(path).read())
    assert texts[1] == texts[0]
    assert len(texts[1].splitlines()) == 7
    assert texts[1].startswith("t,n,a_mean,a_var,a_ci90")


def test_csv_sink_finaliser_closes_an_abandoned_sink(tmp_path):
    path = tmp_path / "abandoned.csv"
    sink = t_stream.csv_sink(str(path), ["x"])
    for rec in _records(1, 3):
        sink(rec)
    del sink
    gc.collect()
    assert len(path.read_text().splitlines()) == 4
    closed = t_stream.CsvSink(str(tmp_path / "closed.csv"), ["x"])
    closed.close()
    closed.__del__()  # a second close is a no-op
    with pytest.raises(ValueError, match="is closed"):
        closed(_records(1, 1)[0])


@pytest.mark.parametrize("name", ["lv2", "ecoli"])
def test_run_reference_trajectory_bitwise(name):
    grid = np.linspace(0.25, 2.5, 10)
    j_sys, _ = j_compile(j_models.MODELS[name]())
    t_sys, _ = compile_model(t_models.MODELS[name]())
    want = np.asarray(j_gillespie.run_reference_trajectory(j_sys, grid,
                                                           seed=3))
    got = t_gillespie.run_reference_trajectory(t_sys, grid, seed=3,
                                               device="cpu")
    assert got.shape == (10, t_sys.n_species) and got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()
    assert (np.diff(want, axis=0) != 0).any()  # the grid saw events


def test_run_reference_trajectory_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t_sys, _ = compile_model(t_models.MODELS["lv2"]())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_gillespie.run_reference_trajectory(t_sys, [0.5])
