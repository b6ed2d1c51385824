"""Port parity: the model layer — CWC compilation, sweeps, comb factors
and rates-first propensities — against the reference, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reactions as jr
from repro.core.cwc.compile import compile_model as j_compile
from repro.core.cwc.models import MODELS as J_MODELS
from repro.core.sweep import SweepSpec as JSweep, sweep_rates as j_sweep
from repro_torch.core import reactions as tr
from repro_torch.core.cwc.compile import compile_model as t_compile
from repro_torch.core.cwc.models import MODELS as T_MODELS
from repro_torch.core.sweep import SweepSpec as TSweep, sweep_rates as t_sweep

TABLES = ("reactant_idx", "reactant_coef", "delta", "rates", "x0")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", sorted(J_MODELS))
def test_compile_model_tables(name):
    assert sorted(T_MODELS) == sorted(J_MODELS)
    js, jmeta = j_compile(J_MODELS[name]())
    ts, tmeta = t_compile(T_MODELS[name]())
    for f in TABLES:
        a, b = getattr(js, f), getattr(ts, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert (a == b).all(), f
    assert js.species_names == ts.species_names
    assert js.reaction_names == ts.reaction_names
    assert jmeta == tmeta


@pytest.mark.parametrize("name", sorted(J_MODELS))
def test_propensities_bitwise_with_sweep_rates(name, rng):
    """Random integer populations and (B, R) rates: the port's
    rates-first propensities carry the reference's bits."""
    js, _ = j_compile(J_MODELS[name]())
    b = 48
    x = rng.integers(0, 60, (b, js.n_species)).astype(np.float32)
    rates = (rng.uniform(0.1, 3.0, (b, js.n_reactions))
             * js.rates[None]).astype(np.float32)
    j = jax.jit(jr.propensities)(jnp.asarray(x), jnp.asarray(js.reactant_idx),
                                 jnp.asarray(js.reactant_coef),
                                 jnp.asarray(rates))
    t = tr.propensities(torch.from_numpy(x),
                        torch.from_numpy(js.reactant_idx),
                        torch.from_numpy(js.reactant_coef),
                        torch.from_numpy(rates))
    assert t.dtype == torch.float32
    assert (_bits(j) == _bits(t.numpy())).all()


def test_propensities_shared_rates_equal_broadcast(rng):
    js, _ = j_compile(J_MODELS["transport"]())
    x = torch.from_numpy(rng.integers(0, 60, (16, js.n_species)).astype(
        np.float32))
    idx = torch.from_numpy(js.reactant_idx)
    coef = torch.from_numpy(js.reactant_coef)
    r = torch.from_numpy(js.rates)
    a = tr.propensities(x, idx, coef, r)
    b = tr.propensities(x, idx, coef, r.expand(16, -1).contiguous())
    assert (a.numpy().view(np.int32) == b.numpy().view(np.int32)).all()


@pytest.mark.parametrize("max_c", [1, 4, 6])
def test_comb_factors_bitwise(max_c, rng):
    pops = rng.integers(0, 40, (64, 12)).astype(np.float32)
    coef = rng.integers(0, max_c + 1, (64, 12)).astype(np.int32)
    j = jr.comb_factors(jnp.asarray(pops), jnp.asarray(coef), max_c)
    t = tr.comb_factors(torch.from_numpy(pops), torch.from_numpy(coef), max_c)
    assert (_bits(j) == _bits(t.numpy())).all()


def test_require_dense_capable_refuses_large_coefficients():
    big = tr.make_system(["a", "b"], [({"a": 5}, {"b": 1}, 1.0)],
                         {"a": 10})
    with pytest.raises(ValueError, match="MAX_COEF"):
        tr.require_dense_capable(big)
    tr.require_dense_capable(tr.make_system(
        ["a", "b"], [({"a": 4}, {"b": 1}, 1.0)], {"a": 10}))


def test_make_system_validates():
    with pytest.raises(ValueError, match="too many reactants"):
        tr.make_system(list("abcde"), [({c: 1 for c in "abcde"}, {}, 1.0)],
                       {})


@pytest.mark.parametrize("values,replicas", [
    ({"eat1": [0.004, 0.006], "die": [0.5, 0.7, 0.9]}, 3),
    ({"reproduce": [1.5]}, 2),
])
def test_sweep_rates_match(values, replicas):
    js, _ = j_compile(J_MODELS["lv4"]())
    ts, _ = t_compile(T_MODELS["lv4"]())
    j = j_sweep(js, JSweep.make(values, replicas))
    t = t_sweep(ts, TSweep.make(values, replicas))
    assert j.dtype == t.dtype and (j == t).all()
    with pytest.raises(KeyError):
        t_sweep(ts, TSweep.make({"nope": [1.0]}, 1))
