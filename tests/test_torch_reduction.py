"""Port parity: blocked Welford statistics against the reference.

Observables are integer-valued, so while their sums stay below 2^24
the window mean is exact: bitwise equal to the reference's eager fold
(the form its engine runs). M2 sums squared deviations in torch's order,
not XLA's, so var and ci90 are held to an ulp bound: the inputs below
(I <= 4096 instances, up to 4 stat blocks) differ by at most 5 ulp
(var) and 3 ulp (ci90) under JAX 0.9.0 and torch 2.13 on the CPU, and
VAR_ULP / CI90_ULP leave margin above that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reduction as jr
from repro_torch.core import reduction as tr

VAR_ULP = 12
CI90_ULP = 8


def ulp(a, b) -> int:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def check_stats(js, ts):
    assert ulp(js.n, ts.n.numpy()) == 0
    assert ulp(js.mean, ts.mean.numpy()) == 0
    assert ulp(js.var, ts.var.numpy()) <= VAR_ULP
    assert ulp(js.ci90, ts.ci90.numpy()) <= CI90_ULP


@pytest.mark.parametrize("n_inst", [64, 1000, 4096])
@pytest.mark.parametrize("n_blocks", [1, 2, 4])
def test_blocked_stats(n_inst, n_blocks, rng):
    for _ in range(5):
        obs = rng.integers(0, 3000, (n_inst, 3)).astype(np.float32)
        check_stats(jr.blocked_stats(jnp.asarray(obs), n_blocks),
                    tr.blocked_stats(torch.from_numpy(obs), n_blocks))


@pytest.mark.parametrize("n_blocks", [1, 2, 4])
def test_grouped_stats(n_blocks, rng):
    """Per-sweep-point stats as the reference engine computes them (a
    jitted grouped fold, or block partials merged eagerly)."""
    for _ in range(5):
        obs = rng.integers(0, 3000, (256, 3)).astype(np.float32)
        g = np.repeat(np.arange(4, dtype=np.int32), 64)
        rng.shuffle(g)
        if n_blocks == 1:
            js = jax.jit(lambda o, g: jr.grouped_stats(o, g, 4))(
                jnp.asarray(obs), jnp.asarray(g))
            ts = tr.grouped_stats(torch.from_numpy(obs),
                                  torch.from_numpy(g), 4)
        else:
            js = jr.finalize(jr.merge_blocks(jax.jit(
                lambda o, g: jr.blocked_grouped_welford(o, g, 4, n_blocks))(
                    jnp.asarray(obs), jnp.asarray(g))))
            ts = tr.finalize(tr.merge_blocks(tr.blocked_grouped_welford(
                torch.from_numpy(obs), torch.from_numpy(g), 4, n_blocks)))
        assert ts.mean.shape == (4, 3)
        check_stats(js, ts)


def test_update_batch_mask_and_merge(rng):
    x = rng.integers(0, 100, (40, 2)).astype(np.float32)
    m = rng.random(40) < 0.6
    ja = jr.update_batch(jr.init_welford((2,)), jnp.asarray(x[:20]),
                         jnp.asarray(m[:20]))
    ja = jr.update_batch(ja, jnp.asarray(x[20:]), jnp.asarray(m[20:]))
    ta = tr.update_batch(tr.init_welford((2,)), torch.from_numpy(x[:20]),
                         torch.from_numpy(m[:20]))
    ta = tr.update_batch(ta, torch.from_numpy(x[20:]),
                         torch.from_numpy(m[20:]))
    assert ulp(ja.n, ta.n.numpy()) == 0
    assert ulp(ja.mean, ta.mean.numpy()) <= 1
    assert ulp(ja.m2, ta.m2.numpy()) <= VAR_ULP
    np.testing.assert_allclose(ta.mean.numpy(), x[m].mean(axis=0),
                               rtol=1e-6)


def test_empty_group_is_zero():
    obs = torch.ones((8, 2))
    st = tr.grouped_stats(obs, torch.zeros(8, dtype=torch.int32), 3)
    assert st.n[1:].eq(0).all() and st.mean[1:].eq(0).all()
    assert torch.isfinite(st.var).all() and torch.isfinite(st.ci90).all()
