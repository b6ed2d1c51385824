"""Port parity: the dense exact SSA (`ssa_step`, `advance_to`) against
the reference — pool state (x, t, ctr, ctr_hi, steps, dead) bit for bit
after several windows, with per-lane sweep rates."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gillespie as jg
from repro.core.cwc.compile import compile_model as j_compile
from repro.core.cwc.models import MODELS as J_MODELS
from repro_torch import interop
from repro_torch.core import gillespie as tg

SYSTEMS = ["lv2", "lv4", "lv8", "ecoli", "transport"]
HORIZONS = {"lv2": (0.05, 0.1, 0.15), "lv4": (0.05, 0.1, 0.15),
            "lv8": (0.05, 0.1, 0.15), "ecoli": (5.0, 10.0, 15.0),
            "transport": (1.0, 2.0, 3.0)}
POOL = ("x", "t", "ctr", "ctr_hi", "steps", "dead")


def assert_pool_bitwise(jpool, tpool):
    for f in POOL:
        a = np.asarray(getattr(jpool, f))
        b = getattr(tpool, f).numpy()
        if a.dtype in (np.float32, np.uint32):
            a = a.view(np.int32)
            b = b.view(np.int32)
        assert a.shape == b.shape and (a == b).all(), f


def sweep_rates(system, b, rng):
    return (system.rates[None] * rng.uniform(0.5, 1.5, (b, system.n_reactions))
            ).astype(np.float32)


def both_pools(name, b, seed):
    """The reference's system and pool, and the port's copies of the
    same state via interop."""
    js, _ = j_compile(J_MODELS[name]())
    jp = jg.init_lanes(js, b, seed)
    sysd = {f: getattr(js, f) for f in interop.SYSTEM_FIELDS}
    poold = {f: np.asarray(getattr(jp, f)) for f in jg.LaneState._fields}
    ts, tp = interop.from_reference(sysd, poold, device="cpu")
    return js, jp, ts, tp


@pytest.mark.parametrize("name", SYSTEMS)
def test_advance_to_pool_bitwise_after_windows(name, rng):
    js, jp, ts, tp = both_pools(name, 24, seed=5)
    assert_pool_bitwise(jp, tg.init_lanes(ts, 24, 5, device="cpu"))
    rates = sweep_rates(js, 24, rng)
    jt = jg.system_tensors(js, rates)
    tt = tg.system_tensors(ts, rates, device="cpu")
    adv = jax.jit(lambda p, h: jg.advance_to(p, jt, h))
    for h in HORIZONS[name]:
        jp = adv(jp, h)
        tp = tg.advance_to(tp, tt, h)
        assert_pool_bitwise(jp, tp)
    assert int(tp.steps.sum()) > 0


@pytest.mark.parametrize("name", ["lv2", "ecoli"])
def test_ssa_step_bitwise_near_counter_wrap(name, rng):
    """Single steps from a mid-run state whose draw counters sit just
    below the low-word wrap: the carry and every per-step output match."""
    js, jp, ts, tp = both_pools(name, 16, seed=3)
    lo = np.full(16, 2 ** 32 - 2, np.uint32)
    lo[::2] = rng.integers(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 50, (16, js.n_species)).astype(np.float32)
    x[0] = 0.0  # a lane that dies on its first step
    jp = jp._replace(x=jnp.asarray(x), ctr=jnp.asarray(lo),
                     ctr_hi=jnp.asarray(np.arange(16, dtype=np.uint32)))
    poold = {f: np.asarray(getattr(jp, f)) for f in jg.LaneState._fields}
    _, tp = interop.from_reference(
        {f: getattr(js, f) for f in interop.SYSTEM_FIELDS}, poold,
        device="cpu")
    rates = sweep_rates(js, 16, rng)
    jt = jg.system_tensors(js, rates)
    tt = tg.system_tensors(ts, rates, device="cpu")
    h = np.float32(HORIZONS[name][0])
    step = jax.jit(lambda p: jg.ssa_step(p, jt, jnp.float32(h)))
    for _ in range(5):
        jp = step(jp)
        tp = tg.ssa_step(tp, tt, torch.tensor(h))
        assert_pool_bitwise(jp, tp)
    assert bool(tp.dead[0])


def test_advance_to_max_steps_bound(rng):
    js, jp, ts, tp = both_pools("lv2", 16, seed=1)
    jt = jg.system_tensors(js)
    tt = tg.system_tensors(ts, device="cpu")
    jp = jax.jit(lambda p: jg.advance_to(p, jt, 0.2, max_steps=7))(jp)
    tp = tg.advance_to(tp, tt, 0.2, max_steps=7)
    assert_pool_bitwise(jp, tp)
    assert int(tp.steps.max()) <= 7


def test_interop_round_trip():
    js, jp, ts, tp = both_pools("ecoli", 8, seed=2)
    sysd, poold = interop.to_reference_arrays(ts, tp)
    for f in interop.SYSTEM_FIELDS:
        a, b = getattr(js, f), sysd[f]
        assert (np.asarray(a) == np.asarray(b)).all() if not isinstance(
            a, tuple) else a == b
    for f in jg.LaneState._fields:
        a = np.asarray(getattr(jp, f))
        assert poold[f].dtype == a.dtype and (poold[f] == a).all(), f
