"""Port parity: the fused SSA window (`ssa_window_call`, its plain twin
and `window_chunk_loop`) against the reference's Pallas kernel run in
interpret mode and its jnp oracle — the six window outputs, the chunk
count and the truncation flag, bit for bit. The CUDA kernel itself is
held against the twin on the card by tests/test_torch_cuda.py and
chip_smoke.py."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gillespie as jg
from repro.core.cwc.compile import compile_model as j_compile
from repro.core.cwc.models import MODELS as J_MODELS
from repro.kernels import ops as jops
from repro.kernels.propensity import reactant_onehots
from repro.kernels.ref import ssa_window_ref
from repro.kernels.ssa_step import ssa_window_call as j_window_call
from repro_torch import interop
from repro_torch.core import gillespie as tg
from repro_torch.core.cwc.compile import compile_model as t_compile
from repro_torch.core.cwc.models import MODELS as T_MODELS
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssa_step as tks

SYSTEMS = ["lv2", "lv4", "lv8", "ecoli", "transport"]
HORIZON = {"lv2": 0.1, "lv4": 0.1, "lv8": 0.05, "ecoli": 10.0,
           "transport": 2.0}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a


def _port_pool(js, jp):
    return interop.from_reference(
        {f: getattr(js, f) for f in interop.SYSTEM_FIELDS},
        {f: np.asarray(getattr(jp, f)) for f in jg.LaneState._fields},
        device="cpu")


def _rates(js, b, rng, per_lane):
    if not per_lane:
        return js.rates
    return (js.rates[None] * rng.uniform(0.5, 1.5, (b, js.n_reactions))
            ).astype(np.float32)


@pytest.mark.parametrize("name", SYSTEMS)
@pytest.mark.parametrize("batch,n_steps,per_lane", [(8, 16, False),
                                                     (33, 64, True)])
def test_ssa_window_call_matches_reference_kernel(name, batch, n_steps,
                                                  per_lane, rng):
    js, _ = j_compile(J_MODELS[name]())
    jp = jg.init_lanes(js, batch, seed=batch + n_steps)
    ts, tp = _port_pool(js, jp)
    rates = _rates(js, batch, rng, per_lane)
    h = HORIZON[name]
    delta = jnp.asarray(js.delta, jnp.float32)
    jargs = (jp.x, jp.t, jp.dead.astype(jnp.int32), jp.key, jp.ctr,
             jp.ctr_hi)
    out_k = j_window_call(*jargs, jnp.asarray(reactant_onehots(js)),
                          jnp.asarray(js.reactant_coef.T, jnp.float32),
                          delta, jnp.asarray(rates), h, n_steps=n_steps,
                          interpret=True)
    out_r = ssa_window_ref(*jargs, jnp.asarray(js.reactant_idx),
                           jnp.asarray(js.reactant_coef), delta,
                           jnp.asarray(rates), h, n_steps=n_steps)
    idx, coef, dl, r = tg.system_tensors(ts, rates, device="cpu")
    before = tks.ssa_window_call.launches
    out_t = tks.ssa_window_call(tp.x, tp.t, tp.dead.to(torch.int32),
                                tp.key, tp.ctr, tp.ctr_hi, idx, coef, dl, r,
                                h, n_steps=n_steps)
    assert tks.ssa_window_call.launches == before  # CPU: the plain twin
    for k, ref, t, what in zip(out_k, out_r, out_t,
                               ("x", "t", "dead", "steps", "ctr", "ctr_hi")):
        assert (_bits(k) == _bits(ref)).all(), what
        assert (_bits(k) == _bits(t.numpy())).all(), what


@pytest.mark.parametrize("name", SYSTEMS)
def test_window_chunk_loop_matches_reference(name, rng):
    """Three windows through the fused window with sweep rates: pool
    state, the chunk count and the truncation flag equal the
    reference's device-side chunk loop (chunk_steps=32)."""
    js, _ = j_compile(J_MODELS[name]())
    jp = jg.init_lanes(js, 16, seed=4)
    ts, tp = _port_pool(js, jp)
    rates = _rates(js, 16, rng, True)
    jt = jg.system_tensors(js, rates)
    tt = tg.system_tensors(ts, rates, device="cpu")
    jloop = jax.jit(partial(jops.window_chunk_loop, chunk_steps=32,
                            max_chunks=64, interpret=True))
    chunks = []
    for w in range(1, 4):
        h = np.float32(HORIZON[name] * w)
        jo = jloop(jp, jt, h)
        to = tops.window_chunk_loop(tp, tt, h, chunk_steps=32, max_chunks=64)
        jp, tp = jo.state, to.state
        for f in ("x", "t", "ctr", "ctr_hi", "steps", "dead"):
            assert (_bits(getattr(jp, f))
                    == _bits(getattr(tp, f).numpy())).all(), f
        assert int(jo.n_chunks) == int(to.n_chunks)
        assert bool(jo.truncated) is bool(to.truncated) is False
        chunks.append(int(to.n_chunks))
    assert max(chunks) >= 1


def test_window_chunk_loop_truncation_matches_reference():
    """A budget too small for the window: both stop with live lanes,
    report the same chunk count, and hold the same partial state."""
    js, _ = j_compile(J_MODELS["lv2"]())
    jp = jg.init_lanes(js, 8, seed=2)
    ts, tp = _port_pool(js, jp)
    jo = jops.window_chunk_loop(jp, jg.system_tensors(js), 0.5,
                                chunk_steps=4, max_chunks=3, interpret=True)
    to = tops.window_chunk_loop(tp, tg.system_tensors(ts, device="cpu"), 0.5,
                                chunk_steps=4, max_chunks=3)
    assert bool(jo.truncated) and bool(to.truncated)
    assert int(jo.n_chunks) == int(to.n_chunks) == 3
    for f in ("x", "t", "ctr", "steps", "dead"):
        assert (_bits(getattr(jo.state, f))
                == _bits(getattr(to.state, f).numpy())).all(), f


def test_window_is_one_kernel_call(monkeypatch):
    """The fused window reaches ssa_window_call exactly once, with the
    whole budget chunk_steps * max_chunks."""
    calls = []
    real = tops.ssa_window_call

    def spy(*a, **kw):
        calls.append(kw["n_steps"])
        return real(*a, **kw)

    monkeypatch.setattr(tops, "ssa_window_call", spy)
    ts, _ = t_compile(T_MODELS["ecoli"]())
    pool = tg.init_lanes(ts, 8, 0, device="cpu")
    out = tops.window_chunk_loop(pool, tg.system_tensors(ts, device="cpu"),
                                 5.0, chunk_steps=16, max_chunks=8)
    assert calls == [128]
    assert not bool(out.truncated)


def test_ssa_window_call_rejects_other_devices():
    ts, _ = t_compile(T_MODELS["lv2"]())
    pool = tg.init_lanes(ts, 4, 0, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tks.ssa_window_call(pool.x, pool.t, pool.dead.to(torch.int32),
                            pool.key, pool.ctr, pool.ctr_hi,
                            *tg.system_tensors(ts, device="meta"), 0.1,
                            n_steps=4)
