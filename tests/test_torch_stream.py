"""Port parity: the counter-based RNG, lane keys and record sinks of
`repro_torch.core.stream` against `repro.core.stream`, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stream as jst
from repro.core.cwc.compile import compile_model as j_compile
from repro.core.cwc.models import MODELS as J_MODELS
from repro.core.gillespie import init_lanes as j_init_lanes
from repro_torch.core import stream as tst
from repro_torch.core.cwc.compile import compile_model as t_compile
from repro_torch.core.cwc.models import MODELS as T_MODELS
from repro_torch.core.gillespie import init_lanes as t_init_lanes

N_BLOCKS = 1 << 16


def _words(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


@pytest.fixture
def blocks(rng):
    return rng.integers(0, 2 ** 32, (4, N_BLOCKS), dtype=np.uint64).astype(
        np.uint32)


def test_threefry2x32_bitwise(blocks):
    j0, j1 = jax.jit(jst.threefry2x32)(*(jnp.asarray(b) for b in blocks))
    t0, t1 = tst.threefry2x32(*(_words(b) for b in blocks))
    assert (np.asarray(j0).astype(np.int64) == t0.numpy()).all()
    assert (np.asarray(j1).astype(np.int64) == t1.numpy()).all()


def test_counter_uniforms_bitwise(blocks):
    j1, j2 = jax.jit(jst.counter_uniforms)(*(jnp.asarray(b) for b in blocks))
    t1, t2 = tst.counter_uniforms(*(_words(b) for b in blocks))
    for j, t in ((j1, t1), (j2, t2)):
        assert t.dtype == torch.float32
        assert (np.asarray(j).view(np.int32) == t.numpy().view(np.int32)
                ).all()


def test_bits_to_uniform_range_ends():
    bits = np.array([0, 1 << 9, 0xFFFFFFFF, 0x80000000], np.uint32)
    j = np.asarray(jst.bits_to_uniform(jnp.asarray(bits)))
    t = tst.bits_to_uniform(_words(bits)).numpy()
    assert (j.view(np.int32) == t.view(np.int32)).all()
    assert t[0] == np.float32(tst.U_MIN) and t[2] < 1.0


@pytest.mark.parametrize("inc", [0, 1, 2, 255, 2 ** 32 - 1])
def test_ctr_add_low_word_wrap(inc, rng):
    """The carry into the high word, including lanes sitting just below
    the low-word wrap."""
    lo = np.concatenate([
        np.array([2 ** 32 - 1, 2 ** 32 - 2, 0, 1], np.uint32),
        rng.integers(2 ** 32 - 300, 2 ** 32, 500, dtype=np.uint64).astype(
            np.uint32),
        rng.integers(0, 2 ** 32, 500, dtype=np.uint64).astype(np.uint32)])
    hi = rng.integers(0, 2 ** 32, lo.shape, dtype=np.uint64).astype(np.uint32)
    hi[:2] = 2 ** 32 - 1  # the high word wraps too
    inc_a = np.full(lo.shape, inc, np.uint32)
    jl, jh = jst.ctr_add(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(inc_a))
    tl, th = tst.ctr_add(_words(lo), _words(hi), _words(inc_a))
    assert (np.asarray(jl).astype(np.int64) == tl.numpy()).all()
    assert (np.asarray(jh).astype(np.int64) == th.numpy()).all()


def test_word_conversion_round_trip(rng):
    w = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.int64)
    w[:3] = [0, 2 ** 31, 2 ** 32 - 1]
    bits = tst.from_words(torch.from_numpy(w))
    assert bits.dtype == torch.int32
    assert (bits.numpy() == w.astype(np.uint32).view(np.int32)).all()
    assert (tst.to_words(bits).numpy() == w).all()


@pytest.mark.parametrize("seed", [0, 1, 7, 123456789])
@pytest.mark.parametrize("n", [1, 4, 5, 300])
def test_init_lanes_keys_match_jax_split(seed, n):
    """The port's lane keys equal jax.random.split(PRNGKey(seed), n)
    through threefry2x32((seed >> 32, seed & 0xFFFFFFFF), (0, i))."""
    jsys, _ = j_compile(J_MODELS["lv2"]())
    tsys, _ = t_compile(T_MODELS["lv2"]())
    j = np.asarray(j_init_lanes(jsys, n, seed).key)
    t = t_init_lanes(tsys, n, seed, device="cpu").key
    assert t.shape == (n, 2) and t.dtype == torch.int32
    assert (j.view(np.int32) == t.numpy()).all()
    direct = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
    assert (direct.view(np.int32) == t.numpy()).all()


def test_stats_stream_drop_oldest_and_close(tmp_path):
    closed = []

    class Sink:
        def __init__(self):
            self.n = 0

        def __call__(self, rec):
            self.n += 1

        def close(self):
            closed.append(True)

    s = tst.StatsStream(maxlen=2)
    sink = Sink()
    s.attach(sink)
    for w in range(3):
        s.emit(tst.StatsRecord(t=w, window=w, mean=np.zeros(1),
                               var=np.zeros(1), ci90=np.zeros(1), n=1.0))
    assert [r.window for r in s.records()] == [1, 2]
    assert s.dropped == 1 and sink.n == 3
    s.close()
    assert closed == [True]


def test_csv_sink_matches_reference_file(tmp_path, rng):
    """Both packages' sinks write the same bytes for the same records."""
    names = ["a", "b"]
    recs = [dict(t=0.5 * (w + 1), window=w,
                 mean=rng.uniform(0, 100, 2).astype(np.float32),
                 var=rng.uniform(0, 10, 2).astype(np.float32),
                 ci90=rng.uniform(0, 1, 2).astype(np.float32), n=64.0)
            for w in range(4)]
    paths = []
    for mod in (jst, tst):
        p = tmp_path / f"{mod.__name__}.csv"
        sink = mod.CsvSink(str(p), names)
        for r in recs:
            sink(mod.StatsRecord(**r))
        sink.close()
        with pytest.raises(ValueError):
            sink(mod.StatsRecord(**recs[0]))
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()
