"""The tau kernels' order of work, emulated on the CPU.

The sparse tau kernel runs each lane on the 32 threads of a warp: Match
rows, Cao species and counter blocks are dealt round the warp, tau_c and
max a_j are butterfly minima and maxima, dx is an atomic sum of reaction
rows' terms, and the exact sub-step counts the a0 fold's checkpoints
below the threshold before refolding one block. Both tau kernels skip
the Cao bound where min(horizon - t, LAM_MAX / max a_j) * a0 is below the
fallback (kernels/csrc/tau_step.cuh). None of that runs here, so a numpy
emulation of that arithmetic, written for these tests, takes one step
of random lv8, ecoli, ring8 and ring80 pools and must give
`core.tau_leap.tau_step_core`'s pool bit for bit; each order also against
the order the twin uses, and the gate never stops a lane the twin leaps.
The Poisson loop of the kernels (ssa_common.cuh), which stops early and
divides by a table of reciprocals, must count as `poisson_from_uniform`
does, negative means included, and its quotient must be IEEE division's
for every float32 significand; the sparse tau kernel's lanes a block
follow the shape.
"""
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import tau_leap as tt
from repro_torch.core.cwc.compile import cell_ring_model, compile_model
from repro_torch.core.cwc.models import MODELS
from repro_torch.core.gillespie import direct_method, init_lanes
from repro_torch.core.mathf import exp_f32
from repro_torch.core.reactions import propensities
from repro_torch.core.stream import counter_uniforms, ctr_add, to_words
from repro_torch.kernels import ssa_step as tks

F32 = np.float32
FLOOR = F32(1e-30)
CK = tks.CK_ROWS
WARP = 32


def system(name):
    if name == "ring256":
        return compile_model(cell_ring_model(256))[0]
    return compile_model(MODELS[name]())[0]


def warp_reduce(values, op, start):
    """A warp's reduction as the kernel runs it: thread m folds the
    values m, m + 32, ... with `op` from `start`, then five butterfly
    rounds (xor 16, 8, 4, 2, 1). Returns every thread's result."""
    part = np.full(WARP, start, F32)
    for i, v in enumerate(np.asarray(values, F32)):
        part[i % WARP] = op(part[i % WARP], v)
    for o in (16, 8, 4, 2, 1):
        part = op(part, part[np.arange(WARP) ^ o])
    return part


def warp_min(values):
    """tau_c: the butterfly minimum, the same bits on every thread (no
    term is +-0 or NaN)."""
    part = warp_reduce(values, np.fmin, F32(np.inf))
    assert (part.view(np.int32) == part[0].view(np.int32)).all()
    return part[0]


def warp_max(values):
    """max a_j as the kernel reads it, max(butterfly maximum, 1e-30):
    threads may hold +0 or -0 before the clamp, the same value after."""
    part = np.maximum(warp_reduce(values, np.fmax, F32(0)), FLOOR)
    assert (part.view(np.int32) == part[0].view(np.int32)).all()
    return part[0]


def cao_terms(x, a, tb, eps):
    """min(r1_i, r2_i) of the consumed species of one lane, as
    tau_step.cuh computes each: mu and sig2 left to right over the
    nonzeros of column i, g_i skipping zero rows; a species whose |mu| and
    sig2 are both not > 0 has two +inf terms and is skipped."""
    col_j, col_v = tb.col_j.numpy(), tb.col_v.numpy()
    gi, rmask = tb.gi.numpy(), tb.rmask.numpy()
    r = a.shape[0]
    out = []
    for i in range(x.shape[0]):
        if not rmask[i] > 0:
            continue
        mu = sig2 = F32(0)
        for j, v in zip(col_j[i], col_v[i]):
            if j >= r:
                break
            mu = F32(mu + F32(a[j] * v))
            sig2 = F32(sig2 + F32(a[j] * F32(v * v)))
        amu = abs(mu)
        if not amu > 0 and not sig2 > 0:
            continue
        g = gi[0, i]
        for k in range(1, gi.shape[0]):
            if gi[k, i] != 0:
                g = F32(g + F32(gi[k, i] / max(F32(x[i] - F32(k)), F32(1))))
        bnd = max(F32(F32(F32(eps) * x[i]) / g), F32(1))
        r1 = F32(bnd / max(amu, FLOOR)) if amu > 0 else F32(np.inf)
        r2 = F32(F32(bnd * bnd) / max(sig2, FLOOR)) if sig2 > 0 \
            else F32(np.inf)
        out.append(np.fmin(r1, r2))
    return np.asarray(out, F32)


def fold_with_checkpoints(a):
    """a0 as the left-to-right float32 fold of one lane's propensities,
    with the running sum before every block of CK rows."""
    acc, ck = F32(0), []
    for q, v in enumerate(a):
        if q % CK == 0:
            ck.append(acc)
        acc = F32(acc + v)
    return acc, np.asarray(ck, F32)


def checkpoint_scan(a, ck, thresh):
    """The exact sub-step's j as sparse_step.cuh finds it: where every
    row is >= 0, count the checkpoints k >= 1 below thresh, then the
    running sums below it in the next block (the pad rows past R repeat
    a0); elsewhere the first running sum from row 0 that reaches it (0
    when none)."""
    r = a.shape[0]
    if (a >= 0).all():
        kl = int((ck[1:] < thresh).sum())
        cum, below = ck[kl], 0
        for q in range(kl * CK, (kl + 1) * CK):
            cum = F32(cum + (a[q] if q < r else F32(0)))
            below += int(cum < thresh)
        return kl * CK + below if below < CK else 0
    cum = F32(0)
    for q in range(r):
        cum = F32(cum + a[q])
        if cum >= thresh:
            return q
    return 0


def rows_dx(kc, tb, s, rng):
    """dx (B, S) as the kernels add it: each reaction's row terms K_j *
    delta_ji, for K_j > 0, into dx in a random order (the warp's atomics
    finish in any order)."""
    row_idx, row_val = tb.row_idx.numpy(), tb.row_val.numpy()
    b, r = kc.shape
    dx = np.zeros((b, s + 1), F32)
    for lane in range(b):
        js = np.nonzero(kc[lane] > 0)[0]
        sp = row_idx[js].reshape(-1)
        val = (kc[lane, js, None] * row_val[js]).astype(F32).reshape(-1)
        order = rng.permutation(sp.size)
        np.add.at(dx[lane], sp[order], val[order])
    return dx[:, :s]


def kernel_step(pool, tb, rates, horizon, eps, fb, rng):
    """One tau-leap iteration of every lane in the kernels' order of
    work; returns what `tau_step_core` returns (numpy) and, per lane,
    whether the gate skipped the Cao bound and whether tau_c came from
    the warp tree equal to the twin's species-order minimum."""
    x, t = pool.x.numpy(), pool.t.numpy()
    dead = pool.dead.numpy()
    b, s = x.shape
    r = tb.idx.shape[0]
    n_pairs = (r + 1) // 2
    h = F32(horizon)
    a = propensities(pool.x, tb.idx, tb.coef, rates, tb.max_c).numpy()
    active = (t < h) & ~dead
    a0 = np.zeros(b, F32)
    cks = []
    for lane in range(b):
        a0[lane], ck = fold_with_checkpoints(a[lane])
        cks.append(ck)
    now_dead = a0 <= 0
    do_leap = np.zeros(b, bool)
    gated = np.zeros(b, bool)
    tau_l = np.zeros(b, F32)
    for lane in range(b):
        if not active[lane] or now_dead[lane]:
            continue
        a_max = warp_max(a[lane])
        left = F32(h - t[lane])
        cap = F32(F32(tt.LAM_MAX) / a_max)
        if not F32(min(left, cap) * a0[lane]) >= fb[lane]:
            gated[lane] = True
            continue
        terms = cao_terms(x[lane], a[lane], tb, eps)
        tau_c = warp_min(terms)
        assert tau_c.view(np.int32) == np.fmin.reduce(
            terms, initial=F32(np.inf)).view(np.int32)
        tau_l[lane] = min(min(tau_c, left), cap)
        do_leap[lane] = F32(tau_l[lane] * a0[lane]) >= fb[lane]

    k = to_words(pool.key)
    lo, hi = to_words(pool.ctr), to_words(pool.ctr_hi)

    def attempt(mask, off, tau):
        u = tt._uniform_slab(k[:, 0], k[:, 1], lo, hi, off, r)
        lam = np.where(mask[:, None], a * tau[:, None], F32(0)).astype(F32)
        kc = tt.poisson_from_uniform(u, torch.from_numpy(lam)).numpy()
        x_new = (x + rows_dx(kc, tb, s, rng)).astype(F32)
        return (x_new >= 0).all(axis=1), x_new

    ok1, x1 = attempt(do_leap, 0, tau_l)
    tau_h = (F32(0.5) * tau_l).astype(F32)
    ok2, x2 = attempt(do_leap & ~ok1, n_pairs, tau_h)
    leap1, leap2 = do_leap & ok1, do_leap & ~ok1 & ok2
    leaped = leap1 | leap2

    exact = active & ~leaped
    e_off = torch.from_numpy(np.where(do_leap & ~leaped, 2 * n_pairs, 0))
    u1, u2 = counter_uniforms(k[:, 0], k[:, 1], *ctr_add(lo, hi, e_off))
    t_next, _ = direct_method(torch.from_numpy(a), torch.from_numpy(a0),
                              pool.t, u1, u2)
    t_next, u2 = t_next.numpy(), u2.numpy()
    fire = exact & ~now_dead & (t_next <= h)
    x_new = np.where(leap1[:, None], x1, np.where(leap2[:, None], x2, x))
    row_idx, row_val = tb.row_idx.numpy(), tb.row_val.numpy()
    for lane in np.nonzero(fire)[0]:
        j = checkpoint_scan(a[lane], cks[lane], F32(u2[lane] * a0[lane]))
        for sp, v in zip(row_idx[j], row_val[j]):
            if sp < s:
                x_new[lane, sp] = F32(x_new[lane, sp] + v)
    t_new = np.where(leap1, np.minimum(F32(t + tau_l), h),
                     np.where(leap2, np.minimum(F32(t + tau_h), h),
                              np.where(fire, t_next,
                                       np.where(exact, h, t)))).astype(F32)
    dead_new = dead | (active & now_dead)
    used = (np.where(do_leap, np.where(ok1, n_pairs, 2 * n_pairs), 0)
            + exact.astype(np.int64))
    lo_n, hi_n = ctr_add(lo, hi, torch.from_numpy(used))
    steps = pool.steps.numpy() + (leaped | fire)
    leaps = pool.leaps.numpy() + leaped
    return ((x_new, t_new, dead_new, lo_n.numpy(), hi_n.numpy(), steps,
             leaps), gated)


def twin_step(pool, tb, rates, horizon, eps, fb):
    k = to_words(pool.key)
    out = tt.tau_step_core(
        pool.x, pool.t, pool.dead, k[:, 0], k[:, 1], to_words(pool.ctr),
        to_words(pool.ctr_hi), pool.steps, pool.leaps, tb, rates,
        torch.tensor(np.float32(horizon)), eps=eps,
        fallback=torch.from_numpy(fb))
    return tuple(o.numpy() for o in out)


def assert_same(got, want):
    names = ("x", "t", "dead", "ctr", "ctr_hi", "steps", "leaps")
    for n, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        assert g.shape == w.shape and (g == w).all(), n


def random_pool(ts, b, seed, horizon, rng, *, t_near=None, scale=1.0):
    """A pool of `ts` with random populations (zeros included, up to
    scale * 2^12) and clocks; `t_near`: every clock just below it."""
    pool = init_lanes(ts, b, seed)
    x = rng.integers(0, int(4096 * scale) + 1, (b, ts.n_species))
    x[rng.uniform(size=x.shape) < 0.2] = 0
    t = (rng.uniform(0, 0.9, b) * horizon if t_near is None
         else np.nextafter(np.float32(t_near), np.float32(0))
         - rng.integers(0, 4, b) * np.float32(1e-6))
    return pool._replace(x=torch.from_numpy(x.astype(np.float32)),
                         t=torch.from_numpy(np.asarray(t, np.float32)))


def run_case(name, *, seed, b=64, rates="shared", fb=10.0, horizon=0.5,
             t_near=None, scale=1.0, steps=3, sparse=True):
    ts = system(name)
    rng = np.random.default_rng(seed)
    tb = tt.tau_tables(ts, sparse=sparse)
    r = ts.n_reactions
    rt = ts.rates.astype(np.float32)
    if rates != "shared":
        rt = (rt[None] * rng.uniform(0.5, 1.5, (b, r))).astype(np.float32)
        if rates == "negative":
            rt[:, rng.integers(0, r)] *= -1
    rates_t = torch.from_numpy(rt)
    fbs = np.full(b, np.float32(fb))
    if fb != np.inf:
        fbs[::4] = np.inf  # no_leap lanes
    pool = random_pool(ts, b, seed, horizon, rng, t_near=t_near, scale=scale)
    gated = twin_leaps = 0
    for _ in range(steps):
        got, gate = kernel_step(pool, tb, rates_t, horizon, 0.03, fbs, rng)
        want = twin_step(pool, tb, rates_t, horizon, 0.03, fbs)
        assert_same(got, want)
        leaped = want[6] > pool.leaps.numpy()
        assert not (gate & leaped).any()  # the gate stops no leaping lane
        gated += int(gate.sum())
        twin_leaps += int(leaped.sum())
        x, t, dead, lo, hi, st, lp = want
        pool = pool._replace(
            x=torch.from_numpy(x), t=torch.from_numpy(t),
            dead=torch.from_numpy(dead),
            ctr=torch.from_numpy(((lo + 2 ** 31) % 2 ** 32 - 2 ** 31)
                                 .astype(np.int32)),
            ctr_hi=torch.from_numpy(((hi + 2 ** 31) % 2 ** 32 - 2 ** 31)
                                    .astype(np.int32)),
            steps=torch.from_numpy(st), leaps=torch.from_numpy(lp))
    return gated, twin_leaps


@pytest.mark.parametrize("name,rates", [("lv8", "shared"), ("lv8", "sweep"),
                                        ("ecoli", "shared"),
                                        ("ring8", "sweep"),
                                        ("ring80", "shared")])
def test_warp_order_step_matches_twin(name, rates):
    """Random pools, several steps: the butterfly tau_c and max a_j, dx
    by reaction rows in a random order, the checkpointed scan and the
    gate give tau_step_core's pool bit for bit; lanes both leap and take
    exact steps."""
    gated, leaps = run_case(name, seed=hash(name) % 1000 + len(rates),
                            rates=rates, fb=3.0 if name == "ring8" else 10.0)
    assert leaps > 0


@pytest.mark.parametrize("name", ["lv8", "ring8"])
def test_warp_order_step_with_negative_rates(name):
    """A negative rate in a sweep: negative propensities, a0's running
    sums no longer monotone (the scan from row 0) and negative Poisson
    means in leaps."""
    run_case(name, seed=5, rates="negative", fb=3.0)


@pytest.mark.parametrize("case", ["near_horizon", "large_a", "no_leap"])
def test_cao_gate_never_skips_a_leap(case):
    """The gate m * a0 < fallback, m = min(horizon - t, LAM_MAX /
    max(a_max, 1e-30)), skips the Cao bound on lanes the twin does not
    leap and on no other: clocks just below the horizon, populations
    large enough that LAM_MAX / a_max binds, and fallback = +inf on every
    lane."""
    if case == "near_horizon":
        gated, _ = run_case("lv8", seed=7, t_near=0.5, steps=2)
    elif case == "large_a":
        gated, _ = run_case("ring8", seed=8, scale=256.0, fb=3.0, steps=2)
    else:
        gated, leaps = run_case("ecoli", seed=9, fb=np.inf, steps=2)
        assert leaps == 0
    assert gated > 0


@pytest.mark.parametrize("name", ["lv8", "ecoli", "ring8", "ring80"])
def test_warp_tree_min_and_max_match_species_order(name):
    """On random states with populations from 0 to 2^20 (lv8, ecoli,
    ring8, ring80): no Cao term is NaN, and the butterfly minimum of the
    terms and maximum of the propensities equal the left-to-right ones
    bit for bit."""
    ts = system(name)
    rng = np.random.default_rng(11)
    tb = tt.tau_tables(ts, sparse=True)
    for scale in (1.0, 256.0):
        x = rng.integers(0, int(4096 * scale) + 1,
                         (16, ts.n_species)).astype(np.float32)
        x[rng.uniform(size=x.shape) < 0.3] = 0
        rt = (ts.rates[None] * rng.uniform(-0.5, 1.5, (16, ts.n_reactions))
              ).astype(np.float32)
        a = propensities(torch.from_numpy(x), tb.idx, tb.coef,
                         torch.from_numpy(rt), tb.max_c).numpy()
        for lane in range(16):
            terms = cao_terms(x[lane], a[lane], tb, 0.03)
            assert not np.isnan(terms).any()
            got = warp_min(terms)
            want = np.minimum.reduce(terms, initial=F32(np.inf))
            assert got.view(np.int32) == want.view(np.int32)
            want = np.maximum(a[lane].max(), FLOOR)  # the twin's clamp
            assert warp_max(a[lane]).view(np.int32) == want.view(np.int32)


@pytest.mark.parametrize("name", ["ring8", "ring80", "lattice8x8"])
def test_rows_dx_matches_column_walk(name):
    """dx from reaction rows' terms added in random orders equals the
    twin's left-to-right column walk, bit for bit (integer sums below
    2^24), zeros included."""
    ts = system(name)
    rng = np.random.default_rng(12)
    tb = tt.tau_tables(ts, sparse=True)
    kc = rng.integers(0, 65, (32, ts.n_reactions)).astype(np.float32)
    kc[rng.uniform(size=kc.shape) < 0.5] = 0
    want = tt.column_sums(torch.from_numpy(kc), tb.col_j, tb.col_v).numpy()
    for _ in range(3):
        got = rows_dx(kc, tb, ts.n_species, rng)
        assert (got.view(np.int32) == want.view(np.int32)).all()


def rn32(x: Fraction) -> F32:
    """The float32 nearest to the rational x, ties to even."""
    f = F32(float(x))
    cands = (np.nextafter(f, F32(-np.inf)), f, np.nextafter(f, F32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(F32(c).view(np.uint32)) & 1))


def quotient_tables():
    """ssa_common.cuh's kQuotHi and kQuotLo, as float32 arrays."""
    src = (Path(tks.__file__).parent / "csrc" / "ssa_common.cuh").read_text()
    out = []
    for name in ("kQuotHi", "kQuotLo"):
        body = re.search(name + r"\[65\] = \{([^}]*)\}", src).group(1)
        out.append(np.array([float.fromhex(v.strip().rstrip("f"))
                             if "x" in v else float(v.strip().rstrip("f"))
                             for v in body.split(",")], F32))
    return out


QHI, QLO = quotient_tables()


def kernel_quotient(lam, i):
    """ssa_common.cuh's quotient(lam, i): fma(lam, hi, RN(lam lo)), each
    rounding done exactly."""
    x = Fraction(float(lam))
    t = rn32(x * Fraction(float(QLO[i])))
    return rn32(x * Fraction(float(QHI[i])) + Fraction(float(t)))


def kernel_poisson(u, lam):
    """The kernels' draw, one count (tau_step.cuh's add_counts and
    ssa_common.cuh's poisson_from_uniform): lam = +-0 gives 0 (exp(-0) = 1
    > u); else count a term while the cdf is below u, stopping at the
    first that reaches u unless lam < 0 (a negative sweep rate), whose
    terms alternate in sign; lam / i by the table."""
    lam = F32(lam)
    if lam == 0:
        return F32(0)
    pmf = F32(exp_f32(torch.tensor([-lam])).numpy()[0])
    cdf, k = pmf, F32(0)
    i = 1
    while True:
        if cdf < u:
            k = F32(k + 1)
        elif not lam < 0:
            break
        if i == tt.POISSON_KMAX:
            break
        assert lam < 0 or lam > F32(2.0 ** -25)  # never divides below
        pmf = F32(pmf * kernel_quotient(lam, i))
        cdf = F32(cdf + pmf)
        i += 1
    return k


def test_kernel_poisson_loop_matches_twin():
    """The kernels' early-stopping Poisson loop counts as
    `poisson_from_uniform` does: means in [0, LAM_MAX], zero, and
    negative means (a negative rate's propensity times tau), where
    stopping at the first term that reaches u would undercount; means of
    size 2^-25 and below, subnormal ones included, against the largest
    uniform."""
    rng = np.random.default_rng(13)
    u = rng.uniform(1e-6, 1, 400).astype(np.float32)
    u[-12:] = F32(1) - F32(2.0 ** -23)  # the largest uniform the bits give
    tiny = [2.0 ** -25, np.nextafter(F32(2.0 ** -25), F32(1)), 2.0 ** -60,
            1e-45, 2.0 ** -24, 1e-6]
    tiny += [-v for v in tiny]
    lam = np.concatenate([rng.uniform(0, 16, 200), np.zeros(20),
                          -rng.uniform(0, 4, 168), tiny]).astype(np.float32)
    want = tt.poisson_from_uniform(torch.from_numpy(u),
                                   torch.from_numpy(lam)).numpy()
    got = np.array([kernel_poisson(a, b) for a, b in zip(u, lam)], F32)
    assert (got.view(np.int32) == want.view(np.int32)).all()
    early = np.array([0 if l < 0 else k for k, l in zip(got, lam)])
    assert (early != want).any()  # the negative means need every term


def test_quotient_table_holds_the_reciprocals():
    """kQuotHi[i] = RN(1/i) and kQuotLo[i] = RN(1/i - kQuotHi[i]) for i =
    1..64; an even i's entries are its odd part's scaled by a power of two
    (so odd divisors decide the quotient), and lam kQuotLo[i] stays normal
    for every mean of size above 2^-25. exp_f32(-lam) rounds to 1 for
    0 < |lam| <= 2^-25, so such a mean counts no term."""
    assert QHI.shape == QLO.shape == (65,)
    for i in range(1, 65):
        hi = rn32(Fraction(1, i))
        assert QHI[i] == hi
        assert QLO[i] == rn32(Fraction(1, i) - Fraction(float(hi)))
        m, k = i, 0
        while m % 2 == 0:
            m, k = m // 2, k + 1
        assert QHI[i] == QHI[m] * F32(2.0 ** -k)
        assert QLO[i] == QLO[m] * F32(2.0 ** -k)
    lo = np.abs(QLO[QLO != 0])
    assert float(lo.min()) * 2.0 ** -25 > 2.0 ** -126
    edge = np.array([2.0 ** -25, 2.0 ** -40, 2.0 ** -100, 1e-45], F32)
    assert (exp_f32(torch.from_numpy(-edge)).numpy() == 1).all()
    assert (exp_f32(torch.from_numpy(edge)).numpy() == 1).all()
    above = np.nextafter(F32(2.0 ** -25), F32(1))
    assert exp_f32(torch.tensor([-above])).item() < 1


def round24(v, frac_pos):
    """Integers 2^45 <= v < 2^48, plus a fraction in [0, 1) that is > 0
    where frac_pos, rounded to 24 significant bits, ties to even: the
    rounded significand and its shift."""
    s = 21 + sum((v >= 1 << b).long() for b in (45, 46, 47))
    q = v >> s
    rem = v & ((1 << s) - 1)
    half = 1 << (s - 1)
    up = (rem > half) | ((rem == half) & (frac_pos | ((q & 1) == 1)))
    return q + up.long(), s


def normalized(m, e):
    big = (m >= 1 << 24).long()
    return m >> big, e + big


def significand(f):
    m, e = np.frexp(np.float64(f))
    return int(np.ldexp(m, 24)), int(e) - 24


def quotient_mismatches(i, big_l):
    """How many lam = L (2^23 <= L < 2^24: float32 significands, the scale
    being free) give a table quotient other than RN(L / i), both computed
    exactly in integers."""
    zh, eh = significand(QHI[i])
    zl, el = significand(QLO[i])
    pl = big_l * zl                      # lam * lo, exact, at scale 2^el
    mt, st = round24(pl.abs(), torch.zeros_like(big_l, dtype=torch.bool))
    t = pl.sign() * (mt << st)           # RN(lam * lo)
    d = eh - el
    t_hi = t >> d                        # at the scale of lam * hi
    mf, sf = round24(big_l * zh + t_hi, (t - (t_hi << d)) > 0)
    mf, ef = normalized(mf, sf + eh)
    num = big_l << 24                    # L / i = (q + r / i) 2^-24
    q = torch.div(num, i, rounding_mode="floor")
    shift = int(np.log2(i))
    mr, sr = round24(q << shift, (num - q * i) > 0)
    mr, er = normalized(mr, sr - 24 - shift)
    return int(((mf != mr) | (ef != er)).sum())


def test_quotient_is_ieee_division():
    """The table quotient equals IEEE division. For odd i < 64 and lam in
    [1, 2) (even i and other binades scale exactly): the sum the fma
    rounds is within lam (|hi + lo - 1/i| + 2^-24 |lo|) of lam / i, which
    i^2 (|hi + lo - 1/i| + 2^-24 |lo|) < 2^-26 keeps below ulp / (4 i);
    lam / i, a multiple of 2^-23 over an odd i, is at least ulp / (2 i)
    (below a power of two ulp / (4 i)) from every rounding boundary, so
    both round alike. Checked exactly per i, and on 2^16 random
    significands and both ends of the binade per odd i in exact integer
    arithmetic. Multiplying by the reciprocal alone would not do: it
    misses on i = 3 already."""
    for i in range(3, 64, 2):
        err = abs(Fraction(float(QHI[i])) + Fraction(float(QLO[i]))
                  - Fraction(1, i))
        slack = err + Fraction(abs(float(QLO[i]))) / 2 ** 24
        assert i * i * slack < Fraction(1, 2 ** 26), i
    rng = np.random.default_rng(17)
    for i in range(3, 64, 2):
        big_l = torch.from_numpy(np.concatenate([
            rng.integers(1 << 23, 1 << 24, 1 << 16),
            np.arange(1 << 23, (1 << 23) + 1024),
            np.arange((1 << 24) - 1024, 1 << 24)]).astype(np.int64))
        assert quotient_mismatches(i, big_l) == 0, i
    lam = np.float32(np.arange(1 << 23, (1 << 23) + 4096) * 2.0 ** -23)
    assert (lam * QHI[3] != lam / F32(3)).any()


def test_sparse_tau_route_follows_the_shape():
    """A warp per lane; a block holds as many lanes' regions (checkpoints,
    padded propensities, x, dx) as fit its shared memory, at most 16:
    ring80 16, lattice8x8 16, ring256 14; a lane that fits no block
    raises."""
    for name, lanes in (("ring80", 16), ("lattice8x8", 16), ("ring256", 14)):
        ts = system(name)
        s, r = ts.n_species, ts.n_reactions
        floats = tks.sparse_tau_lane_floats(s, r)
        assert floats % 4 == 0
        assert floats >= -(-r // CK) * CK + -(-r // CK) + 2 * s
        assert tks.sparse_tau_lanes_per_block(s, r) == lanes
        assert lanes * floats * 4 <= tks.SMEM_BLOCK_BYTES
    assert tks.sparse_tau_lane_floats(320, 560) == 1236  # 4.9 KB at ring80
    with pytest.raises(ValueError, match="do not fit"):
        tks.sparse_tau_lanes_per_block(20_000, 20_000)


@pytest.mark.parametrize("r", [560, 1792, 20_000, 60_000])
def test_sparse_tau_refuses_just_past_one_block(r):
    """At the largest S whose lane region fits one block the kernel runs
    one lane a block; one species more and the wrapper refuses the shape
    with a message naming S, R and the bytes, before any launch."""
    fits = [s for s in range(1, 40_000)
            if 4 * tks.sparse_tau_lane_floats(s, r) <= tks.SMEM_BLOCK_BYTES]
    if not fits:  # R alone overflows a block
        with pytest.raises(ValueError, match=f"S=1 species, R={r} "):
            tks.sparse_tau_lanes_per_block(1, r)
        return
    s = fits[-1]
    assert fits == list(range(1, s + 1))  # the region grows with S
    assert tks.sparse_tau_lanes_per_block(s, r) == 1
    assert tks.sparse_tau_lanes_per_block(s // 17, r) >= 1
    need = 4 * tks.sparse_tau_lane_floats(s + 1, r)
    with pytest.raises(ValueError, match=(
            f"S={s + 1} species, R={r} reactions: {need} bytes\\) do not "
            f"fit the {tks.SMEM_BLOCK_BYTES} bytes")):
        tks.sparse_tau_lanes_per_block(s + 1, r)
