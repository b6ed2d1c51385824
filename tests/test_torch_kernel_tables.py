"""The exact window kernels' bound tables and the sparse kernel's
checkpointed a0, on the CPU.

The dense kernel recomputes, after reaction j fires, only the rows of a
per-reaction bit mask; the sparse kernel resumes its a0 fold at the
checkpoint below the lowest row of dep(j) and reads packed recipe rows.
These tables must be exactly the reference's dependency graph
(`repro.core.reactions.sparse_tables`), on every model and the
coefficient-5 system; the sparse kernel's route must follow the shape.

The sparse kernel's fold and scan (kernels/csrc/sparse_step.cuh) keep the
running sum at every 32nd row and search those checkpoints for the
threshold. A numpy emulation of that arithmetic, written here for the
test, must give `gillespie.resolve_carry`'s a0 and `direct_method`'s j
bit for bit: on random carries with zeros, negative entries and NaNs,
after updates of a dependency list's rows, and at thresholds equal to a
checkpoint value.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import reactions as jr
from repro.core.cwc.compile import compile_model as j_compile
from repro.core.cwc.models import MODELS as J_MODELS
from repro_torch.core import gillespie as tg
from repro_torch.core import reactions as tr
from repro_torch.core.cwc.compile import compile_model as t_compile
from repro_torch.core.cwc.models import MODELS as T_MODELS
from repro_torch.core.cwc.models import pentamer_system
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssa_step as tks

SYSTEMS = sorted(T_MODELS) + ["coef5"]
CK = tks.CK_ROWS


def systems(name):
    """(reference system, port system) for a model name or "coef5"."""
    if name == "coef5":
        ts = pentamer_system()
        return jr.ReactionSystem(**{f.name: getattr(ts, f.name)
                                    for f in dataclasses.fields(ts)}), ts
    return j_compile(J_MODELS[name]())[0], t_compile(T_MODELS[name]())[0]


def reference_deps(js):
    """dep(j) of every reaction as a set, from the reference's tables."""
    tb = jr.sparse_tables(js)
    r = js.n_reactions
    return [set(int(q) for q in row if q < r) for row in tb.dep_idx[:-1]]


@pytest.mark.parametrize("name", SYSTEMS)
def test_dependency_masks_match_reference_dep_lists(name):
    """Bit r of the dense kernel's mask j is set exactly when r is in the
    reference's dep(j); systems above the dense kernel's R cap raise."""
    js, ts = systems(name)
    tens = tg.system_tensors(ts, device="cpu", require_dense=False)[:3]
    r = ts.n_reactions
    if r > tks.MAX_R:
        with pytest.raises(ValueError,
                           match=f"R <= {tks.MAX_R} .*sparse=True"):
            tks.dense_dep_mask(*tens)
        return
    mask = tks.dense_dep_mask(*tens)
    assert mask.dtype == torch.int64 and mask.shape == (r,)
    bits = mask.numpy().view(np.uint64)
    got = [{q for q in range(r) if (int(bits[j]) >> q) & 1}
           for j in range(r)]
    assert got == reference_deps(js)


@pytest.mark.parametrize("name", SYSTEMS)
def test_sparse_dep_lo_matches_reference_dep_lists(name):
    """`bind_sparse_window`'s dep_lo is the lowest row of each reference
    dep(j), R where dep(j) is empty and for the pad row; the wrapper's
    own derivation from int_tab agrees."""
    js, ts = systems(name)
    r = ts.n_reactions
    want = [min(d) if d else r for d in reference_deps(js)] + [r]
    sp = tg.sparse_system_tensors(tr.sparse_tables(ts))
    tb = tops.bind_sparse_window(sp, torch.as_tensor(ts.rates))
    assert tb.dep_lo.dtype == torch.int32
    assert tb.dep_lo.tolist() == want
    assert tb.int_tab[:, tb.d:tb.d + tb.k].amin(dim=1).tolist() == want


# ------------------------------------------- the checkpointed a0 and scan


def padded(a):
    """The kernel's carry: a (B, R) with zero rows up to whole blocks."""
    b, r = a.shape
    return np.concatenate(
        [a, np.zeros((b, -(-r // CK) * CK - r), np.float32)], axis=1)


def fold_from(a, ck, lo):
    """The kernel's a0: resume the left-to-right float32 fold of the
    padded carry a at the checkpoint of the block holding row lo (one per
    lane), refreshing the later checkpoints ck (B, ceil(R/CK))."""
    b, n = a.shape
    a0 = np.empty(b, np.float32)
    for i in range(b):
        k0 = int(lo[i]) // CK
        acc = ck[i, k0]
        for k in range(k0, n // CK):
            ck[i, k] = acc
            for q in range(k * CK, (k + 1) * CK):
                acc = np.float32(acc + a[i, q])
        a0[i] = acc
    return a0


def scan(a, ck, thresh, r):
    """The kernel's j: on a lane whose rows are all >= 0, the count of
    checkpoints k >= 1 below thresh picks the block, and the count of its
    running sums below thresh the row in it (none reaching thresh: 0); on
    any other lane the first of the running sums from row 0 that reaches
    thresh (0 when none)."""
    b, _ = a.shape
    j = np.zeros(b, np.int64)
    for i in range(b):
        if (a[i, :r] >= 0).all():
            kl = int((ck[i, 1:] < thresh[i]).sum())
            cum, below = ck[i, kl], 0
            for q in range(kl * CK, (kl + 1) * CK):
                cum = np.float32(cum + a[i, q])
                below += int(cum < thresh[i])
            j[i] = kl * CK + below if below < CK else 0
            continue
        cum = np.float32(0.0)
        for q in range(r):
            cum = np.float32(cum + a[i, q])
            if cum >= thresh[i]:
                j[i] = q
                break
    return j


def twin_resolve(a, u2):
    """resolve_carry's a0 and direct_method's j for carries a (B, R)."""
    at = torch.from_numpy(a)
    _, a0, _ = tg.resolve_carry(at)
    zero = torch.zeros_like(a0)
    _, j = tg.direct_method(at, a0, zero, torch.full_like(a0, 0.5),
                            torch.from_numpy(u2))
    return a0.numpy(), j.numpy()


def random_carry(rng, b, r):
    """Propensity-like carries: integers times rates, a third of them
    zero."""
    a = (rng.integers(0, 50, (b, r)) * rng.uniform(0.001, 3.0, (b, r)))
    a[rng.uniform(size=(b, r)) < 0.33] = 0.0
    return a.astype(np.float32)


def assert_bits(x, y, what):
    assert (np.asarray(x, np.float32).view(np.int32)
            == np.asarray(y, np.float32).view(np.int32)).all(), what


@pytest.mark.parametrize("r", [6, 56, 97, 560])
def test_checkpointed_fold_and_scan_match_twin(r):
    """Random carries (zeros included), random u2: the emulation's a0 and
    j equal resolve_carry's and direct_method's, then again after each of
    several updates of a random dependency list's rows, the fold resumed
    below its lowest row."""
    rng = np.random.default_rng(r)
    b = 48
    a = padded(random_carry(rng, b, r))
    ck = np.zeros((b, -(-r // CK)), np.float32)
    lo = np.zeros(b, np.int64)
    for _ in range(6):
        u2 = rng.uniform(1e-6, 1.0, b).astype(np.float32)
        a0 = fold_from(a, ck, lo)
        a0_t, j_t = twin_resolve(a[:, :r].copy(), u2)
        assert_bits(a0, a0_t, "a0")
        thresh = (u2 * a0).astype(np.float32)
        assert (scan(a, ck, thresh, r) == j_t).all()
        # j fires: its dependency rows change, the next fold resumes
        # below the lowest of them
        for i in range(b):
            rows = rng.choice(r, size=min(r, 4), replace=False)
            a[i, rows] = random_carry(rng, 1, rows.size)[0]
            lo[i] = rows.min()


def test_checkpointed_scan_at_thresholds_equal_to_checkpoints():
    """u2 chosen so that u2 * a0 rounds to a checkpoint's value exactly:
    the row that completes the checkpoint, or an earlier one, is the
    twin's j; so is it where the checkpoint's block adds zeros."""
    rng = np.random.default_rng(1)
    b, r = 64, 200
    a = random_carry(rng, b, r)
    a[::4, 60:70] = 0.0  # runs of zeros across a checkpoint (row 64)
    a = padded(a)
    ck = np.zeros((b, -(-r // CK)), np.float32)
    a0 = fold_from(a, ck, np.zeros(b, np.int64))
    hits = 0
    u2 = np.empty(b, np.float32)
    for i in range(b):
        target = ck[i, 1 + i % (ck.shape[1] - 1)]
        u = np.float32(target / a0[i])
        for _ in range(8):  # step u until u * a0 rounds to the target
            p = np.float32(u * a0[i])
            if p == target:
                hits += 1
                break
            u = np.nextafter(u, np.float32(np.inf if p < target
                                           else -np.inf))
        u2[i] = u
    assert hits >= b // 2
    a0_t, j_t = twin_resolve(a[:, :r].copy(), u2)
    assert_bits(a0, a0_t, "a0")
    assert (scan(a, ck, (u2 * a0).astype(np.float32), r) == j_t).all()


@pytest.mark.parametrize("bad", ["negative", "nan", "negative_zero"])
def test_checkpointed_scan_off_the_monotone_premise(bad):
    """Lanes holding a negative entry or a NaN scan from row 0 and still
    give the twin's j (a checkpoint search would skip rows whose running
    sum reached the threshold before the negative entry pulled it back);
    -0.0 entries keep the premise and the checkpoint search."""
    rng = np.random.default_rng(2)
    b, r = 64, 120
    a = random_carry(rng, b, r)
    a[:, 10] = np.float32(40.0)
    if bad == "negative":
        a[:, 50] = -a[:, :50].sum(axis=1, dtype=np.float32) * np.float32(0.9)
    elif bad == "nan":
        a[::2, 70] = np.float32(np.nan)
    else:
        a[:, 20:40] = np.float32(-0.0)
    twin_a = a.copy()
    a = padded(a)
    ck = np.zeros((b, -(-r // CK)), np.float32)
    a0 = fold_from(a, ck, np.zeros(b, np.int64))
    u2 = rng.uniform(0.01, 1.0, b).astype(np.float32)
    a0_t, j_t = twin_resolve(twin_a, u2)
    assert_bits(a0, a0_t, "a0")
    thresh = (u2 * a0).astype(np.float32)
    j = scan(a, ck, thresh, r)
    assert (j == j_t).all()
    if bad == "negative":
        # the premise matters here: a monotone search would go wrong
        wrong = scan(np.abs(a), ck, thresh, r)
        assert (wrong != j_t).any()


@pytest.mark.parametrize("name,per_lane", [("ring8", False), ("ring8", True),
                                           ("ecoli", False), ("coef5", False),
                                           ("lattice8x8", True)])
def test_sparse_recipe_layout(name, per_lane):
    """The sparse kernel's packed tables hold exactly the twin's: each
    reaction's packed slots, and each recipe row's delta pairs, dep rows,
    their rates (shared rates) and their slots."""
    _, ts = systems(name)
    r, s = ts.n_reactions, ts.n_species
    rates = (np.tile(ts.rates, (3, 1)) * np.arange(1, 4)[:, None]
             if per_lane else ts.rates).astype(np.float32)
    sp = tg.sparse_system_tensors(tr.sparse_tables(ts))
    tb = tops.bind_sparse_window(sp, torch.as_tensor(rates))
    assert tb.packed is None  # only the card's tables are packed
    slot_tab, recipe = tks.sparse_recipe(
        tb.idx_pad, tb.coef_pad, tb.int_tab, tb.flt_tab, d=tb.d, k=tb.k,
        packed_rates=tb.packed_rates)
    idx, coef = sp[0].numpy(), sp[1].numpy()
    slots = slot_tab.numpy()
    assert ((slots >> 24) == coef).all()
    assert ((slots & 0xFFFFFF) == np.where(coef > 0, idx, 0)).all()
    rec = recipe.numpy()
    dp = -(-2 * tb.d // 4) * 4
    assert rec.shape == (r + 1, dp + 8 * tb.k)
    tables = tr.sparse_tables(ts)
    for j in range(r + 1):
        pairs = rec[j, :dp].reshape(-1, 2)
        assert (pairs[:tb.d, 0] == tables.delta_idx[j]).all()
        assert (pairs[:tb.d, 1].view(np.float32) == tables.delta_val[j]).all()
        assert (pairs[tb.d:, 0] == s).all()
        dep = rec[j, dp:].reshape(tb.k, 8)
        assert (dep[:, 0] == tables.dep_idx[j]).all()
        want_rate = (np.append(ts.rates, 0)[tables.dep_idx[j]]
                     if not per_lane else np.zeros(tb.k))
        assert (dep[:, 1].view(np.float32) == want_rate.astype(np.float32)
                ).all()
        assert (dep[:, 2:4] == 0).all()
        assert (dep[:, 4:] == slots[tables.dep_idx[j]]).all()


def test_sparse_window_route_follows_the_shape():
    """The sparse kernel keeps the carry on chip while 32 lanes' regions
    fit one block (R up to 1,728; 96 lanes a block at ring80's R = 560)
    and in HBM above, 128 lanes a block; a region's float4 words are an
    odd count, padded rows included."""
    assert tks.sparse_window_route(560) == ("shared", 96)
    assert tks.sparse_lane_rows(560) == 596  # 20 checkpoints, 576 rows
    assert tks.sparse_window_route(56) == ("shared", 128)
    assert tks.sparse_window_route(1728) == ("shared", 32)
    assert tks.sparse_window_route(1729) == ("hbm", 128)
    assert tks.sparse_window_route(1792) == ("hbm", 128)  # ring256
    for r in (6, 56, 97, 560, 1728, 1792):
        rows = tks.sparse_lane_rows(r)
        assert rows % 4 == 0 and rows // 4 % 2 == 1
        assert rows >= (-(-r // CK) + 3) // 4 * 4 + -(-r // CK) * CK
