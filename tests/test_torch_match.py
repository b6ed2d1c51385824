"""The Match kernel's shape logic and its twin at the reference's tiling.

On the CPU: the route and tile functions that pick how
`kernels/csrc/propensity.cu` runs (pure Python), a numpy emulation of
the kernel's walk over a tile's outputs, and the twin `propensity_plain`
bit for bit against the reference's Pallas `propensity_call` in
interpret mode at ring80 with more lanes than its LANE_BLK and more
reactions than its R_BLK, on counts and on negative and huge
populations. The kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cwc.compile import compile_model as j_compile
from repro.core.cwc.models import MODELS as J_MODELS
from repro.kernels import propensity as jkp
from repro_torch.core.cwc.compile import cell_ring_model, compile_model
from repro_torch.core.cwc.models import MODELS as T_MODELS
from repro_torch.core.reactions import MAX_REACTANTS
from repro_torch.kernels import ops as tops
from repro_torch.kernels import propensity as tkp
from repro_torch.kernels.ssa_step import SMEM_BLOCK_BYTES

THREADS = 256  # the kernel's block (propensity.cu, launch)


def shape_of(name):
    """(S, R) of a model, or of the table-only system of 70,000 species."""
    if name == "table70000":
        return 70_000, 300
    model = cell_ring_model(256) if name == "ring256" else T_MODELS[name]()
    system = compile_model(model)[0]
    return system.n_species, system.n_reactions


@pytest.mark.parametrize("name,route,tile", [
    ("lv8", "shared", 912), ("ring80", "shared", 16),
    ("ring256", "shared", 8), ("table70000", "global", 28)])
def test_match_route_and_tile(name, route, tile):
    """Each shape's route and tile; a shared tile plus the tables fits a
    block and fills MATCH_TILE_OUTPUTS unless shared memory stops it;
    "global" exactly where one lane's two rows and the tables do not
    fit."""
    s, r = shape_of(name)
    assert tkp.match_route(s, r) == route
    assert tkp.match_lanes_per_tile(s, r) == tile
    one_lane_fits = tkp.match_smem_bytes(s, r, 1) <= SMEM_BLOCK_BYTES
    assert (route == "shared") == one_lane_fits
    assert tile % 4 == 0
    assert tile * r >= tkp.MATCH_TILE_OUTPUTS or route == "shared"
    if route == "shared":
        assert tkp.match_smem_bytes(s, r, tile) <= SMEM_BLOCK_BYTES
        if tile * r < tkp.MATCH_TILE_OUTPUTS:  # shared memory stopped it
            assert (tkp.match_smem_bytes(s, r, tile + 4)
                    > SMEM_BLOCK_BYTES)
    assert tile * max(s, r) < tkp.MATCH_TILE_INDEX


@pytest.mark.parametrize("r,m", [(300, 4), (7, 4), (33, 6)])
def test_match_route_boundary(r, m):
    """Along S at fixed R: with at most MAX_REACTANTS slots a reaction,
    every S up to the last whose one lane fits takes "shared" with a
    tile that fits, and the next S takes "global"; raw tables of more
    slots take "global" at every S."""
    table = tkp.match_smem_bytes(1, r, 0)
    s_max = (SMEM_BLOCK_BYTES - table) // 32 * 4  # two rows of S floats
    assert tkp.match_smem_bytes(s_max, r, 1) <= SMEM_BLOCK_BYTES
    assert tkp.match_smem_bytes(s_max + 1, r, 1) > SMEM_BLOCK_BYTES
    shared = m <= MAX_REACTANTS
    for s in (1, 2, 3, 5, 8, 320, 1000, 7075, s_max - 1, s_max):
        tile = tkp.match_lanes_per_tile(s, r, m)
        assert tkp.match_route(s, r, m) == ("shared" if shared
                                            else "global")
        assert 1 <= tile and (tile < 4 or tile % 4 == 0)
        if shared:
            assert tkp.match_smem_bytes(s, r, tile) <= SMEM_BLOCK_BYTES
    if shared:
        assert tkp.match_lanes_per_tile(s_max, r, m) == 1
    assert tkp.match_route(s_max + 1, r, m) == "global"
    assert tkp.match_lanes_per_tile(s_max + 1, r, m) >= 1


def test_match_route_tables_too_large():
    """Tables alone above a block's shared memory: "global" at any S."""
    r = SMEM_BLOCK_BYTES // 20 + 1  # 16 bytes of slots + 4 of rate each
    assert tkp.match_smem_bytes(1, r, 0) > SMEM_BLOCK_BYTES
    assert tkp.match_route(1, r) == "global"
    assert tkp.match_route(1, r - 400) == "shared"


@pytest.mark.parametrize("b,r,tile,item_lanes", [
    (1001, 9, 912, 8), (300, 560, 16, 8), (7, 560, 16, 8),
    (133, 6, 1368, 8), (45, 300, 28, 4), (77, 33, 252, 8),
    (5, 1, 8192, 8), (3, 1025, 8, 8), (301, 560, 16, 4)])
def test_match_walk_covers_each_output_once(b, r, tile, item_lanes):
    """A numpy emulation of propensity.cu's walk: item i of a tile is
    reaction i % R over the item_lanes lanes of run i / R (8 on the
    shared route, 4 on the global one; fewer in the tile's last run);
    thread t of T takes items t, t + T, ..., with (run,
    reaction) advanced by 32-bit increments from one division per
    thread. Every output of every tile is written once, at its own
    (lane, reaction), and a warp's 32 threads take neighbouring
    reactions."""
    t = np.arange(THREADS)
    c0, dc = t // r, THREADS // r
    r0, dr = t - c0 * r, THREADS - dc * r
    seen = np.zeros(b * r, np.int64)
    for t0 in range(0, b, tile):
        lanes = min(tile, b - t0)
        n_items = -(-lanes // item_lanes) * r
        i, run, rr = t.copy(), c0.copy(), r0.copy()
        while (i < n_items).any():
            live = i < n_items
            assert (run[live] * r + rr[live] == i[live]).all()
            for j in range(item_lanes):
                lane = run * item_lanes + j
                ok = live & (lane < lanes)
                np.add.at(seen, (t0 + lane[ok]) * r + rr[ok], 1)
            warp_r = rr.reshape(-1, 32)[live.reshape(-1, 32).all(1)]
            assert ((np.diff(warp_r, axis=1) - 1) % r == 0).all()
            i, rr, run = i + THREADS, rr + dr, run + dc
            wrap = rr >= r
            rr[wrap] -= r
            run[wrap] += 1
    assert (seen == 1).all()


def populations(rng, b, s, kind):
    x = rng.integers(0, 300, (b, s)).astype(np.float32)
    if kind == "extreme":  # negatives, 2^24 and above (no inf: the
        u = rng.random((b, s))  # one-hot dot would give inf * 0 = NaN)
        x[u < 0.05] = -rng.integers(1, 6, int((u < 0.05).sum()))
        big = (u >= 0.05) & (u < 0.12)
        x[big] = rng.choice(np.float32([2**24, 2**24 + 2, 3e7, 1e30]),
                            int(big.sum()))
    return x


@pytest.mark.parametrize("kind", ["counts", "extreme"])
@pytest.mark.parametrize("per_lane", [False, True])
def test_propensity_plain_matches_reference_kernel_ring80(per_lane, kind,
                                                          rng):
    """ring80 (R = 560 > R_BLK) at B = 300 (> LANE_BLK), so the
    reference's Pallas kernel runs ragged tiles in both dimensions: the
    twin gives its bits, on counts and on negative and huge populations
    (the one-hot dot picks each exactly; 1e30 squared overflows)."""
    assert 300 > jkp.LANE_BLK and 560 > jkp.R_BLK
    js = j_compile(J_MODELS["ring80"]())[0]
    ts = compile_model(T_MODELS["ring80"]())[0]
    b = 300
    x = populations(rng, b, js.n_species, kind)
    rates = ((js.rates[None] * rng.uniform(0.5, 1.5, (b, js.n_reactions)))
             .astype(np.float32) if per_lane else js.rates)
    a_j = jkp.propensity_call(
        jnp.asarray(x), jnp.asarray(jkp.reactant_onehots(js)),
        jnp.asarray(js.reactant_coef.T, jnp.float32), jnp.asarray(rates),
        interpret=True)
    tens = tops.system_kernel_tensors(ts, device="cpu")
    a_t = tops.propensity(torch.from_numpy(x), tens, torch.from_numpy(rates))
    a_j = np.asarray(a_j)
    assert a_j.shape == (b, js.n_reactions)
    assert (a_j.view(np.int32) == a_t.numpy().view(np.int32)).all()
    if kind == "extreme":  # the populations reach every case they name
        assert np.isinf(a_j).any() and (a_j == 0).any()
