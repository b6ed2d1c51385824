"""The plain reference: its pieces against the port's at small sizes on
the CPU, and against itself."""
import numpy as np
import pytest
import torch

from portbench.harness.cell import find, merged
from portbench.reference import fmath, rng
from portbench.reference.lanes import bf16, follow
from portbench.reference.reductions.ensemble import fold
from portbench.tiny import SPARSE, sizes

SEED = 2 ** 31 + 977


@pytest.mark.parametrize("seed", [0, 7, SEED, 2 ** 40 + 3])
def test_lane_keys_match_the_port(seed):
    from repro_torch.core.stream import lane_keys

    lanes = np.array([0, 1, 5, 1000, 65535])
    want = lane_keys(seed, 65536)[lanes].numpy().view(np.uint32)
    assert np.array_equal(rng.lane_keys(seed, lanes), want)


def test_uniforms_match_the_port():
    from repro_torch.core.stream import counter_uniforms, to_words

    key = rng.lane_keys(SEED, np.arange(64))
    ctr = np.arange(64, dtype=np.uint64) * np.uint64(2 ** 31 + 12345)
    u1, u2 = rng.uniforms(key, ctr)
    k = to_words(torch.from_numpy(key.view(np.int32).copy()))
    c = torch.from_numpy(ctr.astype(np.int64))
    p1, p2 = counter_uniforms(k[:, 0], k[:, 1], c & 0xFFFFFFFF, c >> 32)
    assert np.array_equal(u1, p1.numpy()) and np.array_equal(u2, p2.numpy())


def test_log_and_exp_match_the_port():
    from repro_torch.core.mathf import exp_f32, log_f32

    g = np.random.default_rng(3)
    u = g.random(200_000, dtype=np.float32) + np.float32(1e-12)
    x = (-16 * g.random(200_000)).astype(np.float32)
    assert np.array_equal(fmath.log_f32(u),
                          log_f32(torch.from_numpy(u)).numpy())
    assert np.array_equal(fmath.exp_f32(x),
                          exp_f32(torch.from_numpy(x)).numpy())


def test_bf16_rounds_to_nearest_even():
    v = np.array([1.0, 257.0, 259.0, 1.00390625, 1e-3], np.float32)
    want = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    assert np.array_equal(bf16(v), want)


def test_fold_is_the_float64_record():
    obs = np.random.default_rng(1).integers(0, 900, (1000, 3))
    rec = fold(obs)
    assert rec["n"] == 1000
    assert np.allclose(rec["mean"], obs.mean(axis=0), rtol=0, atol=1e-12)
    assert np.allclose(rec["var"], obs.var(axis=0, ddof=1), rtol=1e-14)


def test_reference_agrees_with_itself_on_lv8():
    """A lane's path is its own: the same lanes followed alone, in other
    batches and twice give the same bits."""
    cell = find("lv8-exact", sizes())
    job = cell.job(SEED)
    whole = follow(cell.net, job, np.arange(32), 2)
    part = follow(cell.net, job, np.array([3, 17, 30]), 2)
    again = follow(cell.net, job, np.arange(32), 2)
    assert np.array_equal(whole["x"][[3, 17, 30]], part["x"])
    assert all(np.array_equal(whole[k], again[k]) for k in whole)
    assert whole["steps"].min() > 0 and not whole["truncated"].any()


@pytest.mark.parametrize("workload,path", [
    ("lv8-exact", {}), ("lv8-tau", {}), ("lv8-exact", SPARSE),
    ("lv8-tau", SPARSE)], ids=["lv8-exact", "lv8-tau", "lv8-exact-sparse",
                               "lv8-tau-sparse"])
def test_reference_follows_the_port_bit_for_bit(workload, path):
    """Every lane of a cut job, after every window: the port's CPU path
    (its kernels' plain twins, dense or sparse) and the reference give
    the same populations."""
    from repro_torch.api import simulate

    cell = find(workload, merged(sizes(**path), {"experiment": {
        "schedule": {"t_end": 0.5, "n_windows": 4}}}))
    res = simulate(cell.experiment(SEED), device="cpu", max_windows=0)
    states = []
    while not res.completed:
        res.resume(max_windows=1)
        states.append(res.final_state())
    n = cell.replicas
    ref = follow(cell.net, cell.job(SEED), np.arange(n), cell.n_windows)
    assert len(states) == len(ref["xs"]) == 4
    assert all(np.array_equal(a, b) for a, b in zip(states, ref["xs"]))
    assert int(ref["steps"].sum()) == sum(res.telemetry.steps_per_window)
    assert int(ref["leaps"].sum()) == sum(res.telemetry.leaps_per_window)
