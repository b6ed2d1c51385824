"""The port on the card: the CUDA SSA window kernel against its plain
twin, and the fused-kernel engine path against the unfused one, bit for
bit on one device.

Every test needs a CUDA device and nvcc and skips itself without them.
The file imports neither JAX nor the reference package, so it runs
where only the port's dependencies are installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.api as T
from repro_torch.core import gillespie as tg
from repro_torch.core.cwc.compile import compile_model
from repro_torch.core.cwc.models import MODELS
from repro_torch.kernels import ssa_step as tks

HORIZON = {"lv8": 0.05, "ecoli": 10.0, "transport": 2.0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _rates(system, b, rng, per_lane):
    if not per_lane:
        return None
    return (system.rates[None] * rng.uniform(0.5, 1.5, (b, system.n_reactions))
            ).astype(np.float32)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_twin(cuda):
    """The CUDA kernel against its plain twin, bitwise, with shared and
    per-lane rates and a budget cut; shapes above the kernel's caps
    raise."""
    rng = np.random.default_rng(0)
    for name, per_lane, n_steps in (("lv8", True, 4096),
                                    ("ecoli", False, 4096),
                                    ("transport", True, 4096),
                                    ("lv8", False, 16)):
        ts, _ = compile_model(MODELS[name]())
        b = 4096
        pool = tg.init_lanes(ts, b, 3, device=cuda)
        tens = tg.system_tensors(ts, _rates(ts, b, rng, per_lane),
                                 device=cuda)
        args = (pool.x, pool.t, pool.dead.to(torch.int32), pool.key,
                pool.ctr, pool.ctr_hi, *tens, HORIZON[name])
        before = tks.ssa_window_call.launches
        k = tks.ssa_window_call(*args, n_steps=n_steps)
        assert tks.ssa_window_call.launches == before + 1
        p = tks.ssa_window_plain(*args, n_steps=n_steps)
        torch.cuda.synchronize()
        for a, c in zip(k, p):
            if a.dtype == torch.float32:
                a, c = a.view(torch.int32), c.view(torch.int32)
            assert torch.equal(a, c), name
    big = torch.zeros((4, tks.MAX_S + 1), device=cuda)
    with pytest.raises(ValueError, match="S <="):
        tks.ssa_window_call(big, *args[1:6],
                            *tg.system_tensors(ts, device=cuda), 0.1,
                            n_steps=4)


@pytest.mark.cuda
@pytest.mark.parametrize("reduction", ["ensemble", "per_point"])
def test_cuda_simulate_kernel_path_matches_unfused(cuda, reduction):
    """simulate() on the card: the fused kernel path (one launch per
    window, on the default device) and the unfused group loop give the
    same records, per-point statistics and final pool."""
    per_point = reduction == "per_point"
    sweep = {"reproduce": [0.8, 1.2], "die": [0.5, 0.7]} if per_point \
        else None
    exp = T.Experiment(
        model=MODELS["lv2"](),
        ensemble=T.Ensemble.make(replicas=64, sweep=sweep),
        schedule=T.Schedule(t_end=0.3, n_windows=3), n_lanes=128, seed=5,
        reduction=T.Reduction.PER_POINT if per_point
        else T.Reduction.ENSEMBLE)
    before = tks.ssa_window_call.launches
    fused = T.simulate(exp.with_(use_kernel=True))  # default device
    assert tks.ssa_window_call.launches == before + 3
    assert "device=cuda" in repr(fused)
    unfused = T.simulate(exp, device=cuda)
    assert tks.ssa_window_call.launches == before + 3
    for a, b in zip(fused.records, unfused.records):
        for f in ("mean", "var", "ci90"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert fused.telemetry.steps_per_window == \
        unfused.telemetry.steps_per_window
    assert (fused.final_state() == unfused.final_state()).all()
    if per_point:
        pf, pu = fused.per_point(), unfused.per_point()
        for f in ("n", "mean", "var", "ci90"):
            assert pf[f].tobytes() == pu[f].tobytes(), f
