"""Training crash/restore drill; port of `repro/train/drill.py`.

Determinism contract: a restored run gives the same losses as an
uninterrupted run, because the data pipeline is deterministic in the
step index and the optimizer state rides the checkpoint.
"""
from __future__ import annotations

from repro_torch.runtime.fault import FailureInjector, FailurePlan


def run_train_with_failures(make_state, train_step, batches, ckpt_dir: str,
                            plan: FailurePlan, save_fn, restore_fn,
                            ckpt_every: int = 2):
    """Drill: training loop with crash/restore at step granularity.
    Returns (final state, losses by step, the injector's events)."""
    inj = FailureInjector(plan, n_windows=len(batches))
    state = make_state()
    save_fn(state, 0)
    losses = {}
    step = 0
    while step < len(batches):
        if inj.maybe_fail(step):
            state, step = restore_fn()
            continue
        state, metrics = train_step(state, batches[step])
        losses[step] = float(metrics["loss"])
        step += 1
        if step % ckpt_every == 0:
            save_fn(state, step)
    return state, [losses[i] for i in range(len(batches))], inj.events
