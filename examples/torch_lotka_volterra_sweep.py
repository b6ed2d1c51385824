"""Parameter sweep on the PyTorch/CUDA port (paper §3.1.2: "replicas or
parameter sweeping"): Lotka-Volterra predator death-rate sweep, 4
points × 32 replicas, declared as ONE experiment with per-point on-line
reduction (`examples/lotka_volterra_sweep.py` on `repro_torch`).

  PYTHONPATH=src python examples/torch_lotka_volterra_sweep.py [--device cpu]

Runs on the CUDA device unless --device says otherwise; without a GPU
and without --device it raises.
"""
import argparse

from repro_torch.api import (
    Ensemble,
    Experiment,
    Policy,
    Reduction,
    Schedule,
    Schema,
    simulate,
)
from repro_torch.core.cwc.models import lotka_volterra


def main(device=None, use_kernel: bool = False):
    result = simulate(Experiment(
        model=lotka_volterra(2),
        ensemble=Ensemble.make(replicas=32,
                               sweep={"die": [0.3, 0.6, 1.2, 2.4]}),
        schedule=Schedule(t_end=5.0, n_windows=10, schema=Schema.ONLINE,
                          policy=Policy.PREDICTIVE),
        reduction=Reduction.PER_POINT,
        n_lanes=64,
        seed=0,
        use_kernel=use_kernel,
    ), device=device)
    pp = result.per_point()  # {"mean": (W, P, n_obs), ..., "points": [...]}
    print("predator death rate | final prey (mean) | final predators (mean)")
    for p, point in enumerate(pp["points"]):
        prey, pred = pp["mean"][-1, p]
        print(f"  k_die = {point['die']:4.1f}       | {prey:12.1f}      | "
              f"{pred:12.1f}")
    print(f"\nwall={result.telemetry.wall_time_s:.2f}s "
          f"dispatches={result.telemetry.dispatches} "
          f"(one fused window_step per window)")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    result = main(ap.parse_args().device)
