"""Quickstart on the PyTorch/CUDA port: define a CWC model, declare an
experiment, stream stats (`examples/quickstart.py` on `repro_torch`).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the CUDA device unless --device says otherwise; without a GPU
and without --device it raises.
"""
import argparse

from repro_torch.api import Ensemble, Experiment, Schedule, Schema, simulate
from repro_torch.core.cwc.rules import CWCModel, Rule
from repro_torch.core.cwc.terms import TOP, term

# A CWC model straight from the paper's §2.1 example style:
#   ⊤ : a b X  -k->  c X
MODEL = CWCModel(
    rules=(
        Rule.make(TOP, {"a": 1, "b": 1}, {"c": 1}, k=0.001, name="combine"),
        Rule.make(TOP, {"c": 1}, {"a": 1, "b": 1}, k=0.05, name="split"),
    ),
    init_fn=lambda: term({"a": 300, "b": 300}),
    observables=((TOP, "a"), (TOP, "b"), (TOP, "c")),
    name="quickstart",
)


def main(device=None, use_kernel: bool = False):
    # 64 stochastic instances, 20 sim-time windows, on-line reduction
    result = simulate(Experiment(
        model=MODEL,
        ensemble=Ensemble.make(replicas=64),
        schedule=Schedule(t_end=50.0, n_windows=20, schema=Schema.ONLINE),
        n_lanes=64,
        seed=0,
        use_kernel=use_kernel,
    ), device=device)
    for rec in result.records:
        a, b, c = rec.mean
        print(f"t={rec.t:6.1f}  a={a:7.1f}  b={b:7.1f}  c={c:7.1f} "
              f"(ci90 ±{rec.ci90[2]:.2f}, n={rec.n:.0f})")

    tele = result.telemetry
    print(f"\npeak buffered bytes (schema iii is memory-bounded): "
          f"{tele.peak_buffered_bytes}")
    print(f"one device dispatch per window: {tele.dispatches} dispatches "
          f"for {len(result.records)} windows in {tele.wall_time_s:.2f}s")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    result = main(ap.parse_args().device)
