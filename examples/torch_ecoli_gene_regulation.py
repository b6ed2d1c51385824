"""Paper Fig. 1 on the PyTorch/CUDA port: gene regulation in E. coli —
100 instances, mean + 90% CI at fixed simulation time steps, computed
with the on-line pipelined reduction (schema iii)
(`examples/ecoli_gene_regulation.py` on `repro_torch`).

  PYTHONPATH=src python examples/torch_ecoli_gene_regulation.py [--device cpu]

Writes artifacts/ecoli_fig1.csv under the working directory (t, mean,
var, ci90 per observable). Runs on the CUDA device unless --device says
otherwise; without a GPU and without --device it raises.
"""
import argparse
import os

from repro_torch.api import CsvSink, Ensemble, Experiment, Schedule, simulate
from repro_torch.api.run import observable_names
from repro_torch.core.cwc.models import ecoli_gene_regulation

OUT = "artifacts/ecoli_fig1.csv"


def main(device=None, use_kernel: bool = False, out: str = OUT):
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    model = ecoli_gene_regulation()
    result = simulate(Experiment(
        model=model,
        ensemble=Ensemble.make(replicas=100),
        schedule=Schedule(t_end=100.0, n_windows=100, schema="iii"),
        sinks=(CsvSink(out, observable_names(model)),),  # closed by simulate()
        n_lanes=100,
        seed=0,
        use_kernel=use_kernel,
    ), device=device)

    # a terminal sparkline of the protein trajectory with its CI band
    records = result.records
    prot = result.obs_names.index("ecoli/protein")
    peak = max(r.mean[prot] for r in records) or 1.0
    print("t      protein (mean ± ci90)")
    for r in records[::5]:
        bar = "#" * int(40 * r.mean[prot] / peak)
        print(f"{r.t:6.1f} {r.mean[prot]:8.1f} ±{r.ci90[prot]:6.2f}  {bar}")
    print(f"\nfull statistics streamed to {out}")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    result = main(ap.parse_args().device)
