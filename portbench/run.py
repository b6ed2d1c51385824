"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 portbench/run.py --workload lv8-exact --seed 7 --seconds 20 \
        --trace 0

Set-up (imports, the CUDA context, the kernel library from the
checkout's `build/kernels/`, one warm job of the cell's shapes) is timed
as `setup_s`; then one client submits the cell's jobs back to back for
`--seconds`; then the drawn jobs are compared with the plain reference.
With `--trace 1` the window runs under `torch.profiler` and the
per-layer metrics are reported instead of the end-to-end ones. The last
line of standard output is the result as JSON; the compared numbers and
their limits close standard error. Per-job numbers and the trace's
summary go to `build/portbench/`.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from portbench.harness.bench import (
        barred_modules,
        run_cell,
        write_detail,
    )
    from portbench.harness.cell import find

    chips = find(a.workload).workload["chips"]
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"portbench: {a.workload} needs {chips} CUDA device(s); "
              f"{seen} visible", file=sys.stderr)
        return 2
    # one host thread: the load comes from one process, and runs spread
    # less when the host's other tenants take cores
    torch.set_num_threads(1)
    devices = [torch.device("cuda", i) for i in range(chips)]
    torch.cuda.set_device(devices[0])
    out, detail = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                           devices, T_START)
    path = write_detail(detail)
    barred = barred_modules()
    if barred:
        print(f"portbench: the run loaded {barred}, which it may not",
              file=sys.stderr)
        return 3
    print(f"portbench: per-job numbers in {path.relative_to(ROOT)}; done "
          f"{time.perf_counter() - T_START:.3f} s after the start",
          file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']} (limit {v['limit']})", file=sys.stderr,
              flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
