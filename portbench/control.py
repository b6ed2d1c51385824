"""The control of the comparison, and the faults it has to catch, on a
cell's own sizes: the plain reference in the program's place at the next
precision below the configuration's (bfloat16 for float32), or the
program with a fault planted (`portbench/faults.py`). Each run's
compared numbers have to fail their limits; the control's are the upper
readings the limits are set below. The benchmark's own runs never run
it.

    python3 portbench/control.py --workload lv8-exact --seeds 1 2 3
    python3 portbench/control.py --workload lv8-exact --seeds 1 \\
        --fault half_batch
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
    from portbench.faults import FAULTS

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0,
                   help="a window long enough to finish the drawn jobs")
    p.add_argument("--fault", choices=sorted(FAULTS),
                   help="the program with this fault, not the control")
    a = p.parse_args(argv)

    import torch

    from portbench.harness.bench import run_cell
    from portbench.harness.cell import find

    torch.set_num_threads(1)
    devices = [torch.device("cuda", i)
               for i in range(find(a.workload).chips)]
    if a.fault:
        FAULTS[a.fault](setattr)
    for seed in a.seeds:
        out, detail = run_cell(a.workload, seed, a.seconds, False, devices,
                               time.perf_counter(), control=not a.fault)
        print(json.dumps(dict(workload=a.workload, seed=seed,
                              fault=a.fault or "control",
                              correct=out["correct"],
                              compared=detail["compared"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
