"""Split a farm worker's start-up into the interpreter and its imports.

Starts ``python -X importtime -m repro_torch.runtime.worker`` with no
spec (the worker imports everything its real run imports, prints its
usage line and exits 2), first one process alone, then N at a time, and
reads each process's wall clock and its import-time log. For each
group it prints the wall of every process, the seconds spent in the
imports of each top-level package (cumulative, as ``-X importtime``
reports them) and the rest (the interpreter's own start and exit), so
one can see whether the N processes pay for competing over the host or
for one module's work at import.

    python3 benchmarks/worker_imports.py --procs 1,4
    python3 benchmarks/worker_imports.py --procs 1,4 --src OTHER/src

Runs on the CPU; needs no card. Prints one JSON line per group.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def top_level_split(log: str) -> dict[str, float]:
    """Seconds of cumulative import time for each top-level package.

    A line of ``-X importtime`` reads ``import time: self | cumulative |
    name``; a top-level import is one whose name is not indented."""
    split: dict[str, float] = defaultdict(float)
    for line in log.splitlines():
        if not line.startswith("import time:"):
            continue
        parts = line[len("import time:"):].split("|")
        if len(parts) != 3 or not parts[1].strip().isdigit():
            continue
        name = parts[2]
        if name.startswith("  "):  # a nested import: in its parent's sum
            continue
        split[name.strip().split(".")[0]] += int(parts[1]) / 1e6
    return dict(split)


def run_group(n: int, src: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(src))
    cmd = [sys.executable, "-X", "importtime", "-m",
           "repro_torch.runtime.worker"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(n)]
    errs, walls = [""] * n, [0.0] * n

    def reap(k):  # each process's own end, read while the others run
        errs[k] = procs[k].communicate()[1]
        walls[k] = time.perf_counter() - t0

    readers = [threading.Thread(target=reap, args=(k,)) for k in range(n)]
    for r in readers:
        r.start()
    for r in readers:
        r.join()
    for p, err in zip(procs, errs):
        if p.returncode != 2 or "usage" not in err:
            raise RuntimeError(f"the worker exited {p.returncode}:\n"
                               f"{err[-2000:]}")
    splits = [top_level_split(err) for err in errs]
    imports = [sum(s.values()) for s in splits]
    heavy = sorted(splits[0], key=splits[0].get, reverse=True)[:6]
    return {
        "procs": n,
        "wall_s": walls,
        "imports_s": imports,
        "rest_s": [w - i for w, i in zip(walls, imports)],
        "top_level_s": {k: [s.get(k, 0.0) for s in splits] for k in heavy},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", default="1,4",
                    help="comma-separated group sizes, run in turn")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src/ directory that holds repro_torch")
    args = ap.parse_args()
    print(f"cores {os.cpu_count()}, python {sys.version.split()[0]}",
          flush=True)
    for n in (int(k) for k in args.procs.split(",")):
        print(json.dumps(run_group(n, args.src.resolve())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
