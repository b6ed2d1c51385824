"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result's line."""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from portbench.harness import check, trace
from portbench.harness.cell import BENCH, ROOT, Cell, benchmark, find, \
    job_seed, limits
from portbench.harness.loop import Clock, Window, run_job

#: top-level modules no run may hold once its window has closed
BARRED = ("jax", "jaxlib", "flax", "repro")
OUT = ROOT / "build" / "portbench"


@dataclass
class Run:
    cell: Cell
    window: Window
    trace: Optional[trace.Trace]


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(cell: Cell, traced: bool) -> list:
    """The metric entries of BENCHMARK.json this cell reports."""
    bench = benchmark()
    if not traced:
        return [m for m in bench["end_to_end"]
                if cell.name in m.get("workloads", [cell.name])]
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell.name in m.get("workloads", [cell.name])}
    return [m for m in bench["per_layer"]
            if cell.name in m.get("workloads", [cell.name])
            and m["moves"] in e2e]


def barred_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BARRED))


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             devices, t_start: float, override=None, control=False):
    """Set up, measure, compare; returns the result's line (a dict) and
    the run's details (per job, the compared numbers, the trace's
    summary). devices: the cell's cards, or "cpu" for the tests;
    override: configuration blocks merged over it (smaller sizes on the
    CPU)."""
    import torch

    cuda = devices != "cpu"
    cell = find(workload, override)
    device = devices if not cuda or len(devices) > 1 else devices[0]
    drive = importlib.import_module(f"portbench.loops.{cell.mix['loop']}")
    # the warm job: the cell's own shapes, seeded apart from every job
    run_job(cell, job_seed(seed, -1), -1, device, Clock())
    if cuda:
        for d in devices:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t_start
    print(f"portbench: set up in {setup_s:.3f} s", file=sys.stderr)

    keep = check.drawn_jobs(seed, cell.check["jobs"], cell.check["pool"])
    tr, failed = None, 0
    try:
        if traced:
            prof = trace.profiler(cuda)
            with prof:
                with trace.span(trace.WINDOW_SPAN):
                    window = drive.drive(cell, seed, seconds, device, keep,
                                         span=trace.span)
                if cuda:
                    torch.cuda.synchronize()
            tr = trace.collect(prof)
            del prof
        else:
            window = drive.drive(cell, seed, seconds, device, keep)
    except Exception:
        traceback.print_exc()
        failed = 1
        window = Window(0.0, [], 0)
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) \
        if cuda else 0

    t_check = time.perf_counter()
    print(f"portbench: {len(window.jobs)} jobs in {window.seconds:.3f} s; "
          "comparing", file=sys.stderr)
    numbers = check.compare(cell, window, seed, control=control)
    check_s = time.perf_counter() - t_check
    print(f"portbench: compared in {check_s:.3f} s", file=sys.stderr)
    lim = limits(workload)
    correct = not failed and check.verdict(numbers, lim)
    run = Run(cell, window, tr)
    n_windows = cell.n_windows
    metrics = {}
    for m in cell_metrics(cell, traced):
        if m["name"] == "setup_s":
            v = setup_s
        elif m["name"] == "ensemble_s":
            done = window.jobs_done(n_windows)
            v = window.seconds / done if done else None
        elif m["name"] == "record_gap_p95_ms":
            g = window.gaps_ms()
            v = float(np.percentile(g, 95)) if g.size else None
        else:
            v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(devices[0]) if cuda else "cpu",
           "count": cell.chips if cuda else 1,
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct),
           "attempted": len(window.jobs) + failed,
           "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = {k: {"value": numbers[k], "limit": lim[k]}
                     for k in lim}
    detail = dict(workload=workload, seed=seed, seconds=seconds,
                  traced=traced, setup_s=setup_s, compared=numbers,
                  check_s=check_s,
                  window_s=window.seconds,
                  jobs=[dict(index=j.index, seed=j.seed, setup_s=j.setup_s,
                             windows=j.windows, host_syncs=j.host_syncs,
                             steps=list(map(int, j.steps)),
                             leaps=list(map(int, j.leaps)),
                             gaps_ms=(1e3 * np.diff([j.submitted]
                                                    + j.arrivals)).tolist())
                        for j in window.jobs],
                  trace=trace.summary(tr) if tr is not None else None)
    return out, detail


def write_detail(detail: dict) -> Path:
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / (f"{detail['workload']}-seed{detail['seed']}-trace"
                  f"{int(detail['traced'])}.json")
    path.write_text(json.dumps(detail))
    return path
