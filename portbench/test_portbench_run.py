"""A whole run of a cell on the CPU at cut sizes (no look for a card):
the result's line and what the run imports."""
import subprocess
import sys

import pytest
import torch

from portbench.harness.cell import ROOT
from portbench.tiny import SEED, run


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(traced):
    out, detail = run(traced=traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys and list(out)[-1] == "checks"
    assert ("breakdown" in out) == traced
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    names = set(out["metrics"])
    if traced:
        assert {"job_setup_ms", "host_syncs_per_window",
                "launches_per_window"} <= names
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert names == {"ensemble_s", "record_gap_p95_ms", "setup_s"}
    assert out["metrics"]["host_syncs_per_window" if traced else
                          "setup_s"]["value"] > 0
    assert detail["compared"]["jobs"] == 1
    assert detail["compared"]["records"] == 2
    assert set(out["checks"]) == {"lanes_off", "fold_err"}


def test_imports():
    """What the run loads holds no JAX and no JAX package; the reference
    loads nothing of the program either."""
    code = (
        "import sys, time; sys.path[:0] = ['src', '.']\n"
        "import portbench.reference.lanes, portbench.reference.network\n"
        "import portbench.roofline.tau\n"
        "from portbench.harness import check, cell\n"
        "ref = {m.split('.')[0] for m in sys.modules}\n"
        "from portbench.harness.bench import run_cell, barred_modules\n"
        "from portbench.tiny import sizes\n"
        "run_cell('lv8-tau', 5, 0.3, True, 'cpu', time.perf_counter(),\n"
        "         override=sizes())\n"
        "run = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(ref & {'jax', 'jaxlib', 'flax', 'repro', "
        "'repro_torch'}), barred_modules(), 'repro_torch' in run)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "[] [] True"


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "lv8-exact",
         "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]


def test_the_check_copies_are_off_the_clock(monkeypatch):
    """The drawn job's copies of its lanes (here made a second slower
    each) count in no record's gap."""
    import time

    from repro_torch.api import SimulationResult

    copy = SimulationResult.final_state

    def slow(self):
        time.sleep(1.0)
        return copy(self)

    monkeypatch.setattr(SimulationResult, "final_state", slow)
    out, detail = run()
    assert out["correct"] and detail["compared"]["records"] == 2
    gaps = [g for j in detail["jobs"] for g in j["gaps_ms"]]
    assert max(gaps) < 1000
