"""The comparison against the reference, on the CPU at cut sizes: the
control (the reference at bfloat16 in the program's place) and the
faults it has to catch, each planted under a whole run."""
import pytest

from portbench.faults import FAULTS
from portbench.tiny import SPARSE, run

PATHS = [("lv8-exact", {}), ("lv8-tau", {}), ("lv8-exact", SPARSE),
         ("lv8-tau", SPARSE)]
IDS = ["lv8-exact", "lv8-tau", "lv8-exact-sparse", "lv8-tau-sparse"]


@pytest.mark.parametrize("workload,path", PATHS, ids=IDS)
def test_control_fails(workload, path):
    """The reference at bfloat16 in the program's place is not correct
    (over windows long enough for the rounding to change a path)."""
    over = dict(path, experiment=dict(path.get("experiment", {}),
                                      schedule={"t_end": 0.25}))
    out, detail = run(workload, control=True, seconds=5.0, override=over)
    assert not out["correct"]
    assert detail["compared"]["lanes_off"] > 0
    assert detail["compared"]["fold_err"] > out["checks"]["fold_err"]["limit"]


@pytest.mark.parametrize("workload", ["lv8-exact", "lv8-tau"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_are_caught(monkeypatch, fault, workload):
    FAULTS[fault](monkeypatch.setattr)
    out, _ = run(workload)
    assert not out["correct"]


def test_a_fault_in_an_early_window_is_caught(monkeypatch):
    """Every record is compared, not only the last: each job's first
    window's means altered by a thousandth, the later ones right."""
    from repro_torch.core import reduction

    fin, calls = reduction.finalize, []
    four = {"experiment": {"schedule": {"n_windows": 4}}}

    def first_off(acc):  # one call a window; every job has four
        calls.append(1)
        s = fin(acc)
        return s._replace(mean=s.mean * 1.001) if len(calls) % 4 == 1 else s

    out, detail = run(override=four)
    assert out["correct"] and detail["compared"]["records"] == 4
    monkeypatch.setattr(reduction, "finalize", first_off)
    out, detail = run(override=four)
    assert calls and not out["correct"]
    assert detail["compared"]["fold_err"] > out["checks"]["fold_err"]["limit"]
