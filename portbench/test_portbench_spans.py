"""The readers of the program's own spans (`harness/spans.py` and the six
metrics on it): self time, the idle time split by the spans the host
was in, nothing to read without a program span, and a traced run of
each cell on the CPU reporting all six."""
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.harness import bench, spans, trace
from portbench.harness.trace import CHECK_SPAN, Trace
from portbench.tiny import run

I64 = np.int64
SIX = ("setup_span_ms", "window_host_ms", "fold_span_ms_per_window",
       "device_idle_pct.setup", "device_idle_pct.windows",
       "device_idle_pct.outside")
SHORT = {"experiment": {"schedule": {"t_end": 0.005}}}


def hand_made(program=True):
    # host: a job's set-up 0-20 launching an init (corr 1); its window
    # 30-100: the kernel launched at 32 (corr 2), the fold at 41 and 43
    # (corr 3, 4), the pull 50-85 waiting on a copy (corr 5), the emit;
    # the check's copy 110-130 (corr 6); nothing of the program after
    host = [("portbench.window", 0, 200, 0),
            ("repro_torch.setup", 0, 20, 0),
            ("repro_torch.setup.tables", 5, 15, 0),
            ("cudaLaunchKernel", 8, 9, 1),
            ("repro_torch.window", 30, 100, 0),
            ("repro_torch.window.kernel", 31, 34, 0),
            ("cudaLaunchKernel", 32, 33, 2),
            ("repro_torch.window.fold", 40, 45, 0),
            ("cudaLaunchKernel", 41, 42, 3), ("cudaLaunchKernel", 43, 44, 4),
            ("repro_torch.window.pull", 50, 85, 0),
            ("cudaMemcpyAsync", 51, 52, 5),
            ("repro_torch.window.emit", 86, 95, 0),
            (CHECK_SPAN, 110, 130, 0), ("cudaMemcpyAsync", 111, 112, 6)]
    if not program:
        host = [h for h in host if not h[0].startswith("repro_torch.")]
    # device: busy 10-12, 35-80 (kernel, two fold ops, the copy) and the
    # cut 110-130; idle 0-10, 12-35, 80-110, 130-200
    dev = [("init", 10, 12, 1, 0), ("ssa_window_kernel", 35, 70, 2, 0),
           ("indexSelectSmallIndex", 70, 74, 3, 0),
           ("reduce_kernel", 74, 78, 4, 0),
           ("Memcpy DtoH (Device -> Pageable)", 78, 80, 5, 0)]
    col, hcol = list(zip(*dev)), list(zip(*host))
    tr = Trace((0, 200), list(col[0]), *(np.asarray(c, I64)
                                         for c in col[1:]),
               list(hcol[0]), *(np.asarray(c, I64) for c in hcol[1:]),
               cut=np.asarray([(110, 130)], I64))
    return SimpleNamespace(trace=tr, window=SimpleNamespace(windows=1))


def test_self_time_and_overlap():
    tr = hand_made().trace
    assert spans.self_ns(tr, spans.WINDOW, (spans.PULL,)).tolist() == [35]
    u = spans.union(np.asarray([(5, 9), (0, 3), (2, 4), (8, 12)], I64))
    assert u.tolist() == [[0, 4], [5, 12]]
    assert spans.overlap_ns(np.asarray([(-5, 1), (3, 6), (11, 20)], I64),
                            u).tolist() == [1, 2, 1]


def test_the_idle_parts_partition_the_idle_time():
    r = hand_made()
    # idle 133 ns of a 180 ns window (the cut out): under the set-up
    # 0-10 and 12-20, under the window 30-35 and 80-100, outside 20-30,
    # 100-110 and 130-200
    parts = spans.idle_parts_pct(r.trace)
    assert parts == pytest.approx(dict(setup=100 * 18 / 180,
                                       windows=100 * 25 / 180,
                                       outside=100 * 90 / 180))
    whole = bench.reader("device_idle_pct")(r)
    assert sum(parts.values()) == pytest.approx(whole)
    got = {m: bench.reader(m)(r) for m in SIX}
    assert got == pytest.approx({
        "setup_span_ms": 20e-6, "window_host_ms": 35e-6,
        "fold_span_ms_per_window": 8e-6,
        "device_idle_pct.setup": parts["setup"],
        "device_idle_pct.windows": parts["windows"],
        "device_idle_pct.outside": parts["outside"]})


def test_nothing_to_read_without_the_program_spans():
    r = hand_made(program=False)
    assert bench.reader("device_idle_pct")(r) is not None
    assert {m: bench.reader(m)(r) for m in SIX} == dict.fromkeys(SIX)
    assert all(bench.reader(m)(SimpleNamespace(
        trace=None, window=SimpleNamespace(windows=1)))
               is None for m in SIX)


def with_stand_ins(collect):
    """`collect`, with the host's aten operations standing in for the
    card's (a CPU trace has no device timeline)."""
    def wrapped(prof):
        tr = collect(prof)
        sel = [i for i, n in enumerate(tr.host_name)
               if n.startswith("aten::")]
        return Trace(tr.window, [tr.host_name[i] for i in sel],
                     tr.host_start[sel], tr.host_end[sel],
                     np.zeros(len(sel), I64), np.zeros(len(sel), I64),
                     tr.host_name, tr.host_start, tr.host_end, tr.host_corr,
                     cut=tr.cut)
    return wrapped


@pytest.mark.parametrize("workload", ["lv8-exact", "lv8-tau"])
def test_a_traced_run_reports_the_six(workload, monkeypatch):
    monkeypatch.setattr(trace, "collect", with_stand_ins(trace.collect))
    # short jobs in a short window: each aten call is a stand-in
    out, _ = run(workload, traced=True, seconds=0.3, override=SHORT)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"] and set(SIX) <= set(m)
    parts = sum(m[f"device_idle_pct.{p}"]
                for p in ("setup", "windows", "outside"))
    assert abs(parts - m["device_idle_pct"]) < 0.01
    assert all(m[f"device_idle_pct.{p}"] >= 0
               for p in ("setup", "windows", "outside"))
    assert 0 < m["setup_span_ms"] <= m["job_setup_ms"]
    assert 0 < m["fold_span_ms_per_window"] <= m["fold_ms_per_window"]
    assert m["window_host_ms"] > 0
