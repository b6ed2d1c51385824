"""The reference steering drill's own case at its own sizes (birth
rates 50 and 800 over 32 replicas, a 16-bin sketch up to 1024), held
against the reference once: the uninterrupted runs of both packages,
and the port's crash drill against the reference's uninterrupted run.

tests/test_torch_steering.py runs every case scaled to a twentieth of
the events; this file shows the scaling changes no decision. Both
points stop, as the reference's run really does: point 1 at window 4,
its 31 freed lanes move to point 0, and point 0 stops at window 6.
"""
from test_torch_steering import (
    J, N_WINDOWS, REALLOC, T, _drill, _exp, assert_like_reference,
    print_margins, rec_tuple, run)

LITERAL = dict(lams=(50.0, 800.0), replicas=32,
               sketch=dict(n_bins=16, hi=1024.0))

_RUNS = {}


def _ref():
    if "ref" not in _RUNS:
        _RUNS["ref"] = run(_exp(J, REALLOC, **LITERAL))
    return _RUNS["ref"]


def test_reference_drill_case_reports_equal_at_reference_sizes():
    """Report, per-point records and sketches of the literal case equal
    the reference's (records within the ulp bound, sketches bitwise)."""
    ref = _ref()
    got = run(_exp(T, REALLOC, **LITERAL))
    rep = got.steering_report()
    assert rep["stopped_points"] == [0, 1]
    assert rep["stop_windows"] == {0: 6, 1: 4}
    assert {"window": 4, "action": "reallocate", "target": 0,
            "n_moved": 31} in rep["decisions"]
    assert_like_reference(ref, got)
    assert len(got.sketches()) == len(ref.sketches()) == N_WINDOWS
    for a, b in zip(got.sketches(), ref.sketches()):
        assert a.hist.tobytes() == b.hist.tobytes()
        assert int(a.hist.sum()) == 2 * 32
    assert print_margins(got) > 1e-3


def test_port_crash_drill_matches_reference_at_reference_sizes(tmp_path):
    """The port's drill of the literal case (crashes at windows 2 and 6,
    rebuild and restore) ends with the reference's uninterrupted report,
    sketches and record means."""
    ref = _ref()
    eng = _drill(str(tmp_path / "drill"), exp=_exp(T, REALLOC, **LITERAL))
    assert eng.steering_report() == ref.steering_report()
    recs = eng.stream.records()
    assert [(r.t, r.n, r.mean.tobytes()) for r in recs] == [
        (r.t, r.n, r.mean.tobytes()) for r in ref.records]
    assert len(rec_tuple(recs)) == N_WINDOWS
    for a, b in zip(eng.sketches(), ref.sketches()):
        assert a.hist.tobytes() == b.hist.tobytes()
