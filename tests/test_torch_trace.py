"""The engine's spans (`repro_torch.core.trace`): nothing built while no
profiler runs, every span of the set-up and the window loop on a CPU
profiler's trace, each inside its parent, one `repro_torch.window.pull`
per counted host sync, and the same records with the profiler on and
off."""
import timeit

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.api as T
from repro_torch.core import trace
from repro_torch.core.cwc.models import MODELS

N_WINDOWS = 3
SETUP_PARTS = (trace.SETUP_COMPILE, trace.SETUP_TABLES,
               trace.SETUP_DISPATCH, trace.SETUP_LANES)
WINDOW_PARTS = (trace.WINDOW_KERNEL, trace.WINDOW_FOLD, trace.WINDOW_PULL,
                trace.WINDOW_EMIT)


def make_exp(window_block=1, schema="iii", policy="on_demand", sweep=None,
             **kw):
    return T.Experiment(
        model=MODELS["lv2"](),
        ensemble=T.Ensemble.make(replicas=16, sweep=sweep),
        schedule=T.Schedule(t_end=0.005, n_windows=N_WINDOWS, schema=schema,
                            policy=policy),
        n_lanes=8, seed=7, window_block=window_block, use_kernel=True, **kw)


def traced(fn):
    """(fn's value, {span name: [(start, end) ns, ...] by start}) of the
    `repro_torch.` spans a CPU profiler records while fn runs."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("repro_torch."):
            spans.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.end_ns()))
    return out, {k: sorted(v) for k, v in spans.items()}


def inside(child, parents) -> bool:
    return any(a <= child[0] and child[1] <= b for a, b in parents)


def assert_nested(spans, children, parent):
    for name in children:
        for s in spans.get(name, []):
            assert inside(s, spans[parent]), (name, s, parent)


def test_off_the_span_is_the_one_null_context():
    assert not torch._C._autograd._profiler_enabled()
    assert trace.span(trace.WINDOW) is trace.span(trace.SETUP) is trace._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.span(trace.WINDOW) is not trace._OFF


def test_off_path_cost():
    """The guarded span against an unguarded `record_function`, with no
    profiler running (both printed, in us per enter and exit)."""
    def guarded():
        with trace.span(trace.WINDOW):
            pass

    def unguarded():
        with torch.profiler.record_function(trace.WINDOW):
            pass

    n = 20000
    g, u = (min(timeit.repeat(f, number=n, repeat=5)) / n * 1e6
            for f in (guarded, unguarded))
    print(f"span() off: {g:.3f} us; record_function off: {u:.3f} us")
    assert g * 4 < u


@pytest.mark.parametrize("kw", [
    {},
    dict(schema="ii", policy="predictive", sweep={"die": [0.3, 1.2]},
         reduction=T.Reduction.PER_POINT),
], ids=["iii", "ii-predictive-per-point"])
def test_per_window_spans(kw):
    seen = []
    exp = make_exp(sinks=(seen.append,), **kw)
    res, spans = traced(lambda: T.simulate(exp, device="cpu"))
    assert len(seen) == N_WINDOWS
    assert len(spans[trace.SETUP]) == 1
    for name in SETUP_PARTS:
        assert len(spans[name]) == 1, name
    assert_nested(spans, SETUP_PARTS, trace.SETUP)
    # the set-up ends before the first window starts
    assert spans[trace.SETUP][0][1] <= spans[trace.WINDOW][0][0]
    assert len(spans[trace.WINDOW]) == N_WINDOWS
    assert len(spans[trace.WINDOW_KERNEL]) == N_WINDOWS
    assert len(spans[trace.WINDOW_FOLD]) == 2 * N_WINDOWS
    assert len(spans[trace.WINDOW_EMIT]) == N_WINDOWS
    assert_nested(spans, WINDOW_PARTS, trace.WINDOW)
    syncs = res.telemetry.host_syncs
    assert syncs == N_WINDOWS * (1 if not kw else 4)
    assert len(spans[trace.WINDOW_PULL]) == syncs
    assert not any(n.startswith("repro_torch.block.") for n in spans)


def test_block_spans():
    res, spans = traced(lambda: T.simulate(make_exp(window_block=2),
                                           device="cpu"))
    assert trace.WINDOW not in spans
    assert len(spans[trace.BLOCK_DISPATCH]) == 2  # windows 0-1, then 2
    assert len(spans[trace.BLOCK_COLLECT]) == 2
    assert len(spans[trace.WINDOW_KERNEL]) == N_WINDOWS
    assert len(spans[trace.WINDOW_EMIT]) == N_WINDOWS
    assert_nested(spans, (trace.WINDOW_KERNEL, trace.WINDOW_FOLD),
                  trace.BLOCK_DISPATCH)
    assert_nested(spans, (trace.WINDOW_PULL, trace.WINDOW_EMIT),
                  trace.BLOCK_COLLECT)
    assert len(spans[trace.WINDOW_PULL]) == res.telemetry.host_syncs == 2
    assert [b[:2] for b in res.telemetry.block_walls] == [(0, 2), (2, 1)]
    assert all(len(b) == 3 for b in res.telemetry.block_walls)


def test_checkpoint_and_restore_spans(tmp_path):
    ck = str(tmp_path / "ck")
    _, spans = traced(lambda: T.simulate(make_exp(), device="cpu",
                                         checkpoint_path=ck, max_windows=2))
    assert len(spans[trace.CHECKPOINT]) == 2
    assert trace.RESTORE not in spans
    res, spans = traced(lambda: T.simulate(make_exp(), device="cpu",
                                           checkpoint_path=ck, resume=True))
    assert len(spans[trace.RESTORE]) == 1
    assert_nested(spans, (trace.RESTORE,), trace.SETUP)
    assert len(spans[trace.WINDOW]) == N_WINDOWS - 2
    assert res.windows_run == N_WINDOWS


@pytest.mark.parametrize("window_block", [1, 2])
def test_records_are_the_same_traced(window_block):
    exp = make_exp(window_block=window_block)
    plain = T.simulate(exp, device="cpu")
    with_spans, _ = traced(lambda: T.simulate(exp, device="cpu"))
    assert len(plain.records) == len(with_spans.records) == N_WINDOWS
    for a, b in zip(plain.records, with_spans.records):
        assert (a.t, a.window, a.n) == (b.t, b.window, b.n)
        for f in ("mean", "var", "ci90"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert np.array_equal(plain.final_state(), with_spans.final_state())
    assert (plain.telemetry.steps_per_window
            == with_spans.telemetry.steps_per_window)
