"""Spans at the engine's layer boundaries, for a caller's profiler.

`span(name)` (and `spanned(name)`, its form as a decorator of a method
spanned whole) is `torch.profiler.record_function(name)` while a profiler
runs in this process, and one shared null context otherwise, so an
untraced run builds no `RecordFunction` (a guarded enter and exit costs
well under a microsecond on a CPU; an unguarded `record_function` about
ten). The spans land in the profiler's kineto trace beside the CUDA
runtime calls and the kernels, on the device trace's clock, so a gap on
the card reads as the innermost span the host was in. There is no
setting and no exporter: the caller's profiler is both.

Nesting is by time on one thread. The spans (each name below follows
`repro_torch.`), the layers they cover, and the benchmark metrics that
read them (`portbench/metrics/<name>.py`):

  span             layer: where                   read by
  ---------------  -----------------------------  -----------------------
  setup            api.run.simulate: build_engine setup_span_ms,
                   through the sinks' attach      device_idle_pct.setup
  setup.compile    SimulationEngine.__init__: the (set-up breakdown)
                   model to a ReactionSystem
  setup.tables     the device tables and rates    (set-up breakdown)
  setup.dispatch   the dispatch's operands bound  (set-up breakdown)
  setup.lanes      init_lanes; a farm shard's     (set-up breakdown)
                   key rows
  window           SimulationEngine.run_window    window_host_ms,
                                                  device_idle_pct.windows
  window.kernel    a shard body's window (the     (window breakdown)
                   kernel's launch or its twin);
                   a host-loop group's advance
  window.fold      observables, blocked Welford,  fold_span_ms_per_window
                   gathers (in the dispatch) and
                   the packed row (in the engine):
                   two spans a window
  window.pull      each blocking device-to-host   window_host_ms (taken
                   wait Telemetry.host_syncs      out of the window)
                   counts
  window.emit      _emit_row through stream.emit  (window breakdown)
                   (guards, the record, sinks)
  block.dispatch   _dispatch_block (supersteps)   device_idle_pct.windows
  block.collect    _collect_block (supersteps)    device_idle_pct.windows
  checkpoint       SimulationEngine.checkpoint    device_idle_pct.windows
  restore          SimulationEngine.restore       (inside setup on resume)

Idle time on the card under no `repro_torch.` span is read by
`device_idle_pct.outside`. The count of `repro_torch.window.pull`
spans equals the growth of `Telemetry.host_syncs`.
"""
from __future__ import annotations

import contextlib
import functools

import torch

SETUP = "repro_torch.setup"
SETUP_COMPILE = "repro_torch.setup.compile"
SETUP_TABLES = "repro_torch.setup.tables"
SETUP_DISPATCH = "repro_torch.setup.dispatch"
SETUP_LANES = "repro_torch.setup.lanes"
WINDOW = "repro_torch.window"
WINDOW_KERNEL = "repro_torch.window.kernel"
WINDOW_FOLD = "repro_torch.window.fold"
WINDOW_PULL = "repro_torch.window.pull"
WINDOW_EMIT = "repro_torch.window.emit"
BLOCK_DISPATCH = "repro_torch.block.dispatch"
BLOCK_COLLECT = "repro_torch.block.collect"
CHECKPOINT = "repro_torch.checkpoint"
RESTORE = "repro_torch.restore"

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that records `name` on a running profiler's trace, or
    does nothing (the one shared null context) when none runs."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorate a method so that each call, whole, runs in `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
