"""The `--trace 1` run's profiler trace, reduced to what the per-layer
readers and the result's breakdown need.

`torch.profiler` records the host's operations, the benchmark's own
spans (`record_function`) and, on the card, every kernel, copy and set.
Only the raw events are read (no per-event Python objects are built), in
nanoseconds on the profiler's clock.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, replace

import numpy as np

#: the spans: the measured window, a job's set-up, each of its windows,
#: and the check's copy of a drawn job's lanes (off the window's clock)
WINDOW_SPAN = "portbench.window"
SETUP_SPAN = "portbench.job_setup"
WINDOWS_SPAN = "portbench.windows"
CHECK_SPAN = "portbench.check_copy"


def profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


@contextmanager
def span(name: str):
    import torch

    with torch.profiler.record_function(name):
        yield


def base_name(name: str) -> str:
    """A device operation's name as the trace prints it, without a
    kernel's return type, namespaces, template and parameters
    ("void at::native::f<4>(int)" -> "f"; "Memcpy DtoH (...)" ->
    "Memcpy DtoH")."""
    n = name.replace("(anonymous namespace)::", "")
    n = n[5:] if n.startswith("void ") else n
    for stop in "(<":
        n = n.split(stop)[0]
    n = n.strip().split("::")[-1]
    return n or name


@dataclass
class Trace:
    window: tuple  # (start, end) ns of the measured window
    dev_name: list  # device operations: name, start, end (ns)
    dev_start: np.ndarray
    dev_end: np.ndarray
    dev_corr: np.ndarray  # the launch's correlation id
    dev_index: np.ndarray  # the card
    host_name: list  # host operations and spans
    host_start: np.ndarray
    host_end: np.ndarray
    host_corr: np.ndarray  # the correlation id (a runtime call's links
    # it to the device operation it launched)
    cut: np.ndarray = None  # (k, 2) ns: the check's copies, off the clock

    def spans(self, name: str) -> np.ndarray:
        """(k, 2) ns of the host spans called `name`, by start."""
        out = np.asarray([(a, b) for n, a, b in zip(
            self.host_name, self.host_start, self.host_end) if n == name],
            np.int64).reshape(-1, 2)
        return out[np.argsort(out[:, 0], kind="stable")]

    @property
    def cut_ns(self) -> int:
        return int((self.cut[:, 1] - self.cut[:, 0]).sum())

    @property
    def window_s(self) -> float:
        """The window's seconds on its clock (the check's copies out)."""
        return (self.window[1] - self.window[0] - self.cut_ns) / 1e9

    def durations_s(self, kernel: str) -> np.ndarray:
        """Each launch's device seconds of the kernel named `kernel`."""
        sel = [i for i, n in enumerate(self.dev_name)
               if base_name(n) == kernel]
        return (self.dev_end[sel] - self.dev_start[sel]) / 1e9

    def devices(self) -> list:
        return sorted(set(self.dev_index.tolist()))

    def busy(self, device=None) -> np.ndarray:
        """The union of the device's operations and the check's copies
        inside the window, as (k, 2) intervals in ns (device: one card's,
        else every card's)."""
        lo, hi = self.window
        on = (np.ones(self.dev_index.shape, bool) if device is None
              else self.dev_index == device)
        s = np.clip(np.concatenate([self.dev_start[on], self.cut[:, 0]]),
                    lo, hi)
        e = np.clip(np.concatenate([self.dev_end[on], self.cut[:, 1]]),
                    lo, hi)
        order = np.argsort(s, kind="stable")
        out = []
        for a, b in zip(s[order], e[order]):
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return np.asarray(out, np.int64).reshape(-1, 2)

    def busy_s(self) -> float:
        """Seconds of the window with an operation on the card, averaged
        over the cards used."""
        per = [self.busy(d) for d in self.devices()] or [self.busy()]
        return float(np.mean([(b[:, 1] - b[:, 0]).sum() - self.cut_ns
                              for b in per])) / 1e9

    def launched_in(self, name: str) -> np.ndarray:
        """Per device operation: whether the host call that launched it
        (the runtime call of the same correlation id; without one, the
        operation itself) began inside a span called `name`."""
        spans = self.spans(name)
        launch = {int(c): int(a) for n, a, c in zip(
            self.host_name, self.host_start, self.host_corr)
            if c > 0 and n.startswith("cu")}  # the runtime's calls
        at = np.asarray([launch.get(int(c), int(s)) for c, s in
                         zip(self.dev_corr, self.dev_start)], np.int64)
        k = np.searchsorted(spans[:, 0], at, side="right") - 1
        return (k >= 0) & (at <= spans[np.maximum(k, 0), 1]) if len(
            spans) else np.zeros(at.shape, bool)

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        tot: dict = {}
        for n, a, b in zip(self.dev_name, self.dev_start, self.dev_end):
            tot[base_name(n)] = tot.get(base_name(n), 0) + int(b - a)
        return [[n, t / 1e9] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[what the host was doing, seconds] of the longest stretches of
        the window with nothing on the device: the innermost host
        operation or span under the gap's middle."""
        b = self.busy()
        lo, hi = self.window
        edges = np.concatenate([[lo], b.ravel(), [hi]]).reshape(-1, 2)
        gaps = sorted(((int(e - s), int(s), int(e)) for s, e in edges
                       if e > s), reverse=True)[:top]
        out = []
        for dur, s, e in gaps:
            mid = (s + e) // 2
            inside = np.nonzero((self.host_start <= mid)
                                & (self.host_end >= mid))[0]
            label = "no host operation"
            if inside.size:
                label = self.host_name[inside[np.argmax(
                    self.host_start[inside])]]
            out.append([label, dur / 1e9])
        return out


def collect(prof) -> Trace:
    """The raw events of a finished `profiler()`."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    for ev in events:
        if ev.device_type() == DeviceType.CUDA and (
                getattr(ev, "is_user_annotation", bool)()
                or ev.name().startswith("portbench.")):
            continue  # a span's copy on the device's timeline
        if hasattr(ev, "start_ns"):
            a, b = ev.start_ns(), ev.end_ns()
        else:
            a, b = ev.start_us() * 1000, (ev.start_us()
                                          + ev.duration_us()) * 1000
        corr = int(getattr(ev, "correlation_id", int)() or 0)
        if ev.device_type() == DeviceType.CUDA:
            dev.append((ev.name(), a, b, corr, int(ev.device_index())))
        else:
            host.append((ev.name(), a, b, corr))
    win = [(a, b) for n, a, b, _ in host if n == WINDOW_SPAN]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")

    def arrays(rows, width):
        return [[r[0] for r in rows]] + [
            np.asarray([r[i] for r in rows], np.int64).reshape(-1)
            for i in range(1, width)]

    tr = Trace(win[0], *arrays(dev, 5), *arrays(host, 4),
               cut=np.zeros((0, 2), np.int64))
    # the check's copies are the harness's own: off the device's lists
    # and off the window's clock
    keep = ~tr.launched_in(CHECK_SPAN)
    return replace(tr, cut=tr.spans(CHECK_SPAN),
                   dev_name=[n for n, k in zip(tr.dev_name, keep) if k],
                   **{f: getattr(tr, f)[keep] for f in (
                       "dev_start", "dev_end", "dev_corr", "dev_index")})


def summary(tr: Trace) -> dict:
    """What the run writes beside its result about the trace."""
    from portbench.roofline import kernels

    per_kernel = {}
    for k in (mod.KERNEL for mod in kernels().values()):
        d = tr.durations_s(k)
        if d.size:
            per_kernel[k] = dict(launches=int(d.size), total_s=float(d.sum()),
                                 p50_ms=float(np.percentile(d, 50) * 1e3),
                                 p95_ms=float(np.percentile(d, 95) * 1e3),
                                 max_ms=float(d.max() * 1e3))
    return dict(window_s=tr.window_s, busy_s=tr.busy_s(),
                device_events=len(tr.dev_name), host_events=len(tr.host_name),
                kernels=per_kernel, device_ops=tr.device_ops(20),
                idle_gaps=tr.idle_gaps(20))
