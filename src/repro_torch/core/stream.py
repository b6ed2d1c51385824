"""Random numbers in, statistics out (port of `repro/core/stream.py`).

IN: every lane consumes a counter-based stream. Draw n of lane (k0, k1)
is threefry2x32 applied to the 64-bit counter block (n_lo, n_hi) under
key (k0, k1), so a draw is a pure function of (lane key, event index):
the CUDA kernel, the plain torch path, any chunk size and a resumed run
all consume the identical stream, bit for bit with the reference.

torch has no uint32 add, shift or compare, so the functions here carry
32-bit words as int64 tensors holding values in [0, 2^32) and mask
after every add. `LaneState` stores the words as int32 bit patterns
(`to_words` / `from_words` convert).

OUT: `StatsRecord`s flow to attached sinks; `CsvSink` writes rows
incrementally and is closed when a run completes.
"""
from __future__ import annotations

import collections
import csv
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

#: uniforms are clamped to [U_MIN, 1) so -log(u) stays finite
U_MIN = 1e-12
_U_MIN_F32 = float(np.float32(U_MIN))

MASK32 = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def to_words(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 words in [0, 2^32)."""
    return bits.to(torch.int64) & MASK32


def from_words(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 bit patterns."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, c0, c1):
    """One threefry2x32 block (20 rounds): counter (c0, c1) under key
    (k0, k1). Arguments are int64 words of one broadcastable shape;
    returns two int64 words of random bits."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & MASK32
    x1 = (c1 + ks[1]) & MASK32
    for block in range(5):
        rots = _ROT[:4] if block % 2 == 0 else _ROT[4:]
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK32
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & MASK32
    return x0, x1


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Random words -> float32 uniform on [U_MIN, 1): the top 23 bits
    become the mantissa of a float in [1, 2), shifted down to [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, _U_MIN_F32)


def counter_uniforms(k0, k1, ctr, ctr_hi=None):
    """(u1, u2) for event index (ctr_hi, ctr) of the lane streams keyed
    (k0, k1); all int64 words. One block gives both uniforms an SSA
    event consumes."""
    if ctr_hi is None:
        ctr_hi = torch.zeros_like(ctr)
    b0, b1 = threefry2x32(k0, k1, ctr, ctr_hi)
    return bits_to_uniform(b0), bits_to_uniform(b1)


def ctr_add(ctr, ctr_hi, inc):
    """64-bit counter bump as two words: lo += inc with carry into hi.
    `inc` < 2^32, so the wrap test is one unsigned compare."""
    lo = (ctr + inc) & MASK32
    return lo, (ctr_hi + (lo < ctr).to(torch.int64)) & MASK32


def lane_keys(seed: int, n: int, device=None) -> torch.Tensor:
    """(n, 2) int32 per-lane keys, equal to the reference's
    `jax.random.split(jax.random.PRNGKey(seed), n)` table through the
    identity split(PRNGKey(s), n)[i] == threefry2x32((s >> 32,
    s & 0xFFFFFFFF), (0, i))."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    i = torch.arange(n, dtype=torch.int64, device=device)
    k0 = torch.full_like(i, seed >> 32)
    k1 = torch.full_like(i, seed & MASK32)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return from_words(torch.stack([b0, b1], dim=1))


# ----------------------------------------------------------- records
@dataclass
class StatsRecord:
    t: float
    window: int
    mean: np.ndarray  # (n_obs,)
    var: np.ndarray
    ci90: np.ndarray
    n: float


class StatsStream:
    """Push-based record stream with bounded drop-oldest buffering."""

    def __init__(self, maxlen: int = 100_000):
        self.buffer: collections.deque = collections.deque(maxlen=maxlen)
        self.sinks: list[Callable[[StatsRecord], None]] = []
        self.dropped = 0

    def attach(self, sink: Callable[[StatsRecord], None]) -> None:
        self.sinks.append(sink)

    def emit(self, rec: StatsRecord) -> None:
        if len(self.buffer) == self.buffer.maxlen:
            self.dropped += 1
        self.buffer.append(rec)
        for s in self.sinks:
            s(rec)

    def records(self) -> list[StatsRecord]:
        return list(self.buffer)

    def close(self) -> None:
        """Close every sink that has a close() lifecycle."""
        for s in self.sinks:
            close = getattr(s, "close", None)
            if callable(close):
                close()


class CsvSink:
    """Incremental CSV writer for the stats stream: one open handle per
    run, flushed on close(). Same columns and number formats as the
    reference's sink, so the two packages write identical files for
    identical records."""

    def __init__(self, path: str, obs_names: list[str]):
        self.path = path
        self.obs_names = list(obs_names)
        self._f = open(path, "w", newline="")
        self._w = csv.writer(self._f)
        header = ["t", "n"]
        for n in self.obs_names:
            header += [f"{n}_mean", f"{n}_var", f"{n}_ci90"]
        self._w.writerow(header)
        self.closed = False

    def __call__(self, rec: StatsRecord) -> None:
        if self.closed:
            raise ValueError(f"CsvSink({self.path!r}) is closed")
        row = [f"{rec.t:.6g}", f"{rec.n:.0f}"]
        for i in range(len(self.obs_names)):
            row += [f"{rec.mean[i]:.6g}", f"{rec.var[i]:.6g}",
                    f"{rec.ci90[i]:.6g}"]
        self._w.writerow(row)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._f.flush()
            self._f.close()

    def __enter__(self) -> "CsvSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
