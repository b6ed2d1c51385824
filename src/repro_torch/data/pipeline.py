"""Synthetic token pipeline; port of `repro/data/pipeline.py`, in numpy
and bit for bit the reference's batches.

Deterministic per (seed, step): any replica can regenerate any batch,
so the data cursor of a restarted run is just the step index (no reader
state to recover). Prefetch runs in a background thread with a bounded
double buffer, so making the next batch overlaps the device step.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2  # skewed token distribution (realistic softmax load)


def synth_batch(cfg: ModelConfig, batch: int, seq: int, step: int,
                dcfg: DataConfig = DataConfig()) -> dict:
    """Deterministic synthetic LM batch for a given step index."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [dcfg.seed, step, 0xB10B]))
    v = cfg.vocab_size
    toks = rng.zipf(dcfg.zipf_a, size=(batch, seq + 1)).astype(np.int64)
    toks = (toks - 1) % v
    out: dict = {}
    if cfg.frontend == "vision":
        p = cfg.frontend_tokens
        out["embeds"] = rng.standard_normal(
            (batch, p, cfg.d_model)).astype(np.float32)
        out["tokens"] = toks[:, :seq - p].astype(np.int32)
        out["targets"] = toks[:, 1:seq + 1].astype(np.int32)
        mask = np.ones((batch, seq), np.float32)
        mask[:, :p] = 0.0  # no loss on image positions
        out["loss_mask"] = mask
    else:
        out["tokens"] = toks[:, :seq].astype(np.int32)
        out["targets"] = toks[:, 1:].astype(np.int32)
        out["loss_mask"] = np.ones((batch, seq), np.float32)
    return out


class PrefetchPipeline:
    """Bounded background prefetch (depth-2 double buffer by default)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 start_step: int = 0, depth: int = 2,
                 dcfg: DataConfig = DataConfig()):
        self.cfg, self.batch, self.seq, self.dcfg = cfg, batch, seq, dcfg
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            b = synth_batch(self.cfg, self.batch, self.seq, step, self.dcfg)
            b["_step"] = step
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> dict:
        return self._q.get()

    def __iter__(self) -> Iterator[dict]:
        return self

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
