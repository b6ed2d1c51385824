"""Streaming sketches over the window record stream; port of
`repro/stats/sketch.py`.

The Welford records answer "what are the moments"; the sketches here
answer the distribution-shape and tail questions the steering layer
acts on — per (sweep point, observable):

* a fixed-bin histogram (`n_bins` equal-width bins over [lo, hi], with
  both overflow tails clamped into the edge bins), from which p10/p50/
  p90 quantile estimates and a bimodality flag are derived host-side;
* rare-event counters: how many instances sit at or above each
  configured threshold this window.

Every sketch is an int32 COUNT array and every merge is integer
addition — associative and commutative, so the counts do not depend on
the order the device adds them in, on `window_block` or on the dispatch
path.

Binning multiplies by the float32 reciprocal of the bin width
(`SketchParams.inv_width`), it does not divide. That is the reference
engine's arithmetic: its jitted sketch closes over the bin geometry as
constants, and XLA rewrites `(obs - lo) / width` as `(obs - lo) *
(1 / width)`. Where the reciprocal of `width` is inexact (hi = 1000
over 32 bins) the two give different bins for some values, and the
port's counts follow the engine's, not the eager division.

Quantiles are read off the histogram CDF host-side with linear
interpolation inside the holding bin, so their worst-case error is one
bin width.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

__all__ = [
    "SketchSpec", "SketchParams", "WindowSketch", "window_sketch",
    "quantiles_from_hist", "bimodality_from_hist",
]


@dataclass(frozen=True)
class SketchSpec:
    """What to sketch. Pure data — `resolve()` turns it into the
    per-observable bin geometry.

    n_bins: histogram bins per (point, observable); error of any
    histogram-derived quantile is bounded by one bin width.
    lo / hi: histogram support, a scalar (shared by every observable)
    or one value per observable. hi=None auto-scales per observable
    from the model's initial state: hi_j = max(8 * obs_j(t=0), 32).
    thresholds: rare-event levels; each window counts instances with
    obs >= threshold (same thresholds applied to every observable).
    """

    n_bins: int = 32
    lo: Union[float, Sequence[float]] = 0.0
    hi: Union[float, Sequence[float], None] = None
    thresholds: Sequence[float] = ()

    def validate(self) -> None:
        if self.n_bins < 2:
            raise ValueError(
                f"SketchSpec.n_bins must be >= 2, got {self.n_bins}")
        if self.hi is not None:
            lo = np.atleast_1d(np.asarray(self.lo, np.float64))
            hi = np.atleast_1d(np.asarray(self.hi, np.float64))
            if lo.shape[0] > 1 and hi.shape[0] > 1 \
                    and lo.shape[0] != hi.shape[0]:
                raise ValueError(
                    f"SketchSpec.lo/hi lengths disagree: "
                    f"{lo.shape[0]} vs {hi.shape[0]}")
            if np.any(np.broadcast_arrays(hi, lo)[0]
                      <= np.broadcast_arrays(hi, lo)[1]):
                raise ValueError("SketchSpec.hi must exceed lo")

    def resolve(self, obs0: np.ndarray) -> "SketchParams":
        """Bind the spec to a model: obs0 (n_obs,) is the observable
        vector at t=0 (used only when hi=None)."""
        self.validate()
        n_obs = int(np.asarray(obs0).shape[0])
        lo = np.broadcast_to(
            np.atleast_1d(np.asarray(self.lo, np.float32)),
            (n_obs,)).astype(np.float32)
        if self.hi is None:
            hi = np.maximum(8.0 * np.asarray(obs0, np.float32), 32.0)
            hi = np.maximum(hi, lo + 1.0).astype(np.float32)
        else:
            hi = np.broadcast_to(
                np.atleast_1d(np.asarray(self.hi, np.float32)),
                (n_obs,)).astype(np.float32)
        width = ((hi - lo) / self.n_bins).astype(np.float32)
        return SketchParams(
            lo=lo, width=width, n_bins=int(self.n_bins),
            thresholds=np.asarray(tuple(self.thresholds), np.float32),
            inv_width=(np.float32(1) / width).astype(np.float32))


class SketchParams(NamedTuple):
    """Resolved bin geometry (host numpy). lo/width/inv_width: (n_obs,)
    float32, inv_width the float32 reciprocal the binning multiplies
    by; thresholds: (n_thr,) (possibly empty — then no rare counters
    are produced)."""

    lo: np.ndarray
    width: np.ndarray
    n_bins: int
    thresholds: np.ndarray
    inv_width: np.ndarray

    @property
    def n_thr(self) -> int:
        return int(self.thresholds.shape[0])

    def edges(self) -> np.ndarray:
        """(n_obs, n_bins + 1) bin edges."""
        k = np.arange(self.n_bins + 1, dtype=np.float32)
        return self.lo[:, None] + self.width[:, None] * k[None, :]


class WindowSketch(NamedTuple):
    """One window's pulled sketch: hist (G, n_obs, n_bins) int32 and
    rare (G, n_obs, n_thr) int32 or None (no thresholds configured)."""

    hist: np.ndarray
    rare: Optional[np.ndarray]


def window_sketch(obs: torch.Tensor, gids: Optional[torch.Tensor],
                  n_groups: int, lo: torch.Tensor, inv_width: torch.Tensor,
                  n_bins: int, thresholds: Optional[torch.Tensor] = None):
    """Sketch one window's samples on obs's device: obs (I, n_obs) f32,
    gids (I,) integer group (sweep point) of each instance, or None for
    one group, lo and inv_width (n_obs,) f32. Returns (hist, rare): hist
    (n_groups, n_obs, n_bins) int32, rare (n_groups, n_obs, n_thr) int32
    or None when thresholds is None or empty.

    Values below lo land in bin 0, values at or above hi in bin
    n_bins - 1 (clamped tails: the histogram total always equals the
    group's instance count); a NaN lands in bin 0, as XLA converts it.
    Each (instance, observable) adds one to its flat slot
    (g * n_obs + o) * n_bins + b of one int32 count, and its row of
    threshold hits to row g * n_obs + o of the rare count, by
    `index_add_`; no host sync, and integer adds in any order give the
    same counts.
    """
    n_i, n_obs = obs.shape
    dev = obs.device
    obs = obs.to(torch.float32)
    b = torch.floor((obs - lo) * inv_width)
    b = torch.nan_to_num(b, nan=0.0).clamp_(0.0, float(n_bins - 1))
    row = torch.arange(n_obs, device=dev).expand(n_i, n_obs)
    if gids is not None:
        row = gids.to(torch.int64)[:, None] * n_obs + row
    one = torch.ones((), dtype=torch.int32, device=dev).expand(n_i * n_obs)
    hist = torch.zeros(n_groups * n_obs * n_bins, dtype=torch.int32,
                       device=dev).index_add_(
        0, (row * n_bins + b.to(torch.int64)).reshape(-1), one)
    hist = hist.reshape(n_groups, n_obs, n_bins)
    if thresholds is None or not thresholds.shape[0]:
        return hist, None
    n_thr = thresholds.shape[0]
    over = (obs[:, :, None] >= thresholds).to(torch.int32)
    rare = torch.zeros(n_groups * n_obs, n_thr, dtype=torch.int32,
                       device=dev).index_add_(
        0, row.reshape(-1), over.reshape(-1, n_thr))
    return hist, rare.reshape(n_groups, n_obs, n_thr)


# ------------------------------------------------------- host analysis
def quantiles_from_hist(hist: np.ndarray, lo, width,
                        qs=(0.1, 0.5, 0.9)) -> np.ndarray:
    """Histogram-CDF quantile estimates, deterministic numpy.

    hist: (..., n_obs, n_bins) int counts; lo/width: (n_obs,).
    Returns (..., n_obs, len(qs)) float64. The q-quantile is read off
    the inclusive bin CDF with linear interpolation inside the holding
    bin — error is bounded by one bin width for any distribution whose
    support lies inside [lo, hi] (tails are clamped into edge bins, so
    edge-bin estimates saturate at the support boundary).
    """
    hist = np.asarray(hist, np.float64)
    lo = np.asarray(lo, np.float64)
    width = np.asarray(width, np.float64)
    n_bins = hist.shape[-1]
    cdf = np.cumsum(hist, axis=-1)
    total = np.maximum(cdf[..., -1:], 1.0)
    out = np.empty(hist.shape[:-1] + (len(qs),), np.float64)
    for k, q in enumerate(qs):
        target = q * total[..., 0]
        j = np.sum(cdf < target[..., None], axis=-1)
        j = np.minimum(j, n_bins - 1)
        below = np.take_along_axis(
            np.concatenate([np.zeros_like(cdf[..., :1]), cdf], axis=-1),
            j[..., None], axis=-1)[..., 0]
        in_bin = np.take_along_axis(hist, j[..., None], axis=-1)[..., 0]
        frac = np.where(in_bin > 0, (target - below)
                        / np.maximum(in_bin, 1.0), 0.5)
        out[..., k] = lo + width * (j + np.clip(frac, 0.0, 1.0))
    return out


def bimodality_from_hist(hist: np.ndarray, min_frac: float = 0.1,
                         valley_frac: float = 0.5) -> np.ndarray:
    """Deterministic two-peak test on (..., n_bins) int histograms.

    Flags a histogram as bimodal when two local maxima, each holding
    >= min_frac of the total mass after 3-bin box smoothing, are
    separated by a valley whose depth is <= valley_frac x the smaller
    peak. Returns a (...,) bool array. Integer-exact inputs + fixed
    float ops -> the same flag on every dispatch path.
    """
    h = np.asarray(hist, np.float64)
    sm = h.copy()
    sm[..., 1:-1] = (h[..., :-2] + h[..., 1:-1] + h[..., 2:]) / 3.0
    total = np.maximum(h.sum(axis=-1), 1.0)

    flat = sm.reshape(-1, sm.shape[-1])
    tot = total.reshape(-1)
    out = np.zeros(flat.shape[0], bool)
    for i in range(flat.shape[0]):
        row = flat[i]
        peaks = [j for j in range(row.shape[0])
                 if row[j] >= min_frac * tot[i]
                 and (j == 0 or row[j] >= row[j - 1])
                 and (j == row.shape[0] - 1 or row[j] > row[j + 1])]
        for a in range(len(peaks)):
            for b in range(a + 1, len(peaks)):
                lo_p, hi_p = peaks[a], peaks[b]
                if hi_p - lo_p < 2:
                    continue
                valley = row[lo_p + 1:hi_p].min()
                if valley <= valley_frac * min(row[lo_p], row[hi_p]):
                    out[i] = True
    return out.reshape(sm.shape[:-1])
