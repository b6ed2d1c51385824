"""Streaming analytics over the simulation record stream; port of
`repro/stats`.

Device-side sketches (fixed-bin histograms, rare-event threshold
counters) computed per window beside the Welford records, plus the
host-side estimators (quantiles, bimodality) the steering layer reads.
All merges are integer sums, so sketches are the same bits for any
superstep width and dispatch path.
"""
from repro_torch.stats.sketch import (
    SketchParams,
    SketchSpec,
    WindowSketch,
    bimodality_from_hist,
    quantiles_from_hist,
    window_sketch,
)

__all__ = [
    "SketchParams", "SketchSpec", "WindowSketch",
    "bimodality_from_hist", "quantiles_from_hist", "window_sketch",
]
