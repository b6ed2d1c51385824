"""int8 compressed all-reduce with error feedback; port of
`repro/train/compression.py`.

`quantize_int8` is per-tensor symmetric int8, bit for bit the
reference's (an IEEE division and round-half-to-even in both).
`compressed_psum` is the error-feedback all-reduce over a mesh axis
(Seide et al. / EF21 style): each shard quantises its contribution plus
its error buffer to int8, keeps the rounding error for its next call,
and the dequantised values are summed (`collectives.psum`: along the
axis from index 0 up). The data-parallel step
(`train/step.py::make_dp_train_step`) reduces its gradients with the
same arithmetic, shard by shard (`error_feedback`).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_map


def quantize_int8(x):
    """Per-tensor symmetric int8. Returns (q, scale)."""
    scale = torch.clamp_min(
        torch.max(torch.abs(x)) / torch.tensor(127.0, dtype=x.dtype,
                                               device=x.device), 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def error_feedback(x, error):
    """One shard's half of `compressed_psum`: (the dequantised int8 of
    x + error, the new error)."""
    corrected = x + error
    q, scale = quantize_int8(corrected)
    deq = q.to(torch.float32) * scale
    return deq, corrected - deq


def compressed_psum(parts: list, errors: list, mesh, axis) -> tuple:
    """Error-feedback int8 psum over a mesh axis. parts: each position's
    float32 contribution; errors: each position's float32 accumulator of
    the same shape. Returns (the psum on each position, the new error of
    each position)."""
    from repro_torch.sharding.collectives import psum

    red = [error_feedback(x, e) for x, e in zip(parts, errors)]
    return psum([deq for deq, _ in red], mesh, axis), [e for _, e in red]


def init_error(tree: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), tree)
