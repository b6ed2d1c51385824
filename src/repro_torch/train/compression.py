"""int8 quantisation with error feedback; port of the one-device half
of `repro/train/compression.py`.

`quantize_int8` is per-tensor symmetric int8, bit for bit the
reference's (an IEEE division and round-half-to-even in both).
`compressed_psum`, the error-feedback all-reduce over a mesh axis, needs
a process group: ROADMAP queue 1 item 18d.
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


def init_error(tree: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), tree)
