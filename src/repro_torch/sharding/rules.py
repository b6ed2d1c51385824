"""Logical axis names and the one-device topology; port of the
single-device half of `repro/sharding/rules.py`.

The model code names the axes of every parameter and activation
("embed", "ffn", "q_heads", ...) so that a layout can be derived from
them (the names of the retired state-space archs are left out). The
port runs a model on one device: its `Topology` holds that device, and
`constrain` returns its argument. Meshes and the multi-device rules
(`make_mesh_from_spec`, the per-axis placement) are ROADMAP queue 1
item 18d.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShardingConfig
from repro_torch.core.device import resolve_device

# Logical axis vocabulary ----------------------------------------------------
# params
VOCAB = "vocab"
EMBED = "embed"  # d_model
FFN = "ffn"  # MLP intermediate
Q_HEADS = "q_heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
EXPERTS = "experts"
EXPERT_FFN = "expert_ffn"
LAYERS = "layers"  # stacked layer axis
# activations
BATCH = "batch"
SEQ = "seq"
KV_SEQ = "kv_seq"  # decode-cache sequence axis


@dataclass(frozen=True)
class Topology:
    """One device, the model and its sharding strategy."""

    device: torch.device
    model: ModelConfig
    sharding: ShardingConfig

    @property
    def n_devices(self) -> int:
        return 1

    def constrain(self, x, *logical: Optional[str]):
        """A layout constraint by logical axes: nothing to place on one
        device, so x is returned as it is."""
        return x


def smoke_topology(model: ModelConfig, sharding: ShardingConfig | None = None,
                   device=None) -> Topology:
    """The one-device topology on `device` (default: the CUDA device;
    pass device="cpu" for the CPU)."""
    return Topology(resolve_device(device), model,
                    sharding or ShardingConfig(strategy="dp_tp"))
