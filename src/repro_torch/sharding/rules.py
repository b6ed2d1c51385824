"""Logical-axis sharding rules → mesh layouts; port of
`repro/sharding/rules.py`.

The model code names the axes of every parameter and activation
("embed", "ffn", "q_heads", ...). A `Topology` resolves these names to
mesh axes according to the `ShardingConfig` strategy, the mesh shape
and the arch's divisibility (a dimension that does not divide its mesh
axis is replicated), line for line as the reference's does.

A `Mesh` is the port's `jax.sharding.Mesh`: axis names and an object
array of `torch.device`s of the mesh's shape. Its devices may repeat:
four entries of cuda:0 are a four-shard mesh on one card, and four
entries of cpu one on the CPU. The multi-device paths run in one
process over such a mesh, each shard's body in mesh order, with the
collectives of `sharding/collectives.py` between them (the reference is
single-controller too). `spec` returns a tuple of mesh axes (a name, a
tuple of names, or None) per dimension: the `PartitionSpec` analogue.

What a spec places. On a mesh of more than one device every parameter
of a `CausalLM` is held as the parts `param_shardings` gives
(`collectives.Placed`: views of one tensor on repeated devices, copies
on distinct ones), and the dense layers run on those parts as GSPMD
runs the reference's: tensor parallelism over `model` (column-parallel
projections, row-parallel ones followed by a `psum`, a vocab-parallel
embedding and head), FSDP over `data` (a parameter gathered right
before its use, its gradient reduce-scattered back) and the batch over
the data axes. `constrain` puts an activation into the layout its
logical axes give (by splitting, gathering or leaving its parts as they
are); a dimension its axis does not divide stays whole, as `_divides`
replicates it in the rules. The MoE experts, the sequence-sharded KV
cache, the data-parallel step's batch and a restored checkpoint's
leaves are placed the same way. Parameters live as parts, so nothing
splits a whole parameter at each call: the per-topology cache of split
expert weights that stood here is gone, and a whole tensor handed to a
multi-device function (a test's, or an oracle's) is split at the call,
as views where its device is the part's.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import MeshSpec, ModelConfig, ShardingConfig
from repro_torch.core.device import resolve_device
from repro_torch.sharding.collectives import Placed, reshard

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
INNER = "inner"  # state-space/recurrent mixer d_inner (retired archs)
STATE = "state"  # ssm state dim
CONV = "conv"
LAYERS = "layers"  # stacked layer axis
# activations
BATCH = "batch"
SEQ = "seq"
KV_SEQ = "kv_seq"  # decode-cache sequence axis


@dataclass(frozen=True, eq=False)
class Mesh:
    """Axis names and a device array of the mesh's shape (row-major:
    the last axis varies fastest, as `jax.make_mesh` lays devices)."""

    axis_names: tuple[str, ...]
    devices: np.ndarray  # object array of torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> list[torch.device]:
        """The devices in row-major mesh order (repeats kept)."""
        return list(self.devices.reshape(-1))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Sequence) -> Mesh:
    devs = [resolve_device(d) for d in devices]
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(tuple(axes), arr.reshape(tuple(shape)))


def make_mesh_from_spec(spec: MeshSpec, devices: Optional[Sequence] = None
                        ) -> Mesh:
    """The mesh of `spec` over `devices` (default: every visible CUDA
    device; a list may repeat a device, which is how a four-shard mesh
    runs on one card or on the CPU). Raises ValueError with fewer
    devices than the mesh needs, as the reference does."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = list(devices)
    need = spec.n_devices
    if len(devs) < need:
        raise ValueError(f"mesh {spec.shape} needs {need} devices, have "
                         f"{len(devs)}")
    return make_mesh(spec.shape, spec.axes, devs[:need])


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the port's `jax.sharding.NamedSharding`)."""

    mesh: Mesh
    spec: tuple


@dataclass(frozen=True)
class Topology:
    """Binds a mesh + model + sharding strategy; resolves logical axes."""

    mesh: Mesh
    model: ModelConfig
    sharding: ShardingConfig

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        """The mesh's first device: where whole values (a served model's
        logits, a scalar loss) are joined."""
        return self.mesh.devices.reshape(-1)[0]

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @cached_property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.mesh.axis_names, self.mesh.devices.shape))

    @property
    def data_axes(self) -> tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.axis_sizes)

    @property
    def model_axis(self) -> Optional[str]:
        return "model" if "model" in self.axis_sizes else None

    @property
    def dp_size(self) -> int:
        out = 1
        for a in self.data_axes:
            out *= self.axis_sizes[a]
        return out

    @property
    def tp_size(self) -> int:
        return self.axis_sizes.get("model", 1)

    def _divides(self, dim: int, axes) -> bool:
        size = 1
        for a in axes if isinstance(axes, tuple) else (axes,):
            size *= self.axis_sizes.get(a, 1)
        return dim % size == 0 and dim >= size

    # ------------------------------------------------------------------
    @cached_property
    def rules(self) -> dict[str, object]:
        """logical name -> mesh axis (str | tuple | None)."""
        m = self.model
        tp = self.model_axis

        r: dict[str, object] = {
            VOCAB: tp if self._divides(m.padded_vocab, tp) else None,
            EMBED: None,
            FFN: tp if m.d_ff and self._divides(m.d_ff, tp) else None,
            Q_HEADS: tp if self._divides(m.n_heads, tp) else None,
            KV_HEADS: tp if self._divides(m.n_kv_heads, tp) else None,
            HEAD_DIM: None,
            EXPERTS: None,
            EXPERT_FFN: None,
            INNER: tp if self._divides(m.d_inner, tp) else None,
            STATE: None,
            CONV: None,
            LAYERS: None,
            BATCH: (self.data_axes if len(self.data_axes) > 1
                    else (self.data_axes[0] if self.data_axes else None)),
            SEQ: None,
            KV_SEQ: None,
        }
        if m.n_experts:
            moe_ff = m.moe_d_ff or m.d_ff
            if self.sharding.expert_parallel and self._divides(m.n_experts,
                                                               tp):
                r[EXPERTS] = tp
                r[EXPERT_FFN] = None
            elif self._divides(moe_ff, tp):
                r[EXPERTS] = None
                r[EXPERT_FFN] = tp
        if self.sharding.seq_sharded_kv:
            ax = self.sharding.kv_seq_axis
            if ax in self.axis_sizes:
                r[KV_SEQ] = ax
                if ax == "data":
                    # long-context decode at batch 1: batch unshardable
                    r[BATCH] = None
        if self.sharding.seq_sharded_activations:
            r[SEQ] = tp
        return r

    @cached_property
    def fsdp_axis(self) -> Optional[str]:
        """FSDP: params get this extra axis on their largest free dim."""
        if self.sharding.strategy == "fsdp_tp" and "data" in self.axis_sizes:
            return "data"
        return None

    # ------------------------------------------------------------------
    def spec(self, logical: Sequence[Optional[str]], *, fsdp: bool = False,
             shape: Optional[Sequence[int]] = None) -> tuple:
        """Resolve logical axes to a spec (one entry a dimension).

        With fsdp=True (parameters), additionally shard the largest
        still-replicated dim over the `data` axis when divisible.
        """
        phys = []
        used: set[str] = set()
        for name in logical:
            ax = self.rules.get(name) if name else None
            if ax is None:
                phys.append(None)
                continue
            axs = ax if isinstance(ax, tuple) else (ax,)
            if any(a in used for a in axs):
                phys.append(None)
                continue
            used.update(axs)
            phys.append(ax)
        if (fsdp and self.fsdp_axis and self.fsdp_axis not in used
                and shape is not None):
            # choose the largest unsharded, divisible dim
            best, best_size = -1, 0
            for i, (p_ax, dim) in enumerate(zip(phys, shape)):
                if (p_ax is None and dim % self.axis_sizes[self.fsdp_axis]
                        == 0 and dim > best_size):
                    best, best_size = i, dim
            if best >= 0:
                phys[best] = self.fsdp_axis
        return tuple(phys)

    def named(self, logical: Sequence[Optional[str]], **kw) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical, **kw))

    def act_spec(self, logical: Sequence[Optional[str]],
                 shape: Sequence[int]) -> tuple:
        """An activation's spec: `spec(logical)` with each dimension its
        axis does not divide left whole (a decode step's one position
        over `model`, a batch smaller than the data axes)."""
        return tuple(ax if ax is not None and self._divides(n, ax) else None
                     for ax, n in zip(self.spec(logical), shape))

    def constrain(self, x, *logical: Optional[str]):
        """`with_sharding_constraint` by logical axes: x (a `Placed`, or
        a whole tensor) in the layout `act_spec` gives; the identity on
        a one-device mesh."""
        if self.n_devices == 1:
            return x
        spec = self.act_spec(logical, x.shape)
        if isinstance(x, Placed):
            return reshard(x, spec)
        return Placed.place(x, spec, self.mesh)


def smoke_topology(model: ModelConfig, sharding: ShardingConfig | None = None,
                   device=None) -> Topology:
    """The 1 x 1 ("data", "model") topology on `device` (default: the
    CUDA device; pass device="cpu" for the CPU)."""
    mesh = make_mesh((1, 1), ("data", "model"), [resolve_device(device)])
    return Topology(mesh, model, sharding or ShardingConfig(strategy="dp_tp"))
