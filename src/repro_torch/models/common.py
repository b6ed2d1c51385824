"""Spec-first parameter machinery; port of `repro/models/common.py`.

Every module declares its parameters as a tree of `ParamDef`s (shape +
logical axes + initializer), so the parameters, their byte count and
their names all derive from the same tree.

On a mesh of more than one device every leaf is a `Placed`: its parts by
the leaf's `param_shardings` spec. `place_params` and `whole_params`
carry a tree of whole leaves to parts and back (checkpoints, interop);
`gathered` is a parameter with its FSDP axis gathered, right before its
use; `row_parallel` is the product whose contraction is split over
`model`, followed by its `psum`.

The reference's products emit the input dtype with float32 accumulation,
or float32 where they ask for it. `matmul` and `einsum` do the same:
torch's products accumulate in float32 and emit the input dtype; a
float32 result from lower-precision inputs is the float32 product of
the upcast inputs (a product of two bf16 values is exact in float32),
and on the card the float32-output product of the inputs themselves.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.sharding import collectives as col
from repro_torch.sharding.collectives import Placed, reshard
from repro_torch.sharding.rules import LAYERS

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple[Optional[str], ...]
    init: str = "fan_in"  # fan_in | zeros | ones | normal | embed
    scale: float = 1.0
    dtype: Optional[Any] = None  # override model dtype (e.g. fp32 gates)

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"ParamDef shape {self.shape} and logical "
                             f"axes {self.logical} differ in rank")

    def stacked(self, n: int) -> "ParamDef":
        return dataclasses.replace(
            self, shape=(n, *self.shape), logical=(LAYERS, *self.logical))


ParamTree = Any  # nested dict / list of tensors
DefTree = Any  # nested dict / list of ParamDef


def flatten_defs(defs: DefTree, prefix: str = "") -> list[tuple[str, ParamDef]]:
    """(dotted name, ParamDef) of every leaf, dict keys in sorted order
    (the order `jax.tree.flatten` visits them); list entries are named
    by their index."""
    if isinstance(defs, ParamDef):
        return [(prefix, defs)]
    items = (sorted(defs.items()) if isinstance(defs, dict)
             else [(str(i), d) for i, d in enumerate(defs)])
    out = []
    for k, d in items:
        out.extend(flatten_defs(d, f"{prefix}.{k}" if prefix else k))
    return out


def init_one(d: ParamDef, default_dtype, generator: torch.Generator,
             device) -> torch.Tensor:
    """One leaf by the reference's rules (`_init_one`): zeros, ones,
    N(0, scale) for "normal" and "embed", and N(0, scale/sqrt(fan_in))
    for "fan_in" with fan_in the second-to-last dimension (the last of a
    1-D leaf), drawn in float32 from `generator`, then cast."""
    dtype = d.dtype or default_dtype
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init in ("normal", "embed"):
        std = d.scale
    elif d.init == "fan_in":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / np.sqrt(max(1, fan_in))
    else:
        raise ValueError(f"unknown init {d.init}")
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x.mul_(float(std))).to(dtype)


def init_params(defs: DefTree, dtype_name: str, generator: torch.Generator,
                device) -> ParamTree:
    """Materialise a DefTree into tensors on `device`, the leaves drawn
    in `flatten_defs` order from one explicit generator (which must live
    on `device`). The bits are torch's, not `jax.random`'s: weights cross
    between the packages through `interop.lm_params_from_reference`."""
    default_dtype = DTYPES[dtype_name]
    leaves = {name: init_one(d, default_dtype, generator, device)
              for name, d in flatten_defs(defs)}

    def build(node, prefix):
        if isinstance(node, ParamDef):
            return leaves[prefix]
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in node.items()}
        return [build(v, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(node)]

    return build(defs, "")


def param_shardings(defs: DefTree, topo) -> Any:
    """Each ParamDef's `NamedSharding` on the topology's mesh (its
    logical axes resolved with fsdp=True), in the DefTree's structure."""
    if isinstance(defs, ParamDef):
        return topo.named(defs.logical, fsdp=True, shape=defs.shape)
    if isinstance(defs, dict):
        return {k: param_shardings(v, topo) for k, v in defs.items()}
    return [param_shardings(v, topo) for v in defs]


def place_params(tree, shardings) -> Any:
    """A tree of whole leaves placed by a tree of `NamedSharding`s of
    its structure: each leaf as the parts of its spec (views where a
    part's device is the leaf's)."""
    if isinstance(tree, dict):
        return {k: place_params(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place_params(v, sh) for v, sh in zip(tree, shardings)]
    return Placed.place(tree, shardings.spec, shardings.mesh)


def whole_params(tree, device=None) -> Any:
    """A tree's `Placed` leaves joined into whole tensors (on `device`,
    default each mesh's first device); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: whole_params(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [whole_params(v, device) for v in tree]
    return tree.whole(device) if isinstance(tree, Placed) else tree


def gathered(p: Placed, topo) -> Placed:
    """A parameter with its FSDP axis gathered (`all_gather` over
    `data`): the layout its layer computes in. GSPMD gathers an FSDP
    parameter right before its use; so does each layer here, and the
    gathered tensor is freed with the layer's locals."""
    ax = topo.fsdp_axis
    if ax is None or ax not in p.spec:
        return p
    return reshard(p, tuple(None if a == ax else a for a in p.spec))


def gathered_tree(tree: dict, topo) -> tuple[list, dict]:
    """A dict of parameters gathered (`gathered`): (one dict of parts a
    mesh position, the dict of gathered `Placed`s). Positions whose
    parts are all the same tensors get the same dict, so
    `collectives.each` runs their body once."""
    flat = {k: gathered(v, topo) for k, v in tree.items()}
    out, seen = [], {}
    for i in range(topo.n_devices):
        key = tuple(id(v[i]) for v in flat.values())
        if key not in seen:
            seen[key] = {k: v[i] for k, v in flat.items()}
        out.append(seen[key])
    return out, flat


def row_parallel(subs: str, x: list, w: Placed, topo, out_spec,
                 scatter_dim: Optional[int] = None) -> Placed:
    """`einsum_out(subs, x_i, w_i)` at every position, then one `psum`
    over the mesh axis that splits w's first dimension (the contraction),
    or one `reduce_scatter` along `scatter_dim` where the output stays
    split there (sequence parallelism). Each shard's partial is rounded
    to the input dtype before the sum, as the reference's `einsum_out`
    partials are (GSPMD all-reduces bf16 partials): never summed in
    float32 and rounded after."""
    ys = col.each(lambda a, b: einsum_out(subs, a, b), x, w)
    ax = w.spec[0]
    spec = list(out_spec)
    if ax is not None:
        if scatter_dim is not None:
            ys = col.reduce_scatter(ys, topo.mesh, ax, scatter_dim)
            spec[scatter_dim] = ax
        else:
            ys = col.psum(ys, topo.mesh, ax)
    return Placed(ys, tuple(spec), topo.mesh)


def param_bytes(defs: DefTree, dtype_name: str) -> int:
    dt = DTYPES[dtype_name]
    total = 0
    for _, d in flatten_defs(defs):
        itemsize = torch.empty((), dtype=d.dtype or dt).element_size()
        total += int(np.prod(d.shape)) * itemsize
    return total


# ---------------------------------------------------------------------------
# numerics helpers
# ---------------------------------------------------------------------------


class _F32Product(torch.autograd.Function):
    """x @ w of two lower-precision operands as one float32-output
    product (`torch.mm` / `torch.bmm` with `out_dtype`, which has no
    derivative of its own). The backward rounds the float32 cotangent to
    the operands' dtype and emits each gradient in it (float32
    accumulation): the reference's transpose keeps the cotangent in
    float32 instead, so bf16 gradients may differ from its by a
    rounding; float32 operands never reach this product."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if w.ndim == 2:
            y = torch.mm(x.reshape(-1, x.shape[-1]), w,
                         out_dtype=torch.float32)
            return y.reshape(*x.shape[:-1], w.shape[-1])
        return torch.bmm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.to(x.dtype)
        gx = gw = None
        if w.ndim == 2:
            g2 = gy.reshape(-1, gy.shape[-1])
            if ctx.needs_input_grad[0]:
                gx = (g2 @ w.T).reshape(x.shape)
            if ctx.needs_input_grad[1]:
                gw = x.reshape(-1, x.shape[-1]).T @ g2
        else:
            if ctx.needs_input_grad[0]:
                gx = torch.bmm(gy, w.transpose(1, 2))
            if ctx.needs_input_grad[1]:
                gw = torch.bmm(x.transpose(1, 2), gy)
        return gx, gw


def matmul(x, w, dtype=None):
    """x @ w emitting `dtype` (default: x's dtype), accumulated in
    float32. w is (K, N), or (E, K, N) against x (E, M, K): the experts'
    batched products. A float32 result from lower-precision inputs is
    one float32-output product on the card (`_F32Product`,
    differentiable) and the product of the upcast inputs on the CPU,
    which has no such product."""
    out = dtype or x.dtype
    if out == x.dtype:
        return x @ w
    if x.is_cuda and (w.ndim == 2 or (w.ndim == 3 and x.ndim == 3)):
        return _F32Product.apply(x, w)
    return x.to(out) @ w.to(out)


def einsum_out(subs, *args):
    """`einsum` at the input dtype: the products whose partials a `psum`
    adds (the reference's `einsum_out`)."""
    return einsum(subs, *args)


def einsum(subs, *args, dtype=None):
    """Einsum emitting `dtype` (default: the first input's dtype).
    Pass dtype=torch.float32 only where downstream math needs wide
    outputs (logits, attention scores)."""
    out = dtype or args[0].dtype
    if any(a.dtype != out for a in args):
        args = tuple(a.to(out) for a in args)
    return torch.einsum(subs, *args)
