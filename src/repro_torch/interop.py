"""State exchange with the reference package, as plain numpy arrays.

The reference's tables and lane pool cross over as numpy arrays (its
keys and draw counters as uint32), so the two packages can be fed one
state without this package importing the other.

  system_arrays: {reactant_idx, reactant_coef, delta, rates, x0,
                  species_names, reaction_names} — `ReactionSystem`
                  fields
  pool_arrays:   {x, t, key, ctr, ctr_hi, steps, leaps, dead, no_leap}
                  — `LaneState` leaves

The LM skeleton's parameter and cache trees cross the same way: the
reference's nested dicts and lists of arrays (repeated layers stacked
on a leading axis under "stack"), named leaf for leaf as the port's
`CausalLM` names its parameters. bfloat16 leaves travel as their bits.
So does the trainer's state, {"params", "opt": AdamWState(step, mu, nu,
master)}.

Per-shard state crosses as the reference's per-device buffers (an
array's `addressable_shards`), keyed by each buffer's mesh position (an
index per mesh axis): `parts_from_reference` / `parts_to_reference` map
them to the port's parts (one a position, row-major) and back; the
data-parallel step's error buffers (one tree a shard) and a
sequence-sharded cache leaf (joined by its spec) have their own pair.
A placed tree (a mesh model's parameters, or its train state with
`Placed` parameters, `mu`, `nu` and `master`) crosses as {leaf path:
{mesh position: buffer}}, the reference's `addressable_shards` of each
leaf: `placed_tree_from_reference` / `placed_tree_to_reference`, bit
for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.gillespie import LaneState
from repro_torch.core.reactions import ReactionSystem
from repro_torch.sharding.collectives import (
    Placed,
    positions,
    shard,
    slice_key,
    unshard,
)
from repro_torch.tree import (
    tree_flatten_with_path,
    tree_map,
    tree_unflatten_like,
)

SYSTEM_FIELDS = ("reactant_idx", "reactant_coef", "delta", "rates", "x0",
                 "species_names", "reaction_names")
_WORDS = ("key", "ctr", "ctr_hi")  # uint32 in the reference


def from_reference(system_arrays: dict, pool_arrays: dict, device=None
                   ) -> tuple[ReactionSystem, LaneState]:
    """The port's (ReactionSystem, LaneState) from the reference's
    arrays; the pool goes to `device` (default: the CUDA device)."""
    dev = resolve_device(device)
    s = system_arrays
    system = ReactionSystem(
        reactant_idx=np.asarray(s["reactant_idx"], np.int32),
        reactant_coef=np.asarray(s["reactant_coef"], np.int32),
        delta=np.asarray(s["delta"], np.int32),
        rates=np.asarray(s["rates"], np.float32),
        x0=np.asarray(s["x0"], np.float32),
        species_names=tuple(s["species_names"]),
        reaction_names=tuple(s["reaction_names"]))
    system.validate()

    def leaf(name):
        a = np.asarray(pool_arrays[name])
        if name in _WORDS:
            a = a.astype(np.uint32).view(np.int32)
        return torch.tensor(a, device=dev)  # a copy: the port owns it

    return system, LaneState(*(leaf(f) for f in LaneState._fields))


def to_reference_arrays(system: ReactionSystem, pool: LaneState
                        ) -> tuple[dict, dict]:
    """(system_arrays, pool_arrays) in the reference's dtypes."""
    sysd = {f: getattr(system, f) for f in SYSTEM_FIELDS}
    poold = {}
    for f in LaneState._fields:
        a = getattr(pool, f).cpu().numpy()
        poold[f] = a.view(np.uint32) if f in _WORDS else a
    return sysd, poold


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
        a = a.view(np.int16)
        return torch.tensor(a, device=device).view(torch.bfloat16)
    return torch.tensor(a, device=device)  # a copy: the port owns it


def _to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # its bits, as int16
        return t.view(torch.int16).numpy()
    return t.numpy()


def lm_params_from_reference(cfg, tree) -> dict:
    """The reference's `CausalLM.init` tree (numpy arrays) as a state
    dict of host tensors for the port's `CausalLM(cfg)`
    (`model.load_state_dict(...)` copies them to its device): the same
    names and shapes, each checked against the port's parameter
    definitions."""
    from repro_torch.models.causal_lm import model_defs
    from repro_torch.models.common import flatten_defs

    flat = {k.replace("/", "."): a for k, a in tree_flatten_with_path(tree)}
    want = dict(flatten_defs(model_defs(cfg)))
    if set(flat) != set(want):
        raise ValueError(
            f"{cfg.name}: the reference's parameter tree does not match the "
            f"port's: missing {sorted(set(want) - set(flat))}, unexpected "
            f"{sorted(set(flat) - set(want))}")
    for name, a in flat.items():
        if tuple(np.shape(a)) != tuple(want[name].shape):
            raise ValueError(f"{cfg.name}: {name} has shape {np.shape(a)}, "
                             f"the port's {want[name].shape}")
    return {name: _to_tensor(a, "cpu") for name, a in flat.items()}


def lm_cache_from_reference(tree, device=None):
    """A KV cache tree of the reference's (numpy) as the port's tensors
    on `device` (default: the CUDA device)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _to_tensor(node, dev)

    return walk(tree)


def lm_cache_to_reference(cache):
    """The port's KV cache tree as numpy arrays, the reference's layout
    (bfloat16 leaves as their int16 bits)."""
    if isinstance(cache, dict):
        return {k: lm_cache_to_reference(v) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return [lm_cache_to_reference(v) for v in cache]
    return _to_array(cache)


def train_state_from_reference(tree, device=None) -> dict:
    """The reference's train state {"params", "opt": AdamWState} (numpy
    leaves; its `AdamWState` or any object with the four fields) as the
    port's, on `device` (default: the CUDA device)."""
    from repro_torch.train.optim import AdamWState

    dev = resolve_device(device)

    def conv(node):
        return tree_map(lambda a: _to_tensor(a, dev), node)

    opt = tree["opt"]
    return {"params": conv(tree["params"]),
            "opt": AdamWState(*(conv(getattr(opt, f))
                                for f in AdamWState._fields))}


def train_state_to_reference(state) -> dict:
    """The port's train state as numpy trees: {"params", "opt":
    AdamWState of arrays} (bfloat16 leaves as their int16 bits)."""
    from repro_torch.train.optim import AdamWState

    opt = state["opt"]
    return {"params": tree_map(_to_array, state["params"]),
            "opt": AdamWState(*(tree_map(_to_array, getattr(opt, f))
                                for f in AdamWState._fields))}


# ---------------------------------------------------------------------------
# Per-shard state: the reference's per-device buffers <-> the port's parts
# ---------------------------------------------------------------------------


def parts_from_reference(buffers: dict, mesh) -> list:
    """{mesh position: numpy buffer} (every position of `mesh`) as the
    port's parts in row-major mesh order, each on its position's
    device."""
    devs = mesh.device_list()
    return [_to_tensor(buffers[pos], devs[i])
            for i, pos in enumerate(positions(mesh))]


def parts_to_reference(parts: list, mesh) -> dict:
    """The port's parts as {mesh position: numpy buffer}."""
    return {pos: _to_array(t) for pos, t in zip(positions(mesh), parts)}


def _dp_shards(mesh, axis: str) -> list:
    """(position, device) of each data-parallel shard along `axis` (the
    other axes at index 0), in shard order."""
    at = mesh.axis_names.index(axis)
    return [(pos, dev) for pos, dev in zip(positions(mesh),
                                           mesh.device_list())
            if all(p == 0 for j, p in enumerate(pos) if j != at)]


def dp_errors_from_reference(buffers: dict, params, mesh,
                             axis: str = "data") -> list:
    """The reference DP step's error state as `make_dp_train_step`'s
    "error" (one tree a shard, on the shard's device). buffers: {leaf
    path ("/"-join, as the store names leaves): {mesh position: numpy
    buffer}}; params: a tree of the error state's structure."""
    paths = [path for path, _ in tree_flatten_with_path(params)]
    return [tree_unflatten_like(params, [_to_tensor(buffers[p][pos], dev)
                                         for p in paths])
            for pos, dev in _dp_shards(mesh, axis)]


def dp_errors_to_reference(errors: list, mesh, axis: str = "data") -> dict:
    """`make_dp_train_step`'s error state as {leaf path: {mesh position:
    numpy buffer}} for the shards' positions."""
    out: dict = {}
    for (pos, _), tree in zip(_dp_shards(mesh, axis), errors):
        for path, leaf in tree_flatten_with_path(tree):
            out.setdefault(path, {})[pos] = _to_array(leaf)
    return out


def sharded_from_reference(buffers: dict, spec: tuple, mesh, device=None
                           ) -> torch.Tensor:
    """A leaf split by `spec` on `mesh` (a sequence-sharded cache leaf),
    given as {mesh position: numpy buffer}, joined into one tensor on
    `device` (default: the mesh's first device)."""
    return unshard(parts_from_reference(buffers, mesh), spec, mesh, device)


def sharded_to_reference(t: torch.Tensor, spec: tuple, mesh) -> dict:
    """A tensor's split by `spec` on `mesh` as {mesh position: numpy
    buffer}, the reference's per-device buffers of that layout."""
    return parts_to_reference(shard(t, spec, mesh), mesh)


def placed_from_reference(buffers: dict, sharding) -> Placed:
    """A leaf the reference holds sharded by `sharding` (a
    `NamedSharding` of the port's), given as {mesh position: numpy
    buffer}, as a `Placed` on the port's mesh: positions holding the
    same slice on one device share one part."""
    mesh, spec = sharding.mesh, sharding.spec
    devs = mesh.device_list()
    seen, parts = {}, []
    for i, pos in enumerate(positions(mesh)):
        key = (slice_key(spec, mesh, pos), devs[i])
        if key not in seen:
            seen[key] = _to_tensor(buffers[pos], devs[i])
        parts.append(seen[key])
    return Placed(parts, spec, mesh)


def placed_tree_from_reference(buffers: dict, template):
    """`template`'s structure (a placed parameter tree or train state)
    from {leaf path: {mesh position: numpy buffer}}: each `Placed` leaf
    in its layout, any other leaf (the step) from its first position's
    buffer, on the template leaf's device."""
    out = []
    for path, leaf in tree_flatten_with_path(template):
        if isinstance(leaf, Placed):
            out.append(placed_from_reference(buffers[path], leaf.sharding))
        else:
            first = buffers[path][min(buffers[path])]
            out.append(_to_tensor(first, leaf.device))
    return tree_unflatten_like(template, out)


def placed_tree_to_reference(tree) -> dict:
    """A placed tree as {leaf path: {mesh position: numpy buffer}}: a
    `Placed` leaf's parts, and any other leaf at every position of the
    first `Placed` leaf's mesh (a replicated array's buffers)."""
    flat = tree_flatten_with_path(tree)
    mesh = next(leaf.mesh for _, leaf in flat if isinstance(leaf, Placed))
    out = {}
    for path, leaf in flat:
        if isinstance(leaf, Placed):
            out[path] = parts_to_reference(leaf.parts, leaf.mesh)
        else:
            a = _to_array(leaf)
            out[path] = {pos: a for pos in positions(mesh)}
    return out
