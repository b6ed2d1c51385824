"""The port's `shard_map` and `jax.lax` collectives, over a `Mesh` in one
process.

A value that differs per shard is a list of parts, one per mesh
position in row-major order (`positions`). `shard` splits a tensor by a
spec into such parts and `unshard` joins them back. A `shard_map` body
with collectives in the middle is written as phases between its
collectives, each phase run over the shards in mesh order.

A collective over an axis (a name, or a tuple of names whose combined
index runs major to minor in the tuple's order) acts on each group of
positions that differ only along that axis:

* `psum` adds the group's parts along the axis from index 0 up, left to
  right, on the first member's device: one fixed order, so the CPU, one
  card and four cards give the same bits. `pmean` divides that sum by
  the group's size, `pmax` takes the running maximum in the same order.
* `all_gather` concatenates the group's parts in axis order (tiled).
* `all_to_all` (tiled) splits every member's part along `split_axis`
  into as many chunks as members; member i receives chunk i of each
  member j and concatenates them along `concat_axis` in j order.

A result goes to each member's device; members on the same device share
one tensor, so a mesh of repeated devices makes no copies.
"""
from __future__ import annotations

import itertools
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from repro_torch.sharding.rules import Mesh


def _axes(axis) -> tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def positions(mesh: Mesh) -> list[tuple[int, ...]]:
    """Every mesh position (an index per axis), row-major."""
    return list(itertools.product(*(range(n) for n in mesh.devices.shape)))


def axis_size(mesh: Mesh, axis) -> int:
    sizes = mesh.shape
    return int(np.prod([sizes[a] for a in _axes(axis)], dtype=np.int64))


def axis_index(mesh: Mesh, axis, pos: tuple[int, ...]) -> int:
    """`jax.lax.axis_index(axis)` at mesh position `pos`."""
    sizes = mesh.shape
    k = 0
    for a in _axes(axis):
        k = k * sizes[a] + pos[mesh.axis_names.index(a)]
    return k


def shard(x: torch.Tensor, spec: tuple, mesh: Mesh) -> list:
    """x split by `spec` (a mesh axis, a tuple of axes or None per
    dimension; missing trailing entries are None) into one part per
    position, each on its position's device. Parts on x's device are
    views of x; positions holding the same slice on the same device
    share one part."""
    devs = mesh.device_list()
    out, seen = [], {}
    for i, pos in enumerate(positions(mesh)):
        idx = tuple(None if ax is None else axis_index(mesh, ax, pos)
                    for ax in spec)
        key = (idx, devs[i])
        if key not in seen:
            part = x
            for d, ax in enumerate(spec):
                if ax is None:
                    continue
                n = axis_size(mesh, ax)
                if x.shape[d] % n:
                    raise ValueError(f"dimension {d} of size {x.shape[d]} "
                                     f"does not split over {ax} ({n})")
                size = x.shape[d] // n
                part = part.narrow(d, idx[d] * size, size)
            seen[key] = part.to(devs[i])
        out.append(seen[key])
    return out


def unshard(parts: list, spec: tuple, mesh: Mesh, device=None
            ) -> torch.Tensor:
    """The whole tensor of `parts` (as `shard` made them) on `device`
    (default: the mesh's first device). Replicated positions are read
    from the one whose other indices are 0."""
    device = mesh.device_list()[0] if device is None else device
    used = {a for ax in spec if ax is not None for a in _axes(ax)}
    shape = list(parts[0].shape)
    for d, ax in enumerate(spec):
        if ax is not None:
            shape[d] *= axis_size(mesh, ax)
    out = torch.empty(shape, dtype=parts[0].dtype, device=device)
    for i, pos in enumerate(positions(mesh)):
        if any(pos[j] for j, a in enumerate(mesh.axis_names)
               if a not in used):
            continue
        view = out
        for d, ax in enumerate(spec):
            if ax is not None:
                size = parts[i].shape[d]
                view = view.narrow(d, axis_index(mesh, ax, pos) * size, size)
        view.copy_(parts[i])
    return out


def groups(mesh: Mesh, axis) -> list[list[int]]:
    """The flat position indices of each group along `axis`, each group
    in axis-index order."""
    axes = _axes(axis)
    rest = [j for j, a in enumerate(mesh.axis_names) if a not in axes]
    by_key: dict = {}
    for i, pos in enumerate(positions(mesh)):
        by_key.setdefault(tuple(pos[j] for j in rest), []).append(
            (axis_index(mesh, axis, pos), i))
    return [[i for _, i in sorted(g)] for g in by_key.values()]


def _spread(value, members: list[int], devs: list, out: list) -> None:
    """value to each member's device, one tensor a device."""
    per_dev = {value.device: value}
    for m in members:
        if devs[m] not in per_dev:
            per_dev[devs[m]] = value.to(devs[m])
        out[m] = per_dev[devs[m]]


def _fold(parts: list, mesh: Mesh, axis, op, finish=None) -> list:
    devs = mesh.device_list()
    out = [None] * len(parts)
    for g in groups(mesh, axis):
        acc = parts[g[0]]
        for j in g[1:]:
            acc = op(acc, parts[j].to(acc.device))
        _spread(acc if finish is None else finish(acc), g, devs, out)
    return out


def psum(parts: list, mesh: Mesh, axis) -> list:
    return _fold(parts, mesh, axis, torch.add)


def pmax(parts: list, mesh: Mesh, axis) -> list:
    return _fold(parts, mesh, axis, torch.maximum)


def pmean(parts: list, mesh: Mesh, axis) -> list:
    n = axis_size(mesh, axis)
    return _fold(parts, mesh, axis, torch.add, lambda t: t / torch.tensor(
        n, dtype=t.dtype, device=t.device))


def all_gather(parts: list, mesh: Mesh, axis, dim: int) -> list:
    """Tiled `all_gather`: the group's parts concatenated along `dim`."""
    devs = mesh.device_list()
    out = [None] * len(parts)
    for g in groups(mesh, axis):
        dev = parts[g[0]].device
        whole = torch.cat([parts[j].to(dev) for j in g], dim=dim)
        _spread(whole, g, devs, out)
    return out


def all_to_all(parts: list, mesh: Mesh, axis, split_axis: int,
               concat_axis: int) -> list:
    """Tiled `all_to_all`: member i gets chunk i (along `split_axis`) of
    every member j's part, concatenated along `concat_axis` in j order."""
    devs = mesh.device_list()
    out = [None] * len(parts)
    for g in groups(mesh, axis):
        n = len(g)
        if any(parts[j].shape[split_axis] % n for j in g):
            raise ValueError(f"all_to_all: dimension {split_axis} does not "
                             f"split into {n} chunks")
        chunks = [parts[j].chunk(n, dim=split_axis) for j in g]
        for i, m in enumerate(g):
            out[m] = torch.cat([c[i].to(devs[m]) for c in chunks],
                               dim=concat_axis)
    return out
