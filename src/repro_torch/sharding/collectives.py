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
* `reduce_scatter` is `psum` in the same order, after which member i
  keeps slice i of the sum along `dim` (tiled): the transpose of
  `all_gather`, which autograd gives `all_gather`'s backward too.
* `all_to_all` (tiled) splits every member's part along `split_axis`
  into as many chunks as members; member i receives chunk i of each
  member j and concatenates them along `concat_axis` in j order.

A result goes to each member's device; members on the same device share
one tensor, so a mesh of repeated devices makes no copies. Groups whose
parts are the same tensors (a value replicated over another axis)
share one result, computed once. Every collective keeps its operands'
dtype (a bf16 `psum` adds bf16 partials, as GSPMD's all-reduce of the
reference's bf16 partial products does) and is differentiable through
autograd.

`Placed` is a tensor held as the parts its spec gives: the port's
sharded `jax.Array`. `reshard` moves it to another spec by gathering
and slicing, and `each` runs a shard's body at every position, once for
positions whose inputs are the same tensors.
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


def slice_key(spec: tuple, mesh: Mesh, pos: tuple[int, ...]) -> tuple:
    """Which slice of a tensor split by `spec` position `pos` holds: the
    axis index of each split dimension, None for a whole one."""
    return tuple(None if ax is None else axis_index(mesh, ax, pos)
                 for ax in spec)


def _narrow(x: torch.Tensor, spec: tuple, mesh: Mesh, key: tuple
            ) -> torch.Tensor:
    part = x
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n = axis_size(mesh, ax)
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of size {x.shape[d]} "
                             f"does not split over {ax} ({n})")
        size = x.shape[d] // n
        part = part.narrow(d, key[d] * size, size)
    return part


def shard(x: torch.Tensor, spec: tuple, mesh: Mesh) -> list:
    """x split by `spec` (a mesh axis, a tuple of axes or None per
    dimension; missing trailing entries are None) into one part per
    position, each on its position's device. Parts on x's device are
    views of x; positions holding the same slice on the same device
    share one part."""
    devs = mesh.device_list()
    out, seen = [], {}
    for i, pos in enumerate(positions(mesh)):
        idx = slice_key(spec, mesh, pos)
        key = (idx, devs[i])
        if key not in seen:
            seen[key] = _narrow(x, spec, mesh, idx).to(devs[i])
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
    done: dict = {}
    for g in groups(mesh, axis):
        key = tuple(id(parts[j]) for j in g)
        if key not in done:
            acc = parts[g[0]]
            for j in g[1:]:
                acc = op(acc, parts[j].to(acc.device))
            done[key] = acc if finish is None else finish(acc)
        _spread(done[key], g, devs, out)
    return out


def psum(parts: list, mesh: Mesh, axis) -> list:
    """The group's parts added from index 0 up, in their own dtype."""
    return _fold(parts, mesh, axis, torch.add)


def reduce_scatter(parts: list, mesh: Mesh, axis, dim: int) -> list:
    """Tiled `psum_scatter`: the group's sum (as `psum`), of which
    member i keeps slice i along `dim`."""
    summed = psum(parts, mesh, axis)
    n = axis_size(mesh, axis)
    out, seen = [], {}
    for pos, t in zip(positions(mesh), summed):
        i = axis_index(mesh, axis, pos)
        key = (id(t), i)
        if key not in seen:
            if t.shape[dim] % n:
                raise ValueError(f"reduce_scatter: dimension {dim} of size "
                                 f"{t.shape[dim]} does not split over "
                                 f"{axis} ({n})")
            size = t.shape[dim] // n
            seen[key] = t.narrow(dim, i * size, size)
        out.append(seen[key])
    return out


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
    done: dict = {}
    for g in groups(mesh, axis):
        key = tuple(id(parts[j]) for j in g)
        if key not in done:
            dev = parts[g[0]].device
            done[key] = torch.cat([parts[j].to(dev) for j in g], dim=dim)
        _spread(done[key], g, devs, out)
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


# ---------------------------------------------------------------------------
# Placed tensors
# ---------------------------------------------------------------------------


def _full_spec(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} "
                         "dimensions")
    return spec + (None,) * (ndim - len(spec))


class Placed:
    """A tensor held on a mesh as the parts its spec gives: `parts` has
    one tensor a mesh position (row-major), each on its position's
    device; positions holding the same slice on the same device share
    one tensor. On a mesh of repeated devices the parts of a leaf are
    views of one tensor; on distinct devices, copies. Indexing and
    `len` act on the parts."""

    __slots__ = ("parts", "spec", "mesh")

    def __init__(self, parts, spec, mesh: Mesh):
        self.parts = list(parts)
        if len(self.parts) != mesh.size:
            raise ValueError(f"{len(self.parts)} parts for a mesh of "
                             f"{mesh.size} positions")
        self.spec = _full_spec(spec, self.parts[0].ndim)
        self.mesh = mesh

    # ------------------------------------------------------------ making
    @classmethod
    def place(cls, x: torch.Tensor, spec, mesh: Mesh) -> "Placed":
        """x split by `spec`. On a mesh of distinct devices the parts on
        x's device are copied, so x itself is not kept alive."""
        spec = _full_spec(spec, x.ndim)
        parts = shard(x, spec, mesh)
        if len(set(mesh.device_list())) > 1 and any(spec):
            own: dict = {}
            for p in parts:
                if p.device == x.device and id(p) not in own:
                    own[id(p)] = p.clone()
            parts = [own.get(id(p), p) for p in parts]
        return cls(parts, spec, mesh)

    @classmethod
    def empty(cls, shape, dtype, spec, mesh: Mesh, fill=None) -> "Placed":
        """Uninitialised (or `fill`ed) parts: views of one tensor where
        the mesh's devices are all one device, else one tensor a part."""
        devs = mesh.device_list()
        spec = _full_spec(spec, len(shape))

        def new(shp, dev):
            if fill is None:
                return torch.empty(shp, dtype=dtype, device=dev)
            return torch.full(shp, fill, dtype=dtype, device=dev)

        if len(set(devs)) == 1:
            return cls(shard(new(tuple(shape), devs[0]), spec, mesh), spec,
                       mesh)
        local = list(shape)
        for d, ax in enumerate(spec):
            if ax is not None:
                local[d] //= axis_size(mesh, ax)
        seen: dict = {}
        parts = []
        for i, pos in enumerate(positions(mesh)):
            k = (slice_key(spec, mesh, pos), devs[i])
            if k not in seen:
                seen[k] = new(tuple(local), devs[i])
            parts.append(seen[k])
        return cls(parts, spec, mesh)

    # --------------------------------------------------------- describing
    @property
    def shape(self) -> tuple:
        shape = list(self.parts[0].shape)
        for d, ax in enumerate(self.spec):
            if ax is not None:
                shape[d] *= axis_size(self.mesh, ax)
        return tuple(shape)

    @property
    def ndim(self) -> int:
        return self.parts[0].ndim

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """The mesh's first device (where `whole` joins the parts)."""
        return self.mesh.device_list()[0]

    @property
    def sharding(self):
        from repro_torch.sharding.rules import NamedSharding
        return NamedSharding(self.mesh, self.spec)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __iter__(self):
        return iter(self.parts)

    def __repr__(self) -> str:
        return (f"Placed(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={self.mesh.shape})")

    def keys(self) -> list[tuple]:
        """Each position's slice key (`slice_key`)."""
        return [slice_key(self.spec, self.mesh, pos)
                for pos in positions(self.mesh)]

    def unique(self) -> list[torch.Tensor]:
        """The distinct part tensors, in position order."""
        seen: dict = {}
        for p in self.parts:
            seen.setdefault(id(p), p)
        return list(seen.values())

    def slices(self) -> list[torch.Tensor]:
        """One part a distinct slice (its first holder's), in position
        order: a replica on another device is left out."""
        seen: dict = {}
        for k, p in zip(self.keys(), self.parts):
            seen.setdefault(k, p)
        return list(seen.values())

    # ---------------------------------------------------------- changing
    def map(self, fn, spec=None) -> "Placed":
        """fn on each distinct part, the sharing kept."""
        done: dict = {}
        for p in self.parts:
            if id(p) not in done:
                done[id(p)] = fn(p)
        return Placed([done[id(p)] for p in self.parts],
                      self.spec if spec is None else spec, self.mesh)

    @torch.no_grad()
    def copy_(self, x: torch.Tensor) -> "Placed":
        """Write the whole tensor x into the parts (each distinct part
        once, cast to its dtype), in place."""
        if tuple(x.shape) != self.shape:
            raise ValueError(f"copy_ of a {tuple(x.shape)} tensor into a "
                             f"placed {self.shape} one")
        done = set()
        for k, p in zip(self.keys(), self.parts):
            if id(p) not in done:
                done.add(id(p))
                p.copy_(_narrow(x, self.spec, self.mesh, k))
        return self

    def whole(self, device=None) -> torch.Tensor:
        """The parts joined into one tensor on `device` (default: the
        mesh's first device)."""
        return unshard(self.parts, self.spec, self.mesh, device)


def reshard(x: Placed, spec) -> Placed:
    """x in the layout `spec`: each dimension whose axis changes is
    gathered (`all_gather`) and then sliced by its new axis (views);
    parts that keep their layout are the same tensors."""
    spec = _full_spec(spec, x.ndim)
    if spec == x.spec:
        return x
    mesh = x.mesh
    parts = x.parts
    cur = list(x.spec)
    for d, (old, new) in enumerate(zip(x.spec, spec)):
        if old is not None and old != new:
            parts = all_gather(parts, mesh, old, d)
            cur[d] = None
    need = [(d, ax) for d, ax in enumerate(spec)
            if ax is not None and cur[d] is None]
    if need:
        sub = tuple(ax if (d, ax) in need else None
                    for d, ax in enumerate(spec))
        out, seen = [], {}
        for p, pos in zip(parts, positions(mesh)):
            k = slice_key(sub, mesh, pos)
            if (id(p), k) not in seen:
                seen[(id(p), k)] = _narrow(p, sub, mesh, k)
            out.append(seen[(id(p), k)])
        parts = out
    return Placed(parts, spec, mesh)


def each(fn, *args) -> list:
    """fn at every mesh position, in order: an argument that is a
    `Placed` or a list gives the position's entry, anything else is
    passed as it is. Positions whose entries are the same objects share
    one call and its result (a replicated computation runs once)."""
    n = next(len(a) for a in args if isinstance(a, (Placed, list)))
    out, done = [], {}
    for i in range(n):
        vals = [a[i] if isinstance(a, (Placed, list)) else a for a in args]
        key = tuple(id(v) for v, a in zip(vals, args)
                    if isinstance(a, (Placed, list)))
        if key not in done:
            done[key] = fn(*vals)
        out.append(done[key])
    return out


def flat_parts(tree) -> list:
    """The distinct tensors of a tree: each tensor leaf, and each
    `Placed` leaf's distinct parts (`Placed.unique`), in traversal
    order. Trees of one structure and layout give aligned lists, which
    is how the optimizer updates placed state part by part."""
    from repro_torch.tree import tree_leaves

    out = []
    for leaf in tree_leaves(tree):
        out.extend(leaf.unique() if isinstance(leaf, Placed) else [leaf])
    return out


def unflat_parts(template, tensors: list):
    """`template`'s structure with `tensors` (as `flat_parts` lists
    them) in its leaves' places; a `Placed` leaf keeps its sharing."""
    from repro_torch.tree import tree_map

    it = iter(tensors)

    def leaf(t):
        if not isinstance(t, Placed):
            return next(it)
        new = {id(p): next(it) for p in t.unique()}
        return Placed([new[id(p)] for p in t.parts], t.spec, t.mesh)

    return tree_map(leaf, template)
