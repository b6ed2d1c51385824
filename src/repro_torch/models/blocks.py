"""Block assembly and layer stacking; port of `repro/models/blocks.py`.

A block = pre-norm attention mixer + pre-norm FFN (dense / MoE /
none), with optional parallel residual (command-r). Layer stacks are
decomposed into `prefix + pattern × n_repeat` (`layer_groups`, e.g.
deepseek: 1 dense layer + 27 MoE), and the repeated pattern's
parameters and caches are stacked on a leading (n_repeat,) axis, as the
reference stacks them for `lax.scan`, so the two packages' parameter
and cache trees map one to one. A Python loop over the repeats replaces
the scan; the router's aux loss is summed over the prefix, then over
the repeats in order, as the scan carries it.

Each block takes the model's `Topology`: the FFN goes through
`apply_moe(..., topo)` (its multi-device paths on a mesh of more than
one device), and decode through `decode_attention_seqsharded` whenever
`topo.rules[KV_SEQ]` is set, as the reference routes them.
`block_cache_logical` names the cache leaves' axes.

On a mesh of more than one device the block runs on parts
(`_apply_block_placed`): x is a `Placed` (B, S, d) in the layout
`Topology.constrain(x, BATCH, SEQ, EMBED)` gives, the parameters are
`Placed` leaves, the norms run on each part with their parameters
gathered over `data`, attention and the MLP on each model shard's heads
and columns, and the residual adds come after the row-parallel `psum`.
The MoE FFN receives the normed input already split by BATCH and
returns its output in the same layout. The decode cache is a tree of
`Placed` leaves split by `block_cache_logical` (BATCH, KV_SEQ,
KV_HEADS), written in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (
    FFN_DENSE,
    FFN_MOE,
    FFN_NONE,
    MIXER_ATTN,
    LayerSpec,
    ModelConfig,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import gathered_tree
from repro_torch.models.mlp import apply_mlp, apply_mlp_placed, mlp_defs
from repro_torch.models.moe import apply_moe, moe_defs
from repro_torch.models.norms import apply_norm, norm_defs
from repro_torch.sharding import collectives as col
from repro_torch.sharding.collectives import Placed, reshard
from repro_torch.sharding.rules import (
    BATCH,
    EMBED,
    KV_HEADS,
    KV_SEQ,
    SEQ,
    Topology,
)

# ---------------------------------------------------------------------------
# Layer grouping
# ---------------------------------------------------------------------------


class LayerGroups(NamedTuple):
    prefix: tuple[LayerSpec, ...]
    pattern: tuple[LayerSpec, ...]
    n_repeat: int


def layer_groups(specs: tuple[LayerSpec, ...], max_period: int = 12
                 ) -> LayerGroups:
    n = len(specs)
    for prefix_len in range(0, n):
        rest = specs[prefix_len:]
        m = len(rest)
        for p in range(1, min(max_period, m) + 1):
            if m % p:
                continue
            if all(rest[i] == rest[i % p] for i in range(m)):
                return LayerGroups(specs[:prefix_len], rest[:p], m // p)
    return LayerGroups(specs[:-1], specs[-1:], 1)


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    d = {"norm1": norm_defs(cfg.d_model, cfg.norm)}
    if spec.mixer == MIXER_ATTN:
        d["mixer"] = attn_mod.attn_defs(cfg)
    else:
        raise ValueError(spec.mixer)
    if spec.ffn == FFN_DENSE:
        d["ffn"] = mlp_defs(cfg)
        if not cfg.parallel_block:
            d["norm2"] = norm_defs(cfg.d_model, cfg.norm)
    elif spec.ffn == FFN_MOE:
        d["ffn"] = moe_defs(cfg)
        if not cfg.parallel_block:
            d["norm2"] = norm_defs(cfg.d_model, cfg.norm)
    return d


def init_block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     cache_len: int, dtype, device):
    """Decode-time cache entry for one block."""
    hd = cfg.resolved_head_dim
    if spec.mixer == MIXER_ATTN:
        shape = (batch, cache_len, cfg.n_kv_heads, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    raise ValueError(spec.mixer)


def block_cache_logical(cfg: ModelConfig, spec: LayerSpec):
    """Logical axes for each cache leaf (mirrors init_block_cache)."""
    if spec.mixer == MIXER_ATTN:
        return {"k": (BATCH, KV_SEQ, KV_HEADS, None),
                "v": (BATCH, KV_SEQ, KV_HEADS, None)}
    raise ValueError(spec.mixer)


def _apply_attn_full(params, x, cfg, positions):
    q, k, v = attn_mod.project_qkv(params, x, cfg, positions)
    o = attn_mod.attention(q, k, v, causal=True)
    return attn_mod.out_proj(params, o), {"k": k, "v": v}


def _apply_attn_decode(params, x, cfg, topo, cache, pos):
    """x: (B,1,d); cache k/v (B,S,KV,hd); pos (B,) current write index."""
    positions = pos[:, None]
    q, k_new, v_new = attn_mod.project_qkv(params, x, cfg, positions)
    s = cache["k"].shape[1]
    slot = torch.clamp_max(pos, s - 1)  # ring write
    if topo is not None and topo.rules.get(KV_SEQ):
        o, k_c, v_c = attn_mod.decode_attention_seqsharded(
            q, cache["k"], cache["v"], k_new, v_new, slot, pos, topo)
    else:
        k_c, v_c = attn_mod.write_kv_slot(cache["k"], cache["v"], k_new,
                                          v_new, slot)
        o = attn_mod.decode_attention(q, k_c, v_c, slot, valid_len=pos)
    return attn_mod.out_proj(params, o), {"k": k_c, "v": v_c}


def apply_block(params, x, cfg: ModelConfig, topo: Optional[Topology],
                spec: LayerSpec, *, mode: str = "full", positions=None,
                cache: Optional[dict] = None, pos=None):
    """Returns (x, new_cache, aux).

    mode: "full" (no cache IO), "prefill" (returns the built cache),
    "decode" (single token, writes its K/V into `cache` in place).
    """
    if isinstance(x, Placed):
        return _apply_block_placed(params, x, cfg, topo, spec, mode=mode,
                                   cache=cache, pos=pos)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(params["norm1"], x, cfg.norm)
    new_cache: dict = {}

    if spec.mixer != MIXER_ATTN:
        raise ValueError(spec.mixer)
    if mode == "decode":
        mix_out, kv = _apply_attn_decode(params["mixer"], h, cfg, topo,
                                         cache, pos)
        new_cache.update(kv)
    else:
        mix_out, kv = _apply_attn_full(params["mixer"], h, cfg, positions)
        if mode == "prefill":
            new_cache.update(kv)

    def ffn(h_in):
        nonlocal aux
        if spec.ffn == FFN_MOE:
            out, aux_l = apply_moe(params["ffn"], h_in, cfg, topo)
            aux = aux + aux_l
            return out
        return apply_mlp(params["ffn"], h_in, cfg)

    if cfg.parallel_block and spec.ffn != FFN_NONE:
        # command-r: y = x + attn(n(x)) + ffn(n(x)) (shared norm)
        return x + mix_out + ffn(h), new_cache, aux

    x = x + mix_out
    if spec.ffn != FFN_NONE:
        x = x + ffn(apply_norm(params["norm2"], x, cfg.norm))
    return x, new_cache, aux


def _norm_placed(params, x: Placed, cfg: ModelConfig, topo) -> Placed:
    local, _ = gathered_tree(params, topo)
    return Placed(col.each(lambda p, xx: apply_norm(p, xx, cfg.norm), local,
                           x), x.spec, x.mesh)


def _add(a: Placed, b: Placed) -> Placed:
    """a + b in a's layout."""
    b = reshard(b, a.spec)
    return Placed(col.each(torch.add, a, b), a.spec, a.mesh)


def _apply_block_placed(params, x: Placed, cfg: ModelConfig, topo: Topology,
                        spec: LayerSpec, *, mode: str, cache=None, pos=None):
    """`apply_block` on a mesh (x and the parameters `Placed`)."""
    aux = torch.zeros((), dtype=torch.float32, device=topo.device)
    h = _norm_placed(params["norm1"], x, cfg, topo)
    new_cache: dict = {}
    if spec.mixer != MIXER_ATTN:
        raise ValueError(spec.mixer)
    if mode == "decode":
        mix_out, kv = attn_mod.attn_decode_placed(params["mixer"], h, cfg,
                                                  topo, cache, pos)
        new_cache.update(kv)
    else:
        mix_out, kv = attn_mod.attn_full_placed(params["mixer"], h, cfg,
                                                topo)
        if mode == "prefill":
            new_cache.update(kv)

    def ffn(h_in):
        nonlocal aux
        if spec.ffn == FFN_MOE:
            out, aux_l = apply_moe(params["ffn"], h_in, cfg, topo)
            aux = aux + aux_l
            return out
        # the MLP runs on the whole sequence; its row-parallel output is
        # reduce-scattered back where the residual is split on it
        s_ax = h_in.spec[1]
        out = apply_mlp_placed(params["ffn"], reshard(
            h_in, (h_in.spec[0], None, None)), cfg, topo,
            1 if s_ax is not None else None)
        return out

    if cfg.parallel_block and spec.ffn != FFN_NONE:
        return _add(_add(x, mix_out), ffn(h)), new_cache, aux

    x = _add(x, mix_out)
    if spec.ffn != FFN_NONE:
        x = _add(x, ffn(_norm_placed(params["norm2"], x, cfg, topo)))
    return topo.constrain(x, BATCH, SEQ, EMBED), new_cache, aux


# ---------------------------------------------------------------------------
# Stacks (prefix + stacked pattern)
# ---------------------------------------------------------------------------


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def stack_defs(cfg: ModelConfig, specs: tuple[LayerSpec, ...]) -> dict:
    groups = layer_groups(specs)
    d: dict = {"prefix": [block_defs(cfg, s) for s in groups.prefix]}
    if groups.n_repeat:
        pat = {f"l{j}": block_defs(cfg, s)
               for j, s in enumerate(groups.pattern)}
        d["stack"] = _map(lambda pd: pd.stacked(groups.n_repeat), pat)
    return d


def pad_cache(cache, cache_len: int):
    """Pad attention K/V cache seq axes (axis = ndim-3) out to cache_len
    so decode has ring-write headroom (a `Placed` leaf part by part: its
    sequence axis is whole until the cache is placed)."""

    def pad(v):
        ax = v.ndim - 3
        if v.shape[ax] >= cache_len:
            return v
        # F.pad lists (left, right) from the last axis
        return F.pad(v, [0, 0] * (v.ndim - 1 - ax)
                     + [0, cache_len - v.shape[ax]])

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in ("k", "v") and isinstance(v, Placed):
                    if v.spec[v.ndim - 3] is not None:
                        raise ValueError("pad_cache: the cache's sequence "
                                         "axis is split")
                    out[k] = v.map(pad)
                elif k in ("k", "v"):
                    out[k] = pad(v)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, list):
            return [walk(x) for x in node]
        return node

    return walk(cache)


def stack_cache_init(cfg: ModelConfig, specs, batch: int, cache_len: int,
                     dtype, device):
    groups = layer_groups(specs)
    cache: dict = {"prefix": [
        init_block_cache(cfg, s, batch, cache_len, dtype, device)
        for s in groups.prefix]}
    if groups.n_repeat:
        pat = {f"l{j}": init_block_cache(cfg, s, batch, cache_len, dtype,
                                         device)
               for j, s in enumerate(groups.pattern)}
        cache["stack"] = _map(
            lambda a: a.expand(groups.n_repeat, *a.shape).clone(), pat)
    return cache


def apply_stack(params, x, cfg: ModelConfig, topo: Optional[Topology],
                specs, *, mode="full", positions=None, cache=None,
                pos=None):
    """Run the full layer stack. Returns (x, new_cache, aux).

    In "decode" mode each layer's K/V slot is written into `cache` in
    place (a repeat's cache is a view of the stacked tensors), and the
    returned cache is `cache` itself. In "prefill" mode the repeats'
    K/V are stacked on a leading (n_repeat,) axis, as the reference's
    scan stacks them. A stacked parameter is unbound once, so its
    gradient is one stack of the repeats' gradients.
    """
    groups = layer_groups(specs)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: dict = {"prefix": []}

    for i, spec in enumerate(groups.prefix):
        c = cache["prefix"][i] if cache is not None else None
        x, nc, aux = apply_block(params["prefix"][i], x, cfg, topo, spec,
                                 mode=mode, positions=positions, cache=c,
                                 pos=pos)
        new_cache["prefix"].append(nc)
        aux_total = aux_total + aux

    if not groups.n_repeat:
        return x, new_cache, aux_total

    unbound = {name: _map(_unbind, p)
               for name, p in params["stack"].items()}
    per_repeat = []
    for r in range(groups.n_repeat):
        ncs = {}
        for j, spec in enumerate(groups.pattern):
            p = _map(lambda a: a[r], unbound[f"l{j}"])
            c = (_map(lambda a: _take(a, r), cache["stack"][f"l{j}"])
                 if cache is not None else None)
            x, ncs[f"l{j}"], aux = apply_block(
                p, x, cfg, topo, spec, mode=mode, positions=positions, cache=c,
                pos=pos)
            aux_total = aux_total + aux
        per_repeat.append(ncs)
    if mode == "decode":
        new_cache["stack"] = cache["stack"]
    else:
        new_cache["stack"] = {
            name: {k: _stack([rep[name][k] for rep in per_repeat])
                   for k in per_repeat[0][name]}
            for name in per_repeat[0]}
    return x, new_cache, aux_total


def _unbind(a) -> tuple:
    """A stacked leaf's repeats. A `Placed` leaf's parts are unbound
    once each (views); where FSDP split its layers axis (small configs)
    the axis is gathered first."""
    if not isinstance(a, Placed):
        return a.unbind(0)
    if a.spec[0] is not None:
        a = reshard(a, (None, *a.spec[1:]))
    per_part: dict = {}
    for t in a.parts:
        per_part.setdefault(id(t), t.unbind(0))
    return tuple(Placed([per_part[id(t)][r] for t in a.parts], a.spec[1:],
                        a.mesh) for r in range(a.shape[0]))


def _take(a, r: int):
    """Repeat r of a stacked cache leaf (views, so writes land in it)."""
    if isinstance(a, Placed):
        return a.map(lambda t: t[r], a.spec[1:])
    return a[r]


def _stack(leaves: list):
    if isinstance(leaves[0], Placed):
        return Placed(col.each(lambda *ts: torch.stack(ts), *leaves),
                      (None, *leaves[0].spec), leaves[0].mesh)
    return torch.stack(leaves)
