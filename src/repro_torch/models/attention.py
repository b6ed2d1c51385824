"""GQA attention: full, chunked (online softmax, memory-bounded for long
prompts) and decode against a KV cache; port of
`repro/models/attention.py`.

The reference's formula, op for op: scores and softmax in float32, the
mask at NEG_INF = -1e30, each KV head repeated over its query heads
(`jnp.repeat` is `repeat_interleave`), full attention up to
FULL_ATTN_MAX_SEQ positions and chunked above it. No TPU kernel computes
any of this in the reference, and no finished attention kernel
(`scaled_dot_product_attention` or another) stands in for it here.

`decode_attention_seqsharded` is the reference's distributed
flash-decode over a mesh axis: the cache split on its sequence axis,
each shard's partial softmax, an exact combine by `pmax` and `psum`
(`sharding/collectives.py`), the shards run in mesh order.

On a mesh (`attn_full_placed`, `attn_decode_placed`) the projections
run on each model shard's heads: Q, K and V column-parallel over
Q_HEADS / KV_HEADS (biases split alike), attention on the shard's
query heads, `out_proj` row-parallel with one `psum` over `model` and
`bo` added once after it. Where the query heads split and the KV heads
do not (`Topology._divides` leaves a dimension the axis does not divide
whole: llama3-8b's smoke config on four model shards, or at full width
on sixteen), each shard reads the KV heads its own query heads map to
(`_heads_for`), as `_expand_kv` maps them on one device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    ParamDef,
    einsum,
    einsum_out,
    gathered_tree,
    row_parallel,
)
from repro_torch.models.rope import apply_rope
from repro_torch.sharding import collectives as col
from repro_torch.sharding.collectives import Placed, reshard
from repro_torch.sharding.rules import (
    BATCH,
    EMBED,
    HEAD_DIM,
    KV_HEADS,
    KV_SEQ,
    Q_HEADS,
)

NEG_INF = -1e30

# When seq_len exceeds this, use the chunked online-softmax path.
FULL_ATTN_MAX_SEQ = 2048
Q_CHUNK = 1024
KV_CHUNK = 1024


def attn_defs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    defs = {
        "wq": ParamDef((d, h, hd), (EMBED, Q_HEADS, HEAD_DIM)),
        "wk": ParamDef((d, kv, hd), (EMBED, KV_HEADS, HEAD_DIM)),
        "wv": ParamDef((d, kv, hd), (EMBED, KV_HEADS, HEAD_DIM)),
        "wo": ParamDef((h, hd, d), (Q_HEADS, HEAD_DIM, EMBED)),
    }
    if cfg.mlp_bias:  # archs with biases use them in attention too
        defs["bq"] = ParamDef((h, hd), (Q_HEADS, HEAD_DIM), init="zeros")
        defs["bk"] = ParamDef((kv, hd), (KV_HEADS, HEAD_DIM), init="zeros")
        defs["bv"] = ParamDef((kv, hd), (KV_HEADS, HEAD_DIM), init="zeros")
        defs["bo"] = ParamDef((d,), (EMBED,), init="zeros")
    return defs


def project_qkv(params, x, cfg: ModelConfig, positions=None):
    """x: (B, S, D) -> q (B,S,H,hd), k,v (B,S,KV,hd)."""
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    k = einsum("bsd,dhk->bshk", x, params["wk"])
    v = einsum("bsd,dhk->bshk", x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.use_rope:
        if positions is None:
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(params, o):
    y = einsum_out("bshk,hkd->bsd", o, params["wo"])
    if "bo" in params:
        y = y + params["bo"]
    return y


def _expand_kv(k, n_heads: int):
    """(B,S,KV,hd) -> (B,S,H,hd) by repeating each KV head."""
    kv = k.shape[-2]
    if kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kv, dim=-2)


def full_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """Quadratic attention. q:(B,Sq,H,hd), k/v:(B,Sk,KV,hd)."""
    h = q.shape[-2]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = q.shape[-1] ** -0.5
    logits = einsum("bqhk,bshk->bhqs", q, k, dtype=torch.float32) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = einsum("bhqs,bshk->bqhk", w.to(v.dtype), v, dtype=torch.float32)
    return o.to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, q_chunk: int = Q_CHUNK,
                      kv_chunk: int = KV_CHUNK):
    """Online-softmax attention, O(S·chunk) memory. Shapes as
    full_attention. Every (query chunk, KV chunk) pair is computed, the
    fully masked ones too, as the reference's scan does."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"chunked_attention: {sq} queries and {sk} keys "
                         f"must be multiples of the chunks {q_chunk}, "
                         f"{kv_chunk}")
    nq, nk = sq // q_chunk, sk // kv_chunk
    scale = hd ** -0.5
    dev = q.device

    outs = []
    for qi in range(nq):
        q_blk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        o = torch.zeros((b, q_chunk, h, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            k_blk = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            v_blk = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            logits = einsum("bqhk,bshk->bhqs", q_blk, k_blk,
                            dtype=torch.float32) * scale
            if causal:
                qpos = qi * q_chunk + torch.arange(q_chunk,
                                                   device=dev)[:, None]
                kpos = ki * kv_chunk + torch.arange(kv_chunk,
                                                    device=dev)[None, :]
                logits = torch.where(qpos >= kpos, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha.transpose(1, 2)[..., None] + einsum(
                "bhqs,bshk->bqhk", p.to(v_blk.dtype), v_blk,
                dtype=torch.float32)
            m = m_new
        o = o / torch.clamp_min(l.transpose(1, 2)[..., None], 1e-30)
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=1)


def attention(q, k, v, *, causal: bool):
    """Full attention for short sequences, chunked online softmax above
    FULL_ATTN_MAX_SEQ."""
    if max(q.shape[1], k.shape[1]) <= FULL_ATTN_MAX_SEQ:
        return full_attention(q, k, v, causal=causal)
    return chunked_attention(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# Decode paths
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, slot, valid_len):
    """Single-token decode over a pre-written cache (the new token's K/V
    must already sit at `slot`).

    q: (B,1,H,hd); caches (B,S,KV,hd); slot/valid_len: (B,) integer.
    Attends over positions < valid_len plus `slot`.
    """
    h = q.shape[-2]
    s = k_cache.shape[1]
    scale = q.shape[-1] ** -0.5
    k_all = _expand_kv(k_cache, h)
    v_all = _expand_kv(v_cache, h)
    logits = einsum("bqhk,bshk->bhqs", q, k_all, dtype=torch.float32) * scale
    pos = torch.arange(s, device=q.device)[None, :]
    mask = (pos < valid_len[:, None]) | (pos == slot[:, None])
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = einsum("bhqs,bshk->bqhk", w.to(v_all.dtype), v_all,
               dtype=torch.float32)
    return o.to(q.dtype)


def write_kv_slot(k_cache, v_cache, k_new, v_new, slot):
    """Per-batch ring write at `slot`, in place (the reference donates
    its cache and writes it in place too); returns the caches."""
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[bidx, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def decode_attention_seqsharded(q, k_cache, v_cache, k_new, v_new,
                                slot, valid_len, topo):
    """Distributed flash-decode with in-shard cache writes.

    The KV cache is split on its sequence axis across one mesh axis
    (`topo.rules[KV_SEQ]`: `data` for long-context small-batch, `model`
    for big-cache batched decode). Each shard writes the new token's K/V
    iff it owns `slot` (the other shards write back their own old value,
    as the reference does), computes its partial (max, sum-exp,
    weighted V), and the partials combine exactly through `pmax` and
    `psum`, with a guard for shards whose positions are all masked. When
    the axis is `data` the batch is not split.

    The caches are written in place: on repeated devices each shard's
    slice is a view of the one cache tensor; a slice on another device
    is a copy, written back after its shard's write.

    Returns (o, k_cache, v_cache).
    """
    mesh = topo.mesh
    axis = topo.rules[KV_SEQ]
    if axis not in topo.axis_sizes:
        raise ValueError("the sequence-sharded decode needs a KV_SEQ axis "
                         "on the mesh")
    s_local = k_cache.shape[1] // topo.axis_sizes[axis]
    batch_rule = topo.rules[BATCH] if axis != "data" else None
    cache_spec = (batch_rule, axis, None, None)
    rep = (batch_rule, None, None, None)
    caches = [col.shard(c, cache_spec, mesh) for c in (k_cache, v_cache)]
    q_i, kn_i, vn_i = (col.shard(t, rep, mesh) for t in (q, k_new, v_new))
    slot_i, vl_i = (col.shard(t, (batch_rule,), mesh)
                    for t in (slot, valid_len))

    _seq_write(caches[0], caches[1], kn_i, vn_i, slot_i, mesh, axis, s_local)
    for i, pos in enumerate(col.positions(mesh)):
        for full, parts in zip((k_cache, v_cache), caches):
            loc = parts[i]
            if loc.device != full.device:
                idx = col.axis_index(mesh, axis, pos)
                b0 = (col.axis_index(mesh, batch_rule, pos) * loc.shape[0]
                      if batch_rule else 0)
                full[b0:b0 + loc.shape[0],
                     idx * s_local:(idx + 1) * s_local].copy_(loc)
    out = _seq_attend(q_i, caches[0], caches[1], slot_i, vl_i, mesh, axis,
                      s_local)
    return col.unshard(out, rep, mesh, q.device), k_cache, v_cache


def _seq_write(k_parts, v_parts, kn, vn, slot, mesh, axis, s_local):
    """The sequence-sharded decode's write: each distinct cache part (a
    slice of the sequence over `axis`) takes the new token's K/V at its
    local slot iff it owns `slot`, and writes back its own old value
    otherwise, as the reference does; in place, so on repeated devices
    the write lands in the one cache tensor the parts are views of."""
    done = set()
    for i, pos in enumerate(col.positions(mesh)):
        if id(k_parts[i]) in done:
            continue
        done.add(id(k_parts[i]))
        idx = col.axis_index(mesh, axis, pos)
        slot_l = slot[i]
        owns = torch.div(slot_l, s_local, rounding_mode="floor") == idx
        lslot = slot_l % s_local
        bidx = torch.arange(slot_l.shape[0], device=slot_l.device)
        for loc, new in ((k_parts[i], kn[i]), (v_parts[i], vn[i])):
            loc[bidx, lslot] = torch.where(owns[:, None, None],
                                           new[:, 0].to(loc.dtype),
                                           loc[bidx, lslot])


def _seq_attend(q, k_parts, v_parts, slot, valid_len, mesh, axis,
                s_local) -> list:
    """Each shard's partial softmax over its slice of the sequence (all
    query heads), combined exactly by `pmax` and `psum` over `axis`,
    with a guard for shards whose positions are all masked. Returns
    each position's (B, 1, H, hd) output."""
    ms, ls, os_ = [], [], []
    for i, pos in enumerate(col.positions(mesh)):
        idx = col.axis_index(mesh, axis, pos)
        h = q[i].shape[-2]
        scale = q[i].shape[-1] ** -0.5
        dev = slot[i].device
        k_l = _expand_kv(k_parts[i], h)
        v_l = _expand_kv(v_parts[i], h)
        logits = einsum("bqhk,bshk->bhqs", q[i], k_l,
                        dtype=torch.float32) * scale
        gpos = idx * s_local + torch.arange(s_local, device=dev)
        valid = (gpos[None, :] < valid_len[i][:, None]) | (
            gpos[None, :] == slot[i][:, None])
        logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
        m = logits.amax(dim=-1, keepdim=True)  # (b,h,q,1) local max
        p = torch.exp(logits - m)
        ls.append(p.sum(dim=-1, keepdim=True))
        os_.append(einsum("bhqs,bshk->bhqk", p.to(v_l.dtype), v_l,
                          dtype=torch.float32))
        # exact combine across shards (guard all-masked shards)
        ms.append(torch.where(torch.isfinite(m), m, NEG_INF))
    g_m = col.pmax(ms, mesh, axis)
    corr = [torch.exp(m - g) for m, g in zip(ms, g_m)]
    l_g = col.psum([l * c for l, c in zip(ls, corr)], mesh, axis)
    o_g = col.psum([o * c for o, c in zip(os_, corr)], mesh, axis)
    return [(o / torch.clamp_min(l, 1e-30)).transpose(1, 2).to(qi.dtype)
            for o, l, qi in zip(o_g, l_g, q)]


# ---------------------------------------------------------------------------
# On a mesh: the dense attention on each model shard's heads
# ---------------------------------------------------------------------------


def _heads_for(k, n_q: int, q0: int, kv0: int, group: int):
    """The KV heads (B, S, ., hd) that query heads [q0, q0 + n_q) read,
    one a query head: global query head g reads KV head g // group, held
    here at index g // group - kv0 (the map `_expand_kv` makes on one
    device)."""
    if group == 1 and q0 == kv0 and k.shape[-2] == n_q:
        return k
    idx = torch.div(torch.arange(q0, q0 + n_q, device=k.device), group,
                    rounding_mode="floor") - kv0
    return k.index_select(-2, idx)


def _head_offsets(p: Placed, dim: int, topo) -> list:
    """Each position's first global head of `p`'s heads dimension."""
    ax = p.spec[dim]
    n = p.parts[0].shape[dim]
    return [col.axis_index(topo.mesh, ax, pos) * n if ax else 0
            for pos in col.positions(topo.mesh)]


def _project_placed(params, h, cfg, topo, pos=None):
    """Column-parallel Q, K, V on every position: (local params, q, k,
    v, q head offsets, KV head offsets, the gathered `Placed`s)."""
    local, flat = gathered_tree(params, topo)
    if pos is None:
        qkv = col.each(lambda p, x: project_qkv(p, x, cfg), local, h)
    else:
        qkv = col.each(lambda p, x, ps: project_qkv(p, x, cfg, ps[:, None]),
                       local, h, pos)
    q, k, v = ([t[j] for t in qkv] for j in range(3))
    return (q, k, v, _head_offsets(flat["wq"], 1, topo),
            _head_offsets(flat["wk"], 1, topo), flat)


def _out_placed(o, flat, topo, out_spec, scatter_dim=None) -> Placed:
    """`out_proj` on a mesh: row-parallel over the heads, one `psum`
    (or `reduce_scatter`), then `bo` once."""
    y = row_parallel("bshk,hkd->bsd", o, flat["wo"], topo, out_spec,
                     scatter_dim)
    if "bo" in flat:
        y = Placed(col.each(torch.add, y, flat["bo"]), y.spec, y.mesh)
    return y


def attn_full_placed(params, h: Placed, cfg: ModelConfig, topo):
    """Causal attention of a block on a mesh: h a `Placed` (B, S, d)
    (the sequence gathered first where it is split). Returns (y in h's
    layout, {"k", "v"} as `Placed` (B, S, KV, hd) split by KV heads
    where they split)."""
    b_ax, s_ax = h.spec[0], h.spec[1]
    hs = reshard(h, (b_ax, None, None))
    q, k, v, q0, kv0, flat = _project_placed(params, hs, cfg, topo)
    group = cfg.n_heads // cfg.n_kv_heads

    def attend(qq, kk, vv, a, c):
        return attention(qq, _heads_for(kk, qq.shape[-2], a, c, group),
                         _heads_for(vv, qq.shape[-2], a, c, group),
                         causal=True)

    o = col.each(attend, q, k, v, q0, kv0)
    y = _out_placed(o, flat, topo, (b_ax, None, None),
                    1 if s_ax is not None else None)
    kv_spec = (b_ax, None, flat["wk"].spec[1], None)
    return y, {"k": Placed(k, kv_spec, topo.mesh),
               "v": Placed(v, kv_spec, topo.mesh)}


def attn_decode_placed(params, h: Placed, cfg: ModelConfig, topo, cache,
                       pos: Placed):
    """One decode step of a block on a mesh: h a `Placed` (B, 1, d), pos
    (B,) in its batch layout, the cache's "k" / "v" `Placed` by
    `cache_shardings`, written in place. Returns (y, cache)."""
    mesh = topo.mesh
    b_ax = h.spec[0]
    q, k_new, v_new, q0, kv0, flat = _project_placed(params, h, cfg, topo,
                                                     pos)
    kc, vc = cache["k"], cache["v"]
    s = kc.shape[1]
    slot = col.each(lambda ps: torch.clamp_max(ps, s - 1), pos)
    new_spec = (b_ax, None, flat["wk"].spec[1], None)
    to_cache = (kc.spec[0], None, kc.spec[2], None)
    kn = reshard(Placed(k_new, new_spec, mesh), to_cache)
    vn = reshard(Placed(v_new, new_spec, mesh), to_cache)
    slot_c = reshard(Placed(slot, (b_ax,), mesh), (kc.spec[0],))
    axis = topo.rules.get(KV_SEQ)
    if axis:
        s_local = kc.parts[0].shape[1]
        _seq_write(kc, vc, kn, vn, slot_c, mesh, axis, s_local)
        # the reference's shard_map reads every head of its slice
        read = (kc.spec[0], axis, None, None)
        q_all = reshard(Placed(q, (b_ax, None, flat["wq"].spec[1], None),
                               mesh), (kc.spec[0], None, None, None))
        pos_c = reshard(pos, (kc.spec[0],))
        o = _seq_attend(q_all, reshard(kc, read), reshard(vc, read),
                        slot_c, pos_c, mesh, axis, s_local)
        o = reshard(Placed(o, (kc.spec[0], None, None, None), mesh),
                    (b_ax, None, flat["wq"].spec[1], None))
    else:
        done = set()
        for i in range(mesh.size):
            if id(kc[i]) not in done:
                done.add(id(kc[i]))
                write_kv_slot(kc[i], vc[i], kn[i], vn[i], slot_c[i])
        group = cfg.n_heads // cfg.n_kv_heads
        kv0 = _head_offsets(kc, 2, topo)

        def attend(qq, kk, vv, sl, ps, a, c):
            return decode_attention(
                qq, _heads_for(kk, qq.shape[-2], a, c, group),
                _heads_for(vv, qq.shape[-2], a, c, group), sl, valid_len=ps)

        o = col.each(attend, q, kc, vc, slot_c, pos, q0, kv0)
    return _out_placed(o, flat, topo, (b_ax, None, None)), cache
