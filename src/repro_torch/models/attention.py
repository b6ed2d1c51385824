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
(`sharding/collectives.py`), the shards run in mesh order. Its
projections run unsplit on the topology's first device (item 18e).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, einsum
from repro_torch.models.rope import apply_rope
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
    y = einsum("bshk,hkd->bsd", o, params["wo"])
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
    from repro_torch.sharding import collectives as col

    mesh = topo.mesh
    axis = topo.rules[KV_SEQ]
    if axis not in topo.axis_sizes:
        raise ValueError("the sequence-sharded decode needs a KV_SEQ axis "
                         "on the mesh")
    h = q.shape[-2]
    scale = q.shape[-1] ** -0.5
    s_local = k_cache.shape[1] // topo.axis_sizes[axis]
    batch_rule = topo.rules[BATCH] if axis != "data" else None
    cache_spec = (batch_rule, axis, None, None)
    rep = (batch_rule, None, None, None)
    caches = [col.shard(c, cache_spec, mesh) for c in (k_cache, v_cache)]
    q_i, kn_i, vn_i = (col.shard(t, rep, mesh) for t in (q, k_new, v_new))
    slot_i, vl_i = (col.shard(t, (batch_rule,), mesh)
                    for t in (slot, valid_len))

    ms, ls, os_ = [], [], []
    for i, pos in enumerate(col.positions(mesh)):
        idx = col.axis_index(mesh, axis, pos)
        slot_l, vl = slot_i[i], vl_i[i]
        dev = slot_l.device
        # write the new token's K/V into the owning shard's slice
        owns = torch.div(slot_l, s_local, rounding_mode="floor") == idx
        lslot = slot_l % s_local
        bidx = torch.arange(slot_l.shape[0], device=dev)
        for full, parts, new in zip((k_cache, v_cache), caches,
                                    (kn_i[i], vn_i[i])):
            loc = parts[i]
            loc[bidx, lslot] = torch.where(owns[:, None, None],
                                           new[:, 0].to(loc.dtype),
                                           loc[bidx, lslot])
            if loc.device != full.device:
                b0 = (col.axis_index(mesh, batch_rule, pos) * loc.shape[0]
                      if batch_rule else 0)
                full[b0:b0 + loc.shape[0],
                     idx * s_local:(idx + 1) * s_local].copy_(loc)
        k_l = _expand_kv(caches[0][i], h)
        v_l = _expand_kv(caches[1][i], h)
        logits = einsum("bqhk,bshk->bhqs", q_i[i], k_l,
                        dtype=torch.float32) * scale
        gpos = idx * s_local + torch.arange(s_local, device=dev)
        valid = (gpos[None, :] < vl[:, None]) | (gpos[None, :]
                                                 == slot_l[:, None])
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
    out = [(o / torch.clamp_min(l, 1e-30)).transpose(1, 2).to(q.dtype)
           for o, l in zip(o_g, l_g)]
    return col.unshard(out, rep, mesh, q.device), k_cache, v_cache
