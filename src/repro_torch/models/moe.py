"""Mixture-of-Experts FFN on one device; port of the single-device half
of `repro/models/moe.py`.

* `apply_moe` — the routed experts over a static (E, capacity, d)
  buffer: the router's float32 softmax, top-k, a stable sort by expert,
  capacity-factor dropping (a dropped entry contributes zero and its
  token flows through the residual), the experts' batched products and
  the weighted combine; shared experts are a dense FFN added on top.
  Router aux loss is Switch-style `E · Σ_e f_e · p_e`.
* `moe_dense_oracle` — every expert for every token, weighted by the
  router. O(E·T·d·f): a correctness oracle for tests and checks only.

The expert-parallel and TP-in-expert paths of the reference's
`apply_moe` (its `shard_map` branches, `_apply_moe_ep_small`,
`_apply_moe_ep`) need more than one device: ROADMAP queue 1 item 18d.

Bits. Top-k is a stable descending sort (`jax.lax.top_k`'s order: among
equal probabilities the lower expert first). The dispatch's scatter
writes one kept entry a slot plus zeros into slot (0, 0) for the
dropped ones, so any order of its adds gives the same buffer. The
combine sums a token's k contributions in one fixed order, the order
in which the reference's serial scatter adds them on the CPU (the
token's entries by their place in the sorted list, i.e. by expert id),
left to right, so a rerun on the card repeats its bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, matmul
from repro_torch.models.mlp import apply_mlp
from repro_torch.sharding.rules import EMBED, EXPERT_FFN, EXPERTS

MULTI_DEVICE_UNPORTED = (
    "the expert-parallel and TP-in-expert MoE paths need more than one "
    "device: ROADMAP queue 1 item 18d")


def moe_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    e = cfg.n_experts
    defs = {
        "router": ParamDef((d, e), (EMBED, EXPERTS)),
        "w_gate": ParamDef((e, d, f), (EXPERTS, EMBED, EXPERT_FFN)),
        "w_up": ParamDef((e, d, f), (EXPERTS, EMBED, EXPERT_FFN)),
        "w_down": ParamDef((e, f, d), (EXPERTS, EXPERT_FFN, EMBED)),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        defs["shared"] = {
            "w_gate": ParamDef((d, fs), (EMBED, EXPERT_FFN)),
            "w_up": ParamDef((d, fs), (EMBED, EXPERT_FFN)),
            "w_down": ParamDef((fs, d), (EXPERT_FFN, EMBED)),
        }
    return defs


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.n_experts_per_token
            / cfg.n_experts)
    return max(cfg.n_experts_per_token, c)


def _router_probs(params, x, cfg: ModelConfig):
    logits = matmul(x, params["router"], dtype=torch.float32)
    return torch.softmax(logits, dim=-1)


def _top_k(probs, k: int):
    """(weights, expert ids) of the k largest probabilities, descending,
    the lower expert first among equals (`jax.lax.top_k`)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def route(params, x_flat, cfg: ModelConfig):
    """(probs (T, E), normalised top-k weights (T, k), expert ids
    (T, k)) of the router on x_flat (T, d)."""
    probs = _router_probs(params, x_flat, cfg)
    weights, expert_ids = _top_k(probs, cfg.n_experts_per_token)
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    return probs, weights, expert_ids


def _aux_loss(probs, expert_ids, cfg: ModelConfig):
    counts = torch.bincount(expert_ids.reshape(-1),
                            minlength=cfg.n_experts).to(torch.float32)
    f = counts / torch.tensor(probs.shape[0] * cfg.n_experts_per_token,
                              dtype=torch.float32, device=probs.device)
    p = probs.mean(dim=0)
    return cfg.n_experts * torch.sum(f * p)


def _act(cfg: ModelConfig, x):
    if cfg.mlp_variant == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def _expert_ffn(cfg, w_gate, w_up, w_down, h):
    """h: (E, C, d); weights (E, d, f)/(E, f, d). float32 out."""
    up = matmul(h, w_up, dtype=torch.float32)
    gate = matmul(h, w_gate, dtype=torch.float32)
    inner = (_act(cfg, gate) * up).to(h.dtype)
    return matmul(inner, w_down, dtype=torch.float32)


def _dispatch(x_flat, expert_ids, cfg: ModelConfig, capacity: int):
    """Pack tokens into a static (E, capacity, d) buffer, sorted by expert.

    Returns (buffer, dst_e, dst_c, keep, token_idx, order)."""
    t, d = x_flat.shape
    e, k = cfg.n_experts, cfg.n_experts_per_token
    dev = x_flat.device
    flat_ids = expert_ids.reshape(-1)  # (T*k,)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    counts = torch.bincount(flat_ids, minlength=e)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=dev) - offsets[sorted_ids]
    keep = rank < capacity
    token_idx = order // k
    dst_e = torch.where(keep, sorted_ids, 0)
    dst_c = torch.where(keep, rank, 0)
    src = x_flat[token_idx] * keep[:, None].to(x_flat.dtype)
    buf = torch.zeros((e, capacity, d), dtype=x_flat.dtype,
                      device=dev).index_put((dst_e, dst_c), src,
                                            accumulate=True)
    return buf, dst_e, dst_c, keep, token_idx, order


def _combine(out_buf, dst_e, dst_c, keep, token_idx, order, weights, t):
    """(T, d) float32: each token's k weighted expert outputs, summed
    left to right in the order of their places in the sorted list."""
    gathered = out_buf[dst_e, dst_c].to(torch.float32) * keep[:, None]
    w_flat = weights.reshape(-1)[order]
    contrib = gathered * w_flat[:, None]
    k = order.shape[0] // t
    # row i: the sorted places of token i's entries, in increasing order
    places = torch.argsort(token_idx, stable=True).reshape(t, k)
    per_token = contrib[places]  # (T, k, d)
    y = per_token[:, 0]
    for j in range(1, k):
        y = y + per_token[:, j]
    return y


def moe_routed_local(params, x_flat, cfg: ModelConfig, *, capacity: int):
    """Routed experts over local tokens (no shared experts). (T,d)->(T,d)
    float32, and the aux loss."""
    t, _ = x_flat.shape
    probs, weights, expert_ids = route(params, x_flat, cfg)
    buf, dst_e, dst_c, keep, token_idx, order = _dispatch(
        x_flat, expert_ids, cfg, capacity)
    out_buf = _expert_ffn(cfg, params["w_gate"], params["w_up"],
                          params["w_down"], buf)
    y = _combine(out_buf, dst_e, dst_c, keep, token_idx, order, weights, t)
    return y, _aux_loss(probs, expert_ids, cfg)


def apply_moe(params, x, cfg: ModelConfig, topo=None):
    """x: (B, S, d) -> (y, aux_loss) on one device. A topology of more
    than one device raises NotImplementedError (item 18d)."""
    if topo is not None and topo.n_devices > 1:
        raise NotImplementedError(MULTI_DEVICE_UNPORTED)
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    y, aux = moe_routed_local(params, x_flat, cfg,
                              capacity=_capacity(cfg, b * s))
    if cfg.n_shared_experts:
        y = y + apply_mlp(params["shared"], x_flat, cfg).to(torch.float32)
    return y.to(x.dtype).reshape(b, s, d), aux


def moe_dense_oracle(params, x, cfg: ModelConfig):
    """All-experts reference (tests and checks only)."""
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    probs, weights, expert_ids = route(params, x_flat, cfg)
    h = x_flat[None].expand(cfg.n_experts, t, d).contiguous()  # (E,T,d)
    out_all = _expert_ffn(cfg, params["w_gate"], params["w_up"],
                          params["w_down"], h)  # (E,T,d) float32
    gate = torch.zeros((t, cfg.n_experts), dtype=torch.float32,
                       device=x.device).index_put(
        (torch.arange(t, device=x.device)[:, None], expert_ids), weights,
        accumulate=True)
    y = torch.einsum("etd,te->td", out_all, gate)
    aux = _aux_loss(probs, expert_ids, cfg)
    if cfg.n_shared_experts:
        y = y + apply_mlp(params["shared"], x_flat, cfg).to(torch.float32)
    return y.to(x.dtype).reshape(b, s, d), aux
