"""Mixture-of-Experts FFN; port of `repro/models/moe.py`.

Execution paths:

* `moe_dense_oracle` — every expert for every token, weighted by the
  router. O(E·T·d·f): a correctness oracle for tests and checks only.
* `apply_moe` — the routed experts over a static (E, capacity, d)
  buffer: the router's float32 softmax, top-k, a stable sort by expert,
  capacity-factor dropping (a dropped entry contributes zero and its
  token flows through the residual), the experts' batched products and
  the weighted combine; shared experts are a dense FFN added on top.
  On a topology of more than one device it takes the reference's
  `shard_map` paths, each shard's body run in mesh order with the
  collectives of `sharding/collectives.py` between its phases:
  - **EP** (experts split over `model`): each model shard takes a 1/ep
    slice of its data shard's tokens, routes them, packs an (E, cap, d)
    buffer, a tiled `all_to_all` turns it into (E/ep, ep·cap, d) (the
    shards' buffers concatenated in shard order), the local experts run,
    the inverse `all_to_all` returns the outputs and an `all_gather`
    restores the token axis;
  - **EP-small** (decode-sized token counts): every model shard runs
    its local experts over all local tokens (no drops) and the outputs
    `psum` over `model`;
  - **TP-in-expert** (the experts' FFN dimension split over `model`):
    the dispatch is repeated on every model shard, the expert products
    are sliced on the FFN dimension and their outputs `psum` over
    `model`.
  Shared experts are split on their FFN dimension over `model` and
  `psum`'d. `aux` is `pmean`'d over ("model", *data axes) in EP and over
  the data axes in the other two. A `CausalLM` on a mesh hands
  `apply_moe` its normed input as a `Placed` already split by BATCH and
  its weights as `Placed` leaves by `param_shardings`: each weight is
  resharded into its path's layout (gathered over what it does not
  split on: the FSDP axis, the router's experts) and the output comes
  back as a `Placed` in the input's layout. Whole tensors (a test's, an
  oracle's) are split at the call, as views on repeated devices.
  Router aux loss is Switch-style `E · Σ_e f_e · p_e`.

Bits. Top-k is a stable descending sort (`jax.lax.top_k`'s order: among
equal probabilities the lower expert first). The dispatch's scatter
writes one kept entry a slot plus zeros into slot (0, 0) for the
dropped ones, so any order of its adds gives the same buffer. The
combine sums a token's k contributions in one fixed order, the order
in which the reference's serial scatter adds them on the CPU (the
token's entries by their place in the sorted list, i.e. by expert id;
in EP-small by their top-k place), left to right, so a rerun on the
card repeats its bits.

The capacity is per shard: EP computes `_capacity` on its 1/ep slice
of the tokens, so at a factor below E/k it drops other entries than one
device does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, matmul
from repro_torch.models.mlp import apply_mlp
from repro_torch.sharding import collectives as col
from repro_torch.sharding.collectives import Placed, reshard
from repro_torch.sharding.rules import (
    BATCH,
    EMBED,
    EXPERT_FFN,
    EXPERTS,
    Topology,
)


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


def _sum_rows(contrib, t: int):
    """(T·k, d) contributions, token i's in rows i·k .. i·k+k-1, summed
    per token left to right."""
    per_token = contrib.reshape(t, contrib.shape[0] // t, -1)
    y = per_token[:, 0]
    for j in range(1, per_token.shape[1]):
        y = y + per_token[:, j]
    return y


def _combine(out_buf, dst_e, dst_c, keep, token_idx, order, weights, t):
    """(T, d) float32: each token's k weighted expert outputs, summed
    left to right in the order of their places in the sorted list."""
    gathered = out_buf[dst_e, dst_c].to(torch.float32) * keep[:, None]
    w_flat = weights.reshape(-1)[order]
    contrib = gathered * w_flat[:, None]
    # row i: the sorted places of token i's entries, in increasing order
    places = torch.argsort(token_idx, stable=True)
    return _sum_rows(contrib[places], t)


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


def apply_moe(params, x, cfg: ModelConfig, topo: Topology | None = None):
    """x: (B, S, d) -> (y, aux_loss). On a topology of more than one
    device: the reference's choice of path (EP, EP-small or
    TP-in-expert); y is a `Placed` in x's BATCH layout where x is one,
    else joined on the topology's first device."""
    b, s, d = x.shape

    if topo is None or topo.n_devices == 1:
        x_flat = x.reshape(-1, d)
        y, aux = moe_routed_local(params, x_flat, cfg,
                                  capacity=_capacity(cfg, b * s))
        if cfg.n_shared_experts:
            y = y + apply_mlp(params["shared"], x_flat, cfg).to(
                torch.float32)
        return y.to(x.dtype).reshape(b, s, d), aux

    dp = topo.dp_size
    ep = topo.tp_size
    batch_rule = topo.rules[BATCH]
    x_spec = (batch_rule, None, None)
    if isinstance(x, Placed):
        if x.spec[0] != batch_rule:
            raise ValueError(f"apply_moe: the input's batch is split over "
                             f"{x.spec[0]}, the rules say {batch_rule}")
        x = reshard(x, x_spec)
    expert_rule = topo.rules[EXPERTS]
    ffn_rule = topo.rules[EXPERT_FFN]
    # local tokens per data shard
    t_local = (b // max(dp, 1)) * s if batch_rule else b * s

    use_ep = (expert_rule is not None and t_local % ep == 0
              and t_local >= ep * cfg.n_experts_per_token)
    if use_ep:
        return _apply_moe_ep(params, x, cfg, topo, x_spec)
    if expert_rule is not None:
        # decode-sized token counts: the weights stay expert-split; every
        # shard routes the token set against its local experts and the
        # outputs psum over `model`
        return _apply_moe_ep_small(params, x, cfg, topo, x_spec)
    return _apply_moe_tp(params, x, cfg, topo, x_spec, ffn_rule,
                         _capacity(cfg, t_local))


# ---------------------------------------------------------------------------
# The multi-device paths: each shard's body in mesh order, phases between
# the collectives
# ---------------------------------------------------------------------------


def _split_params(params, specs: dict, topo: Topology) -> list[dict]:
    """One parameter dict per mesh position, each leaf in its spec: a
    `Placed` leaf resharded, a whole one split (views on its device)."""
    n = topo.n_devices

    def split(node, spec):
        if isinstance(node, dict):
            per_key = {k: split(node[k], spec[k]) for k in spec}
            return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
        if isinstance(node, Placed):
            return reshard(node, spec).parts
        return col.shard(node, spec, topo.mesh)

    return split(params, specs)


def _parts(x, x_spec, mesh) -> list:
    return x.parts if isinstance(x, Placed) else col.shard(x, x_spec, mesh)


def _param_specs(cfg: ModelConfig, w_e, w_d, shared_ax) -> dict:
    specs = {"router": (None, None), "w_gate": w_e, "w_up": w_e,
             "w_down": w_d}
    if cfg.n_shared_experts:
        specs["shared"] = {"w_gate": (None, shared_ax),
                           "w_up": (None, shared_ax),
                           "w_down": (shared_ax, None)}
    return specs


def _shared_psum(params_i, x_flat, cfg, topo, ax) -> list:
    """The shared experts' partial outputs (float32) on each shard,
    psum'd over `ax` where their FFN dimension is split."""
    ys = [apply_mlp(p["shared"], xf, cfg).to(torch.float32)
          for p, xf in zip(params_i, x_flat)]
    return col.psum(ys, topo.mesh, ax) if ax else ys


def _finish(y, aux, x, x_parts, x_spec, topo: Topology):
    """The shards' (T, d) outputs in x's layout (a `Placed`), or joined
    by x_spec on the topology's first device for a whole x; aux is
    replicated: shard 0's."""
    done: dict = {}
    for yi, xp in zip(y, x_parts):
        if (id(yi), id(xp)) not in done:
            done[(id(yi), id(xp))] = yi.to(xp.dtype).reshape(xp.shape)
    y = [done[(id(yi), id(xp))] for yi, xp in zip(y, x_parts)]
    aux = aux[0].to(topo.device)
    if isinstance(x, Placed):
        return Placed(y, x_spec, topo.mesh), aux
    return col.unshard(y, x_spec, topo.mesh, topo.device), aux


def _apply_moe_tp(params, x, cfg: ModelConfig, topo: Topology, x_spec,
                  ffn_rule, capacity: int):
    """TP-in-expert: the dispatch repeated over `model`, the expert
    products sliced on their FFN dimension, outputs psum'd over
    `model`."""
    mesh = topo.mesh
    d = x.shape[-1]
    p_specs = _param_specs(cfg, (None, None, ffn_rule),
                           (None, ffn_rule, None), ffn_rule)
    params_i = _split_params(params, p_specs, topo)
    x_parts = _parts(x, x_spec, mesh)
    x_flat = [xp.reshape(-1, d) for xp in x_parts]

    routed, out_bufs = [], []
    for p, xf in zip(params_i, x_flat):
        probs, weights, expert_ids = route(p, xf, cfg)
        disp = _dispatch(xf, expert_ids, cfg, capacity)
        out_bufs.append(_expert_ffn(cfg, p["w_gate"], p["w_up"],
                                    p["w_down"], disp[0]))
        routed.append((probs, weights, expert_ids, disp[1:]))
    if ffn_rule:
        out_bufs = col.psum(out_bufs, mesh, "model")
    y, aux = [], []
    for out_buf, xf, (probs, weights, expert_ids, disp) in zip(
            out_bufs, x_flat, routed):
        y.append(_combine(out_buf, *disp, weights, xf.shape[0]))
        aux.append(_aux_loss(probs, expert_ids, cfg))
    if cfg.n_shared_experts:
        ys = _shared_psum(params_i, x_flat, cfg, topo, ffn_rule)
        y = [a + b for a, b in zip(y, ys)]
    if topo.data_axes:
        aux = col.pmean(aux, mesh, topo.data_axes)
    return _finish(y, aux, x, x_parts, x_spec, topo)


def _apply_moe_ep_small(params, x, cfg: ModelConfig, topo: Topology,
                        x_spec):
    """Expert-parallel MoE for small token counts (decode): each model
    shard computes its local experts over all local tokens; outputs
    combine with one psum. No weight movement."""
    mesh = topo.mesh
    d = x.shape[-1]
    e, k = cfg.n_experts, cfg.n_experts_per_token
    e_local = e // topo.tp_size
    w_e = ("model", None, None)
    params_i = _split_params(params, _param_specs(cfg, w_e, w_e, "model"),
                             topo)
    x_parts = _parts(x, x_spec, mesh)
    y, aux = [], []
    for pos, p, xp in zip(col.positions(mesh), params_i, x_parts):
        x_flat = xp.reshape(-1, d)
        t = x_flat.shape[0]
        dev = x_flat.device
        e_lo = col.axis_index(mesh, "model", pos) * e_local
        probs, weights, expert_ids = route(p, x_flat, cfg)
        cap = t * k  # no drops at decode size
        flat_ids = expert_ids.reshape(-1)
        owned = (flat_ids >= e_lo) & (flat_ids < e_lo + e_local)
        local_ids = torch.where(owned, flat_ids - e_lo, 0)
        slot = torch.arange(t * k, device=dev)
        token_idx = slot // k
        src = x_flat[token_idx] * owned[:, None].to(x_flat.dtype)
        buf = torch.zeros((e_local, cap, d), dtype=x_flat.dtype,
                          device=dev).index_put((local_ids, slot), src,
                                                accumulate=True)
        out = _expert_ffn(cfg, p["w_gate"], p["w_up"], p["w_down"], buf)
        gathered = out[local_ids, slot].to(torch.float32) * owned[:, None]
        yi = _sum_rows(gathered * weights.reshape(-1)[:, None], t)
        if cfg.n_shared_experts:
            # shared partials join the same psum below
            yi = yi + apply_mlp(p["shared"], x_flat, cfg).to(torch.float32)
        y.append(yi)
        aux.append(_aux_loss(probs, expert_ids, cfg))
    y = col.psum(y, mesh, "model")
    if topo.data_axes:
        aux = col.pmean(aux, mesh, topo.data_axes)
    return _finish(y, aux, x, x_parts, x_spec, topo)


def _apply_moe_ep(params, x, cfg: ModelConfig, topo: Topology, x_spec):
    """Expert parallelism with token-slicing over `model` during
    dispatch."""
    mesh = topo.mesh
    d = x.shape[-1]
    ep = topo.tp_size
    w_e = ("model", None, None)
    params_i = _split_params(params, _param_specs(cfg, w_e, w_e, "model"),
                             topo)
    x_parts = _parts(x, x_spec, mesh)
    x_flat = [xp.reshape(-1, d) for xp in x_parts]

    routed, bufs = [], []
    for pos, p, xf in zip(col.positions(mesh), params_i, x_flat):
        tm = xf.shape[0] // ep
        idx = col.axis_index(mesh, "model", pos)
        x_me = xf[idx * tm:(idx + 1) * tm]
        probs, weights, expert_ids = route(p, x_me, cfg)
        disp = _dispatch(x_me, expert_ids, cfg, _capacity(cfg, tm))
        bufs.append(disp[0])
        routed.append((probs, weights, expert_ids, disp[1:], tm))
    # (E, cap, d) -> (E/ep, ep*cap, d): shard i keeps experts
    # [i*e_local, (i+1)*e_local) with the buffers of every model shard
    bufs = col.all_to_all(bufs, mesh, "model", split_axis=0, concat_axis=1)
    outs = [_expert_ffn(cfg, p["w_gate"], p["w_up"], p["w_down"],
                        buf).to(xf.dtype)
            for p, buf, xf in zip(params_i, bufs, x_flat)]
    del bufs
    # inverse exchange: (E/ep, ep*cap, d) -> (E, cap, d)
    outs = col.all_to_all(outs, mesh, "model", split_axis=1, concat_axis=0)
    y_me, aux = [], []
    for out, (probs, weights, expert_ids, disp, tm) in zip(outs, routed):
        y_me.append(_combine(out, *disp, weights, tm))
        aux.append(_aux_loss(probs, expert_ids, cfg))
    del outs
    y = col.all_gather(y_me, mesh, "model", dim=0)  # (t, d)
    if cfg.n_shared_experts:
        # shared experts: TP over `model` on the FFN dim, on the full
        # local token set (every shard holds all t tokens)
        ys = _shared_psum(params_i, x_flat, cfg, topo, "model")
        y = [a + b for a, b in zip(y, ys)]
    aux = col.pmean(aux, mesh, ("model", *topo.data_axes))
    return _finish(y, aux, x, x_parts, x_spec, topo)


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
