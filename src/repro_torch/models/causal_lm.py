"""Decoder-only causal LM (dense / MoE / VLM families); port of
`repro/models/causal_lm.py`.

Public surface:
  model = build_model(cfg)              # on the CUDA device; device="cpu"
  model.init(generator)                 # seeded weights (or load_state_dict)
  loss, metrics = model.loss(batch)     # or model.loss(batch, params=tree)
  cache, logits = model.prefill(batch, cache_len)
  logits, cache = model.decode_step(cache, token, pos)

Batch dict:
  tokens: (B, S_text) integer
  targets/loss_mask: (B, S) — loss only
  embeds: (B, P, d) — VLM frontends: precomputed prefix embeddings

The parameters are the module's, named after the reference's tree
("embed", "blocks.prefix.0.norm1.scale", "blocks.stack.l0.mixer.wq",
"final_norm.scale", "head"), with the repeated layers stacked on a
leading axis, so `interop.lm_params_from_reference` carries the
reference's weights over leaf for leaf. They do not require grad:
`forward`, `prefill` and `decode_step` serve without autograd, and
`loss` is differentiable in an explicit parameter tree
(`train.step.make_train_step` passes one that requires grad).

On a `Topology` of more than one device the MoE FFN takes its
multi-device paths and decode its sequence-sharded path where the
topology's rules say so; the dense layers (embedding, norms, attention
projections, MLP, logits) run unsplit on the mesh's first device, where
the parameters live. `param_shardings` and `cache_shardings` give the
reference's specs; placing the dense layers by them (tensor-parallel
attention and MLP, FSDP) is ROADMAP queue 1 item 18e. A
sequence-sharded cache is one tensor on the first device whose slices
by its spec are the shards' caches.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.common import (
    DTYPES,
    ParamDef,
    flatten_defs,
    init_one,
    matmul,
    param_shardings,
)
from repro_torch.models.norms import apply_norm, norm_defs
from repro_torch.sharding.rules import (
    EMBED,
    KV_SEQ,
    LAYERS,
    VOCAB,
    Topology,
    smoke_topology,
)
from repro_torch.tree import tree_flatten_with_path

PAD_LOGIT = -1e30  # padded vocabulary entries


def model_defs(cfg: ModelConfig) -> dict:
    """The model's parameter DefTree (the reference's `CausalLM.defs`)."""
    d: dict = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), (VOCAB, EMBED),
                          init="embed", scale=0.02),
        "blocks": blocks.stack_defs(cfg, cfg.layer_specs()),
        "final_norm": norm_defs(cfg.d_model, cfg.norm),
    }
    if not cfg.tie_embeddings:
        d["head"] = ParamDef((cfg.d_model, cfg.padded_vocab), (EMBED, VOCAB))
    return d


class _Node(nn.Module):
    """One inner node of the parameter tree."""


def _register(module: nn.Module, defs: dict, dtype, device) -> None:
    for k, d in defs.items():
        if isinstance(d, ParamDef):
            module.register_parameter(k, nn.Parameter(
                torch.empty(d.shape, dtype=d.dtype or dtype, device=device),
                requires_grad=False))
        elif isinstance(d, dict):
            child = _Node()
            _register(child, d, dtype, device)
            module.add_module(k, child)
        else:
            children = []
            for sub in d:
                child = _Node()
                _register(child, sub, dtype, device)
                children.append(child)
            module.add_module(k, nn.ModuleList(children))


def _tree(module: nn.Module) -> dict:
    """The module's parameters as the reference's nested dict / list."""
    out = dict(module.named_parameters(recurse=False))
    for k, child in module.named_children():
        out[k] = ([_tree(c) for c in child]
                  if isinstance(child, nn.ModuleList) else _tree(child))
    return out


class CausalLM(nn.Module):
    """The model on the topology's first device, else on `device`
    (default: the CUDA device) under the one-device topology. The
    parameters are allocated, not initialised: call `init(generator)` or
    `load_state_dict`."""

    def __init__(self, cfg: ModelConfig, topo: Optional[Topology] = None,
                 *, device=None):
        super().__init__()
        self.cfg = cfg
        self.specs = cfg.layer_specs()
        self.topo = (topo if topo is not None
                     else smoke_topology(cfg, device=resolve_device(device)))
        self.device = self.topo.device
        _register(self, model_defs(cfg), DTYPES[cfg.dtype], self.device)

    # ------------------------------------------------------------- params
    def defs(self) -> dict:
        return model_defs(self.cfg)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "CausalLM":
        """Fill every parameter by the reference's init rules, the leaves
        drawn in `flatten_defs` order from `generator` (a generator on
        this model's device). One leaf's float32 draw is alive at a
        time; `copy_` rounds it into the parameter's dtype, as the
        reference's cast does, without a second temporary."""
        params = dict(self.named_parameters())
        for name, d in flatten_defs(self.defs()):
            params[name].copy_(init_one(d, torch.float32, generator,
                                        self.device))
        return self

    def params(self) -> dict:
        return _tree(self)

    def param_shardings(self) -> dict:
        """Each parameter's `NamedSharding` on the topology's mesh, as
        the reference's `param_shardings` resolves it (fsdp=True)."""
        return param_shardings(self.defs(), self.topo)

    # ------------------------------------------------------------ forward
    def _tensor(self, a, dtype=None, device=None):
        return torch.as_tensor(a, dtype=dtype, device=device or self.device)

    def _embed(self, params, batch):
        cfg = self.cfg
        dev = params["embed"].device  # a data-parallel replica's device
        tok_emb = params["embed"][self._tensor(batch["tokens"], torch.long,
                                               dev)]
        if cfg.frontend != "none" and "embeds" in batch:
            return torch.cat([self._tensor(batch["embeds"], device=dev).to(
                tok_emb.dtype), tok_emb], dim=1)
        return tok_emb

    def _logits(self, params, x):
        cfg = self.cfg
        x = apply_norm(params["final_norm"], x, cfg.norm)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        logits = matmul(x, head, dtype=torch.float32)
        pad_mask = torch.where(
            torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size,
            0.0, PAD_LOGIT)
        return logits + pad_mask

    def _forward(self, batch, mode: str, params=None):
        params = self.params() if params is None else params
        x = self._embed(params, batch)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :]
        x, cache, aux = blocks.apply_stack(params["blocks"], x, self.cfg,
                                           self.topo, self.specs, mode=mode,
                                           positions=positions)
        return self._logits(params, x), cache, aux

    @torch.no_grad()
    def forward(self, batch, mode: str = "full"):
        """Returns (logits, cache_or_empty, aux); aux is the router's
        loss term summed over the layers (0 without experts)."""
        return self._forward(batch, mode)

    # --------------------------------------------------------------- loss
    def loss(self, batch, params=None):
        """(loss, metrics) of `batch` under `params` (default: the
        module's own), differentiable where the parameters require
        grad."""
        logits, _, aux = self._forward(batch, "full", params)
        return lm_loss(logits, batch, self.cfg, aux)

    # -------------------------------------------------------------- serve
    def prefill(self, batch, cache_len: int | None = None):
        logits, cache, _ = self.forward(batch, mode="prefill")
        if cache_len is not None:
            cache = blocks.pad_cache(cache, cache_len)
        return self._place_cache(cache), logits[:, -1:]

    def init_cache(self, batch_size: int, cache_len: int):
        return self._place_cache(blocks.stack_cache_init(
            self.cfg, self.specs, batch_size, cache_len,
            DTYPES[self.cfg.dtype], self.device))

    def cache_shardings(self) -> dict:
        """Each cache leaf's `NamedSharding` (`block_cache_logical`, with
        the stacked axis first under "stack"), as the reference's
        `cache_shardings`."""
        groups = blocks.layer_groups(self.specs)

        def entry(spec, stacked: bool):
            logical = blocks.block_cache_logical(self.cfg, spec)
            return {k: self.topo.named((LAYERS, *ax) if stacked else ax)
                    for k, ax in logical.items()}

        out: dict = {"prefix": [entry(s, False) for s in groups.prefix]}
        if groups.n_repeat:
            out["stack"] = {f"l{j}": entry(s, True)
                            for j, s in enumerate(groups.pattern)}
        return out

    def _place_cache(self, cache):
        """The cache as `cache_shardings` places it: one tensor on the
        first device, which the sequence-sharded decode splits by its
        spec (views on repeated devices). A cache length that does not
        split over the KV_SEQ axis is refused here rather than at the
        first decode step."""
        axis = self.topo.rules[KV_SEQ]
        if axis:
            n = self.topo.axis_sizes[axis]
            for path, leaf in tree_flatten_with_path(cache):
                if leaf.shape[-3] % n:
                    raise ValueError(
                        f"cache leaf {path}: {leaf.shape[-3]} slots do not "
                        f"split over {axis} ({n} shards)")
        return cache

    @torch.no_grad()
    def decode_step(self, cache, token, pos):
        """token: (B,1) integer; pos: (B,) integer write/mask index.
        Writes the token's K/V into `cache` in place and returns it."""
        params = self.params()
        x = params["embed"][self._tensor(token, torch.long)]
        x, new_cache, _ = blocks.apply_stack(
            params["blocks"], x, self.cfg, self.topo, self.specs,
            mode="decode",
            cache=cache, pos=self._tensor(pos, torch.long))
        return self._logits(params, x), new_cache


def lm_loss(logits, batch, cfg: ModelConfig, aux):
    """Cross-entropy over the unpadded vocabulary + router aux."""
    targets = torch.as_tensor(batch["targets"], dtype=torch.long,
                              device=logits.device)
    mask = batch.get("loss_mask")
    mask = (torch.ones(targets.shape, dtype=torch.float32,
                       device=logits.device) if mask is None else
            torch.as_tensor(mask, dtype=torch.float32, device=logits.device))
    # align: logits predict the NEXT token; batch supplies aligned targets
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.take_along_dim(logp, targets[..., None], dim=-1)[..., 0]
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = -(ll * mask).sum() / denom
    total = ce + cfg.router_aux_loss * aux
    metrics = {"ce": ce, "aux": aux, "tokens": denom}
    return total, metrics
