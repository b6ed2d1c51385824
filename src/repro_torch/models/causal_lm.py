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

On a `Topology` of more than one device the parameters are held as the
parts `param_shardings` gives (`collectives.Placed` leaves: views of
one tensor on repeated devices, copies on distinct ones; no leaf is
held whole on the first device), and every layer runs on them as the
reference's GSPMD does: a vocab-parallel embedding (each model shard
looks up its rows, the others give zeros, one `psum`), tensor-parallel
attention and MLP, FSDP gathers right before each use, and a
vocab-parallel head whose padded tail is masked on the shard that holds
it. The cache is a tree of `Placed` leaves by `cache_shardings`.
`forward`, `prefill` and `decode_step` return whole logits on the first
device; `loss` gathers the vocabulary of each data shard's logits and
sums the shards' cross-entropy terms in shard order. `state_dict` and
`load_state_dict` take whole leaves on any topology, and `init` draws
each leaf whole in `flatten_defs` order and then splits it, so a mesh
model and a one-device model from one seed hold the same weights.
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
    gathered,
    gathered_tree,
    init_one,
    matmul,
    param_shardings,
    place_params,
)
from repro_torch.models.norms import apply_norm, norm_defs
from repro_torch.sharding import collectives as col
from repro_torch.sharding.collectives import Placed, reshard
from repro_torch.sharding.rules import (
    BATCH,
    EMBED,
    KV_SEQ,
    LAYERS,
    SEQ,
    VOCAB,
    Topology,
    smoke_topology,
)
from repro_torch.tree import tree_flatten_with_path, tree_map

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


def _placed_tree(defs, shardings, dtype):
    """Uninitialised `Placed` leaves of a DefTree, by its shardings."""
    if isinstance(defs, ParamDef):
        return Placed.empty(defs.shape, defs.dtype or dtype,
                            shardings.spec, shardings.mesh)
    if isinstance(defs, dict):
        return {k: _placed_tree(v, shardings[k], dtype)
                for k, v in defs.items()}
    return [_placed_tree(v, sh, dtype) for v, sh in zip(defs, shardings)]


def _named(tree, prefix: str = "") -> list:
    """(dotted name, leaf) of a parameter tree, in `flatten_defs` order."""
    if not isinstance(tree, (dict, list)):
        return [(prefix, tree)]
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else [(str(i), v) for i, v in enumerate(tree)])
    out = []
    for k, v in items:
        out.extend(_named(v, f"{prefix}.{k}" if prefix else k))
    return out


def _tree(module: nn.Module) -> dict:
    """The module's parameters as the reference's nested dict / list."""
    out = dict(module.named_parameters(recurse=False))
    for k, child in module.named_children():
        out[k] = ([_tree(c) for c in child]
                  if isinstance(child, nn.ModuleList) else _tree(child))
    return out


class CausalLM(nn.Module):
    """The model on the topology (its parameters placed by their specs
    on a mesh of more than one device), else on `device` (default: the
    CUDA device) under the one-device topology. The parameters are
    allocated, not initialised: call `init(generator)` or
    `load_state_dict`. On a mesh, `params` (a tree of whole leaves, as
    another model's `params()`) is placed instead: views of its tensors
    where a part's device is theirs, so no copy on repeated devices."""

    def __init__(self, cfg: ModelConfig, topo: Optional[Topology] = None,
                 *, device=None, params=None):
        super().__init__()
        self.cfg = cfg
        self.specs = cfg.layer_specs()
        self.topo = (topo if topo is not None
                     else smoke_topology(cfg, device=resolve_device(device)))
        self.device = self.topo.device
        self.placed = self.topo.n_devices > 1
        self._parts = None
        if self.placed:
            self._given = params
        elif params is not None:
            raise ValueError("params= places a tree on a mesh of more than "
                             "one device")
        else:
            _register(self, model_defs(cfg), DTYPES[cfg.dtype], self.device)

    # ------------------------------------------------------------- params
    @property
    def _placed(self) -> dict:
        """The `Placed` parameter tree of a mesh model, allocated (or
        placed from the given tree) at first use, so a model built only
        for its specs allocates nothing."""
        if self._parts is None:
            sh = self.param_shardings()
            self._parts = (place_params(self._given, sh)
                           if self._given is not None else
                           _placed_tree(model_defs(self.cfg), sh,
                                        DTYPES[self.cfg.dtype]))
            self._given = None
        return self._parts

    def defs(self) -> dict:
        return model_defs(self.cfg)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "CausalLM":
        """Fill every parameter by the reference's init rules, the leaves
        drawn in `flatten_defs` order from `generator` (a generator on
        this model's device). One leaf's float32 draw is alive at a
        time; `copy_` rounds it into the parameter's dtype, as the
        reference's cast does, without a second temporary."""
        params = (dict(_named(self._placed)) if self.placed
                  else dict(self.named_parameters()))
        for name, d in flatten_defs(self.defs()):
            params[name].copy_(init_one(d, torch.float32, generator,
                                        self.device))
        return self

    def params(self) -> dict:
        """The parameter tree: the module's tensors, or on a mesh its
        `Placed` leaves."""
        return self._placed if self.placed else _tree(self)

    def state_dict(self, *args, **kwargs):
        """Whole leaves by name (on a mesh, joined on the first
        device)."""
        if not self.placed:
            return super().state_dict(*args, **kwargs)
        return {name: p.whole() for name, p in _named(self._placed)}

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """Whole leaves by name, copied into the parameters (on a mesh,
        each into its parts)."""
        if not self.placed:
            return super().load_state_dict(state_dict, strict, assign)
        placed = dict(_named(self._placed))
        missing = sorted(set(placed) - set(state_dict))
        unexpected = sorted(set(state_dict) - set(placed))
        if strict and (missing or unexpected):
            raise RuntimeError(f"load_state_dict: missing {missing}, "
                               f"unexpected {unexpected}")
        for name, t in state_dict.items():
            if name in placed:
                placed[name].copy_(torch.as_tensor(t))
        return nn.modules.module._IncompatibleKeys(missing, unexpected)

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

    def _embed_placed(self, params, batch) -> Placed:
        """The vocab-parallel lookup: each model shard takes the rows it
        holds (zeros for the others' tokens), one `psum` joins them
        (exact: one term is nonzero)."""
        topo, mesh = self.topo, self.topo.mesh
        emb = gathered(params["embed"], topo)
        tokens = topo.constrain(self._tensor(batch["tokens"], torch.long),
                                BATCH, None)
        ax, rows = emb.spec[0], emb.parts[0].shape[0]
        if ax is None:
            x = col.each(lambda e, t: e[t], emb, tokens)
        else:
            lo = [col.axis_index(mesh, ax, pos) * rows
                  for pos in col.positions(mesh)]

            def lookup(e, t, first):
                loc = t - first
                hit = (loc >= 0) & (loc < rows)
                return torch.where(hit[..., None],
                                   e[torch.where(hit, loc, 0)], 0)

            x = col.psum(col.each(lookup, emb, tokens, lo), mesh, ax)
        x = Placed(x, (tokens.spec[0], None, None), mesh)
        if self.cfg.frontend != "none" and "embeds" in batch:
            e = topo.constrain(self._tensor(batch["embeds"]), BATCH, None,
                               None)
            x = Placed(col.each(lambda a, b: torch.cat(
                [a.to(b.dtype), b], dim=1), e, x), x.spec, mesh)
        return topo.constrain(x, BATCH, SEQ, EMBED)

    def _logits_placed(self, params, x: Placed) -> Placed:
        """The vocab-parallel head: each model shard's slice of
        `padded_vocab`, the pad mask on the slice it holds. Returns a
        `Placed` (B, S, padded_vocab) split by VOCAB."""
        topo, mesh, cfg = self.topo, self.topo.mesh, self.cfg
        x = reshard(x, (x.spec[0], None, None))
        local, _ = gathered_tree(params["final_norm"], topo)
        h = col.each(lambda p, xx: apply_norm(p, xx, cfg.norm), local, x)
        if cfg.tie_embeddings:
            e = gathered(params["embed"], topo)
            w = e.map(lambda t: t.T, (e.spec[1], e.spec[0]))
        else:
            w = gathered(params["head"], topo)
        ax, cols = w.spec[1], w.parts[0].shape[1]
        lo = [col.axis_index(mesh, ax, pos) * cols if ax else 0
              for pos in col.positions(mesh)]

        def head(xx, ww, first):
            logits = matmul(xx, ww, dtype=torch.float32)
            vocab = torch.arange(first, first + cols, device=xx.device)
            return logits + torch.where(vocab < cfg.vocab_size, 0.0,
                                        PAD_LOGIT)

        return Placed(col.each(head, h, w, lo), (x.spec[0], None, ax), mesh)

    def _forward(self, batch, mode: str, params=None):
        params = self.params() if params is None else params
        if self.placed:
            x = self._embed_placed(params, batch)
            x, cache, aux = blocks.apply_stack(params["blocks"], x, self.cfg,
                                               self.topo, self.specs,
                                               mode=mode)
            return self._logits_placed(params, x), cache, aux
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
        logits, cache, aux = self._forward(batch, mode)
        if self.placed:
            logits = logits.whole()
        return logits, cache, aux

    # --------------------------------------------------------------- loss
    def loss(self, batch, params=None):
        """(loss, metrics) of `batch` under `params` (default: the
        module's own), differentiable where the parameters require
        grad."""
        logits, _, aux = self._forward(batch, "full", params)
        if self.placed:
            return self._loss_placed(logits, batch, aux)
        return lm_loss(logits, batch, self.cfg, aux)

    def _loss_placed(self, logits: Placed, batch, aux):
        """`lm_loss` on a mesh: each data shard's logits with the
        vocabulary gathered, its sums of masked log-likelihoods and of
        the mask, both summed over the data axes in shard order."""
        topo, mesh = self.topo, self.topo.mesh
        logits = reshard(logits, (logits.spec[0], None, None))
        targets = topo.constrain(self._tensor(batch["targets"], torch.long),
                                 BATCH, None)
        mask = batch.get("loss_mask")
        mask = (targets.map(lambda t: torch.ones(t.shape, dtype=torch.float32,
                                                 device=t.device))
                if mask is None else topo.constrain(
                    self._tensor(mask, torch.float32), BATCH, None))

        def terms(lg, t, m):
            logp = torch.log_softmax(lg, dim=-1)
            ll = torch.take_along_dim(logp, t[..., None], dim=-1)[..., 0]
            return (ll * m).sum(), m.sum()

        pieces = col.each(terms, logits, targets, mask)
        sums, counts = [p[0] for p in pieces], [p[1] for p in pieces]
        ax = logits.spec[0]
        if ax is not None:
            sums = col.psum(sums, mesh, ax)
            counts = col.psum(counts, mesh, ax)
        denom = torch.clamp_min(counts[0].to(self.device), 1.0)
        ce = -sums[0].to(self.device) / denom
        total = ce + self.cfg.router_aux_loss * aux
        return total, {"ce": ce, "aux": aux, "tokens": denom}

    # -------------------------------------------------------------- serve
    def prefill(self, batch, cache_len: int | None = None):
        logits, cache, _ = self.forward(batch, mode="prefill")
        if cache_len is not None:
            cache = blocks.pad_cache(cache, cache_len)
        return self._place_cache(cache), logits[:, -1:]

    def init_cache(self, batch_size: int, cache_len: int):
        if self.placed:
            cfg = self.cfg
            shape = (batch_size, cache_len, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            n = blocks.layer_groups(self.specs).n_repeat

            def zeros(sh, stacked):
                return Placed.empty(((n,) if stacked else ()) + shape,
                                    DTYPES[cfg.dtype], sh.spec, sh.mesh,
                                    fill=0)

            sh = self.cache_shardings()
            cache = {"prefix": [{k: zeros(v, False) for k, v in e.items()}
                                for e in sh["prefix"]]}
            if "stack" in sh:
                cache["stack"] = {name: {k: zeros(v, True)
                                         for k, v in e.items()}
                                  for name, e in sh["stack"].items()}
            return self._place_cache(cache)
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
        """The cache as `cache_shardings` places it: on a mesh, each leaf
        resharded into its spec (BATCH, KV_SEQ, KV_HEADS); on one device
        the tensors as they are. A cache length that does not split over
        the KV_SEQ axis is refused here rather than at the first decode
        step."""
        axis = self.topo.rules[KV_SEQ]
        if axis:
            n = self.topo.axis_sizes[axis]
            for path, leaf in tree_flatten_with_path(cache):
                if leaf.shape[-3] % n:
                    raise ValueError(
                        f"cache leaf {path}: {leaf.shape[-3]} slots do not "
                        f"split over {axis} ({n} shards)")
        if self.placed:
            return tree_map(lambda leaf, sh: reshard(leaf, sh.spec), cache,
                            self.cache_shardings())
        return cache

    @torch.no_grad()
    def decode_step(self, cache, token, pos):
        """token: (B,1) integer; pos: (B,) integer write/mask index.
        Writes the token's K/V into `cache` in place and returns it."""
        params = self.params()
        if self.placed:
            x = self._embed_placed(params, {"tokens": token})
            x, new_cache, _ = blocks.apply_stack(
                params["blocks"], x, self.cfg, self.topo, self.specs,
                mode="decode", cache=cache, pos=self.topo.constrain(
                    self._tensor(pos, torch.long), BATCH))
            return self._logits_placed(params, x).whole(), new_cache
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
