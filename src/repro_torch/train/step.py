"""The train step on one device; port of `make_train_step` and
`init_train_state` of `repro/train/step.py`.

  state = init_train_state(model, generator, ocfg)
        = {"params": model.params(), "opt": AdamWState}
  new_state, metrics = train_step(state, batch)

The state keeps the reference's tree and leaf names, so checkpoint
files and test states cross between the packages. Gradient
accumulation splits the batch into `grad_accum` microbatches as the
reference's `_split_microbatches` does, accumulates each microbatch's
gradients in float32 as g / accum, and reports the mean of the
microbatches' loss and metrics. The state is donated: the step updates
its tensors in place and returns it, as the reference's jitted step
donates its state.

`make_dp_train_step` is the explicit data-parallel step over a mesh
axis, in one process: each shard takes its slice of the batch, runs a
forward and backward pass on the replicated parameters and scales its
gradients by 1/n_shards; the gradients are reduced leaf by leaf with
the int8 error-feedback `compressed_psum` arithmetic (or a plain psum),
left to right over the shards, and one AdamW update is applied to the
replicated parameters (the lead shard's tensors, updated in place; a
shard on another device runs on a copy made at each step). The shards
run one after another, so only a running total, each shard's error
buffer and one shard's gradients are alive at a time. As in the
reference, `loss` is the shards' mean, while `ce`, `aux` and `tokens`
are shard 0's, and each shard keeps its own error buffer: the state's
"error" is a list of one tree a shard (a single tree, as `init_error`
makes it, stands for every shard's zeros at the first step; with
compress=False the "error" entry is passed through untouched, as the
reference returns it).

On a mesh (`fsdp_tp` or `dp_tp`) the state's parameters, gradients and
optimizer leaves are `Placed`: autograd differentiates the loss in each
distinct slice of a leaf (a replica on another device is a copy made
from it inside the graph, so its gradient adds into the slice's), the
FSDP gather's backward returns each gradient reduce-scattered into its
parameter's layout, and AdamW updates part by part.

`abstract_train_state` (shapes with shardings for XLA's ahead-of-time
lowering) has no PyTorch analogue and is not ported.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import OptimizerConfig, ShardingConfig
from repro_torch.sharding import collectives as col
from repro_torch.sharding.collectives import Placed, flat_parts, unflat_parts
from repro_torch.train.compression import error_feedback
from repro_torch.train.optim import adamw_update, init_opt_state
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


def init_train_state(model, generator: torch.Generator,
                     ocfg: OptimizerConfig) -> dict:
    """Initialise the model from `generator` and wrap its parameters
    (the module's own tensors, which the step then trains in place)."""
    params = model.init(generator).params()
    return {"params": params, "opt": init_opt_state(params, ocfg)}


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    def split(x):
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} is not a multiple of grad_accum "
                             f"{accum}")
        return x.reshape(accum, b // accum, *x.shape[1:])

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(accum)]


def _live(leaf, trainable: list):
    """A leaf that requires grad: a tensor's detached copy, or a
    `Placed` leaf's distinct slices (each its first holder's part),
    with the parts on other devices moved from them inside the graph."""
    if not isinstance(leaf, Placed):
        t = leaf.detach().requires_grad_(True)
        trainable.append(t)
        return t
    canon, moved, parts = {}, {}, []
    for k, p in zip(leaf.keys(), leaf.parts):
        if k not in canon:
            canon[k] = p.detach().requires_grad_(True)
            trainable.append(canon[k])
        if (k, p.device) not in moved:
            moved[(k, p.device)] = canon[k].to(p.device)
        parts.append(moved[(k, p.device)])
    return Placed(parts, leaf.spec, leaf.mesh)


def _laid_out(leaf, grads):
    """A leaf's gradient in its layout, from `grads` (an iterator over
    the gradients of `_live`'s trainable tensors, in its order)."""
    if not isinstance(leaf, Placed):
        return next(grads)
    per_key: dict = {}
    for k in leaf.keys():
        if k not in per_key:
            per_key[k] = next(grads)
    moved: dict = {}
    parts = []
    for k, p in zip(leaf.keys(), leaf.parts):
        if (k, p.device) not in moved:
            moved[(k, p.device)] = per_key[k].to(p.device)
        parts.append(moved[(k, p.device)])
    return Placed(parts, leaf.spec, leaf.mesh)


def _grad_fn(model, params, mb):
    """(loss, metrics, gradient tree) of `model.loss` on `mb` at
    `params`."""
    leaves = tree_leaves(params)
    trainable: list = []
    live = [_live(p, trainable) for p in leaves]
    loss, metrics = model.loss(mb, params=tree_unflatten_like(params, live))
    grads = iter(torch.autograd.grad(loss, trainable,
                                     materialize_grads=True))
    del live
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten_like(
        params, [_laid_out(p, grads) for p in leaves])


def make_train_step(model, ocfg: OptimizerConfig,
                    scfg: ShardingConfig) -> Callable:
    accum = max(1, scfg.grad_accum)

    def grad_fn(params, mb):
        return _grad_fn(model, params, mb)

    def train_step(state, batch):
        params = state["params"]
        if accum == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            n = torch.tensor(accum, dtype=torch.float32,
                             device=tree_leaves(params)[0].device)
            grads, losses, ms = None, [], []
            for mb in _split_microbatches(batch, accum):
                l, m, g = grad_fn(params, mb)
                if grads is None:
                    grads = [torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device)
                             for p in flat_parts(params)]
                for a, gg in zip(grads, flat_parts(g)):
                    a.add_(gg.to(torch.float32) / n.to(a.device))
                del g
                losses.append(l)
                ms.append(m)
            grads = unflat_parts(params, grads)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state["opt"], params, ocfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


# ---------------------------------------------------------------------------
# Explicit-DP step with compressed gradient reduction
# ---------------------------------------------------------------------------


def make_dp_train_step(model, ocfg: OptimizerConfig, mesh, axis: str = "data",
                       compress: bool = True) -> Callable:
    """Params replicated; batch split over `axis`; per-shard grads
    reduced with the int8 error-feedback psum (or a plain psum).

    The shards are the mesh positions along `axis` (the other axes at
    index 0: the reference's replicas along them compute the same)."""
    n_shards = mesh.shape[axis]
    at = mesh.axis_names.index(axis)
    devs = mesh.device_list()
    shard_devs = [devs[i] for i, pos in enumerate(col.positions(mesh))
                  if all(p == 0 for j, p in enumerate(pos) if j != at)]

    def train_step(state, batch):
        params = state["params"]
        lead = tree_leaves(params)[0].device
        errors = state.get("error")
        if compress and not isinstance(errors, list):
            # replicated zeros: each shard reads them on its device (no
            # buffer is written in place, so shards on one device share)
            errors = [tree_map(lambda e, d=d: e.to(d), errors)
                      for d in shard_devs]
        err_leaves = [tree_leaves(e) for e in errors] if compress else None
        replicas = {lead: params}
        total, losses, metrics0 = None, [], None
        for k, dev in enumerate(shard_devs):
            if dev not in replicas:
                replicas[dev] = tree_map(lambda p, d=dev: p.to(d), params)
            mb = {}
            for key, v in batch.items():
                rows = v.shape[0] // n_shards
                mb[key] = v[k * rows:(k + 1) * rows]
            loss, metrics, grads = _grad_fn(model, replicas[dev], mb)
            n = torch.tensor(n_shards, dtype=torch.float32, device=dev)
            g_leaves = tree_leaves(grads)
            del grads
            for j in range(len(g_leaves)):
                g = g_leaves[j].to(torch.float32) / n
                g_leaves[j] = None
                if compress:
                    g, err_leaves[k][j] = error_feedback(g, err_leaves[k][j])
                if k == 0:
                    g_leaves[j] = g.to(lead)
                else:
                    total[j].add_(g.to(lead))
            if k == 0:
                total, metrics0 = g_leaves, metrics
            losses.append(loss.to(lead))
        loss = losses[0]  # pmean: summed left to right, then / n
        for other in losses[1:]:
            loss = loss + other
        loss = loss / torch.tensor(n_shards, dtype=loss.dtype, device=lead)
        grads = tree_unflatten_like(params, total)
        new_params, new_opt, om = adamw_update(grads, state["opt"], params,
                                               ocfg)
        del grads, total
        if compress:
            errors = [tree_unflatten_like(e, leaves)
                      for e, leaves in zip(errors, err_leaves)]
        metrics = dict(metrics0, loss=loss, **om)
        return {"params": new_params, "opt": new_opt, "error": errors}, \
            metrics

    return train_step
