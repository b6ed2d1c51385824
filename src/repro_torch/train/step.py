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

`abstract_train_state` (shapes with shardings for XLA's ahead-of-time
lowering) has no PyTorch analogue and is not ported;
`make_dp_train_step` (the data-parallel step with `compressed_psum`) is
ROADMAP queue 1 item 18d.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import OptimizerConfig, ShardingConfig
from repro_torch.train.optim import adamw_update, init_opt_state
from repro_torch.tree import tree_leaves, tree_unflatten_like


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


def make_train_step(model, ocfg: OptimizerConfig,
                    scfg: ShardingConfig) -> Callable:
    accum = max(1, scfg.grad_accum)

    def grad_fn(params, mb):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = model.loss(mb, params=tree_unflatten_like(params,
                                                                  live))
        grads = torch.autograd.grad(loss, live, materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten_like(params,
                                                           list(grads))

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
                             for p in tree_leaves(params)]
                for a, gg in zip(grads, tree_leaves(g)):
                    a.add_(gg.to(torch.float32) / n)
                del g
                losses.append(l)
                ms.append(m)
            grads = tree_unflatten_like(params, grads)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state["opt"], params, ocfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
