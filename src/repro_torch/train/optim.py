"""AdamW with float32 master weights, cosine schedule, global-norm
clipping; port of `repro/train/optim.py` on trees of tensors
(`repro_torch.tree`).

The reference's operation order is kept, including
`mhat / (sqrt(vhat) + eps) + wd · p32`, and where it divides by a
scalar the port divides by a float32 tensor (torch multiplies by a
reciprocal for a Python divisor on the card). `adamw_update` works leaf
by leaf and in place: the state it is given is donated, as the
reference's jitted step donates it, so one leaf's temporaries are alive
at a time.

Placed parameters (`fsdp_tp` on a mesh) are updated part by part: their
gradients, `mu`, `nu` and `master` are `Placed` leaves of the same
layout, each distinct part updated once in place (parts that are views
of one leaf are disjoint slices of it), and the global norm counts each
slice once, not its replicas on other devices.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.sharding.collectives import Placed, flat_parts
from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Any  # float32 tree
    nu: Any  # float32 tree
    master: Any  # float32 params (None when the params are float32)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_schedule(cfg: OptimizerConfig, step):
    """The learning rate at `step` (an int or a tensor), float32, on the
    step's device."""
    step = torch.as_tensor(step)
    dev = step.device
    s = step.to(torch.float32)
    warm = torch.clamp_max(s / _f32(max(cfg.warmup_steps, 1), dev), 1.0)
    t = torch.clamp((s - cfg.warmup_steps) / _f32(
        max(cfg.total_steps - cfg.warmup_steps, 1), dev), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(params, cfg: OptimizerConfig) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device

    def zeros(p):
        if isinstance(p, Placed):
            return p.map(zeros)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def wide(p):
        if isinstance(p, Placed):
            return p.map(wide)
        return p.detach().to(torch.float32, copy=True)

    needs_master = cfg.master_fp32 and any(
        p.dtype != torch.float32 for p in leaves)
    master = tree_map(wide, params) if needs_master else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      master=master)


def _sq(x) -> torch.Tensor:
    if isinstance(x, Placed):  # each slice once, summed on the first device
        out = None
        for p in x.slices():
            t = torch.sum(torch.square(p.to(torch.float32))).to(x.device)
            out = t if out is None else out + t
        return out
    return torch.sum(torch.square(x.to(torch.float32)))


def global_norm(tree) -> torch.Tensor:
    leaves = [_sq(x) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm, max_norm: float):
    return torch.clamp_max(
        _f32(max_norm, norm.device) / torch.clamp_min(norm, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: OptimizerConfig):
    """Returns (new_params, new_state, metrics). grads may be bf16.

    `params` and `state` are updated in place and returned."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    g_leaves = flat_parts(grads)
    mu_leaves = flat_parts(state.mu)
    nu_leaves = flat_parts(state.nu)
    p_leaves = flat_parts(params)
    m_leaves = (flat_parts(state.master) if state.master is not None
                else [None] * len(p_leaves))
    on: dict = {}  # the step's scalars on each part's device
    for g, m, v, p, p32 in zip(g_leaves, mu_leaves, nu_leaves, p_leaves,
                               m_leaves):
        if p.device not in on:
            on[p.device] = [t.to(p.device) for t in (scale, lr, bc1, bc2)]
        scale, lr, bc1, bc2 = on[p.device]
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        ref = p32 if p32 is not None else p.to(torch.float32)
        mhat = m / bc1
        vhat = v / bc2
        new = ref - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * ref)
        del mhat, vhat
        if p32 is not None:
            p32.copy_(new)
        p.copy_(new)  # rounds into the parameter's dtype
    new_state = AdamWState(step=step, mu=state.mu, nu=state.nu,
                           master=state.master)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}

