"""Channel-mixing FFNs: SwiGLU / GeGLU / non-gated GELU(+bias); port of
`repro/models/mlp.py`. `jax.nn.gelu` is the tanh approximation by
default, so the port's GELU is too; the activation runs in float32.

On a mesh (`apply_mlp_placed`) `w_gate`, `w_up` and `b_up` are
column-parallel over FFN and `w_down` row-parallel: each model shard's
partial output, rounded to the input dtype, is summed by one `psum`
over `model`, and `b_down` is added once, after it."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    ParamDef,
    einsum,
    einsum_out,
    gathered_tree,
    row_parallel,
)
from repro_torch.sharding import collectives as col
from repro_torch.sharding.rules import EMBED, FFN


def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.mlp_variant in ("swiglu", "geglu"):
        defs = {
            "w_gate": ParamDef((d, f), (EMBED, FFN)),
            "w_up": ParamDef((d, f), (EMBED, FFN)),
            "w_down": ParamDef((f, d), (FFN, EMBED)),
        }
    else:  # non-gated
        defs = {
            "w_up": ParamDef((d, f), (EMBED, FFN)),
            "w_down": ParamDef((f, d), (FFN, EMBED)),
        }
    if cfg.mlp_bias:
        defs["b_up"] = ParamDef((f,), (FFN,), init="zeros")
        defs["b_down"] = ParamDef((d,), (EMBED,), init="zeros")
    return defs


def _act(cfg: ModelConfig, x):
    if cfg.mlp_variant == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def _hidden(params: dict, x, cfg: ModelConfig):
    """The activated FFN hidden layer (..., f) of x (..., d_model)."""
    up = einsum("...d,df->...f", x, params["w_up"])
    if "b_up" in params:
        up = up + params["b_up"]
    if "w_gate" in params:
        gate = einsum("...d,df->...f", x, params["w_gate"])
        return _act(cfg, gate.to(torch.float32)).to(x.dtype) * up
    return _act(cfg, up.to(torch.float32)).to(x.dtype)


def apply_mlp(params: dict, x, cfg: ModelConfig):
    """x: (..., d_model)."""
    y = einsum_out("...f,fd->...d", _hidden(params, x, cfg),
                   params["w_down"])
    if "b_down" in params:
        y = y + params["b_down"]
    return y


def apply_mlp_placed(params: dict, x, cfg: ModelConfig, topo,
                     scatter_dim=None):
    """`apply_mlp` on a mesh: x a `Placed` (..., d_model) whose last
    dimension is whole, params `Placed` leaves. Returns a `Placed` in
    x's layout (reduce-scattered along `scatter_dim` where given)."""
    local, flat = gathered_tree(params, topo)
    h = col.each(lambda p, xx: _hidden(p, xx, cfg), local, x)
    y = row_parallel("...f,fd->...d", h, flat["w_down"], topo, x.spec,
                     scatter_dim)
    if "b_down" in flat:
        y = col.Placed(col.each(torch.add, y, flat["b_down"]), y.spec,
                       y.mesh)
    return y
