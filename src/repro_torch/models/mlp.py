"""Channel-mixing FFNs: SwiGLU / GeGLU / non-gated GELU(+bias); port of
`repro/models/mlp.py`. `jax.nn.gelu` is the tanh approximation by
default, so the port's GELU is too; the activation runs in float32."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, einsum
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


def apply_mlp(params: dict, x, cfg: ModelConfig):
    """x: (..., d_model)."""
    up = einsum("...d,df->...f", x, params["w_up"])
    if "b_up" in params:
        up = up + params["b_up"]
    if "w_gate" in params:
        gate = einsum("...d,df->...f", x, params["w_gate"])
        h = _act(cfg, gate.to(torch.float32)).to(x.dtype) * up
    else:
        h = _act(cfg, up.to(torch.float32)).to(x.dtype)
    y = einsum("...f,fd->...d", h, params["w_down"])
    if "b_down" in params:
        y = y + params["b_down"]
    return y
