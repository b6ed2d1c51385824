"""Normalisation layers (float32 internals, params in the model dtype);
port of `repro/models/norms.py`."""
from __future__ import annotations

import torch

from repro_torch.models.common import ParamDef
from repro_torch.sharding.rules import EMBED


def norm_defs(d_model: int, kind: str) -> dict:
    defs = {"scale": ParamDef((d_model,), (EMBED,), init="ones")}
    if kind == "layernorm":
        defs["bias"] = ParamDef((d_model,), (EMBED,), init="zeros")
    return defs


def apply_norm(params: dict, x, kind: str, eps: float = 1e-6):
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * (var + eps) ** -0.5
        y = y * params["scale"].to(torch.float32)
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        # biased, as jnp.var
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * (var + eps) ** -0.5
        y = y * params["scale"].to(torch.float32)
        if "bias" in params:
            y = y + params["bias"].to(torch.float32)
    else:
        raise ValueError(kind)
    return y.to(x.dtype)
