"""Architecture registry: `--arch <id>` resolution for launchers/tests;
the port's own copy of `repro/configs/registry.py`, with the same names,
configs and default strategies.

Every assigned architecture is registered with its full (paper-exact)
config and a reduced same-family smoke config. The registry also applies
per-arch default sharding strategies (overridable from the CLI).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs import (
    command_r_35b,
    deepseek_moe_16b,
    gemma_7b,
    internvl2_1b,
    llama3_8b,
    olmoe_1b_7b,
    starcoder2_7b,
)
from repro_torch.configs.base import (
    ALL_SHAPES,
    ModelConfig,
    ShapeConfig,
    ShardingConfig,
    shape_applicable,
)

_MODULES = {
    "olmoe-1b-7b": olmoe_1b_7b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "internvl2-1b": internvl2_1b,
    "llama3-8b": llama3_8b,
    "starcoder2-7b": starcoder2_7b,
    "command-r-35b": command_r_35b,
    "gemma-7b": gemma_7b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return _MODULES[name].CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _MODULES[name].smoke()


# Default sharding strategy per arch (hillclimbing varies these; see
# EXPERIMENTS.md §Perf). Models below ~2B keep pure DP+TP; larger models
# need FSDP over the data axis to fit optimizer state + activations.
_DEFAULT_STRATEGY: dict[str, ShardingConfig] = {
    "olmoe-1b-7b": ShardingConfig(strategy="fsdp_tp", grad_accum=2),
    "deepseek-moe-16b": ShardingConfig(strategy="fsdp_tp", grad_accum=2),
    "internvl2-1b": ShardingConfig(strategy="dp_tp", grad_accum=1),
    "llama3-8b": ShardingConfig(strategy="fsdp_tp", grad_accum=4),
    "starcoder2-7b": ShardingConfig(strategy="fsdp_tp", grad_accum=4),
    "command-r-35b": ShardingConfig(strategy="fsdp_tp", grad_accum=8),
    "gemma-7b": ShardingConfig(strategy="fsdp_tp", grad_accum=4),
}


def default_sharding(name: str, shape: ShapeConfig | None = None,
                     tp_size: int = 16) -> ShardingConfig:
    import dataclasses

    cfg = _DEFAULT_STRATEGY.get(name, ShardingConfig())
    if shape is None:
        return cfg
    if shape.kind in ("decode", "prefill"):
        # Inference holds no optimizer state: FSDP-sharded weights would
        # be all-gathered EVERY step (measured: 181 GB/step on a 52B
        # MoE decode — §Perf H2). Serving layout = TP only, replicated
        # over the data axes.
        cfg = dataclasses.replace(cfg, strategy="dp_tp", grad_accum=1)
    if shape.name == "long_500k":
        # batch=1, 500k KV/state: shard the cache sequence axis over `data`.
        cfg = dataclasses.replace(cfg, seq_sharded_kv=True,
                                  kv_seq_axis="data")
    elif shape.kind == "decode":
        model = get_config(name)
        if model.has_kv_cache and model.n_kv_heads % tp_size != 0:
            # KV heads can't use the model axis -> distributed flash-decode
            # with the cache sequence axis sharded over `model` instead.
            cfg = dataclasses.replace(cfg, seq_sharded_kv=True,
                                      kv_seq_axis="model")
    return cfg


def dryrun_cells() -> list[tuple[str, ShapeConfig]]:
    """Every applicable (arch x shape) pair for the dry-run matrix."""
    cells = []
    for name in ARCH_NAMES:
        model = get_config(name)
        for shape in ALL_SHAPES:
            ok, _why = shape_applicable(model, shape)
            if ok:
                cells.append((name, shape))
    return cells


def skipped_cells() -> list[tuple[str, str, str]]:
    """(arch, shape, reason) for cells excluded from the matrix."""
    out = []
    for name in ARCH_NAMES:
        model = get_config(name)
        for shape in ALL_SHAPES:
            ok, why = shape_applicable(model, shape)
            if not ok:
                out.append((name, shape.name, why))
    return out
