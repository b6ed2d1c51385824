"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060].

16L, d_model=2048, 16H (GQA kv=16), per-expert d_ff=1024, vocab 50304.
Every layer is MoE (no dense FFN layers, no shared experts).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,  # per-expert (moe_d_ff defaults to d_ff)
    moe_d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    n_experts_per_token=8,
    mlp_variant="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return ModelConfig(
        name="olmoe-1b-7b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        moe_d_ff=96,
        vocab_size=512,
        n_experts=8,
        n_experts_per_token=2,
        mlp_variant="swiglu",
        dtype="float32",
    )
