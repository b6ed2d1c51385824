"""InternVL2-1B — InternViT vision frontend + Qwen2-0.5B-class LM backbone
[arXiv:2404.16821].

Backbone: 24L, d_model=896, 14H (GQA kv=2), d_ff=4864, vocab 151655.
Per instructions the ViT frontend is a STUB: `input_specs()` supplies
precomputed patch embeddings for the first `frontend_tokens` positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    mlp_variant="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,  # qwen2
    frontend="vision",
    frontend_tokens=256,  # one 448px tile -> 256 patch embeddings
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        mlp_variant="swiglu",
        frontend="vision",
        frontend_tokens=8,
        dtype="float32",
    )
