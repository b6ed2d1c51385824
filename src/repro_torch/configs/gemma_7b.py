"""Gemma-7B — dense decoder with GeGLU and head_dim=256 [arXiv:2403.08295].

28L, d_model=3072, 16H (kv=16), d_ff=24576, vocab 256000. Attention
projects 3072 -> 16*256 = 4096 (head_dim overrides d_model//n_heads).
Tied embeddings, RMSNorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_variant="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,  # exercise the head_dim != d_model//n_heads path
        d_ff=128,
        vocab_size=512,
        mlp_variant="geglu",
        tie_embeddings=True,
        dtype="float32",
    )
