"""Llama-3-8B — dense GQA decoder, 128k vocab [arXiv:2407.21783].

32L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab 128256, SwiGLU,
RMSNorm, RoPE theta 500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    mlp_variant="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        mlp_variant="swiglu",
        rope_theta=500_000.0,
        dtype="float32",
    )
