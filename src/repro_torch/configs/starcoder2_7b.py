"""StarCoder2-7B — dense GQA decoder with RoPE [arXiv:2402.19173].

32L, d_model=4608, 36H (GQA kv=4), d_ff=18432, vocab 49152.
Non-gated GELU MLP with biases; LayerNorm (the release uses standard
LayerNorm + bias throughout).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    mlp_variant="gelu",
    mlp_bias=True,
    norm="layernorm",
    rope_theta=100_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-smoke",
        family="dense",
        n_layers=2,
        d_model=72,  # keeps the 36-head flavour (9 heads x 8)
        n_heads=6,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        mlp_variant="gelu",
        mlp_bias=True,
        norm="layernorm",
        dtype="float32",
    )
