"""Command-R (c4ai-command-r-v01, 35B) — dense GQA decoder, no biases,
parallel attention/FFN residual block [hf:CohereForAI/c4ai-command-r-v01].

40L, d_model=8192, 64H (GQA kv=8), d_ff=22528, vocab 256000. LayerNorm
(no bias), tied embeddings, RoPE theta 8M.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    mlp_variant="swiglu",
    norm="layernorm",
    parallel_block=True,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        mlp_variant="swiglu",
        norm="layernorm",
        parallel_block=True,
        tie_embeddings=True,
        dtype="float32",
    )
