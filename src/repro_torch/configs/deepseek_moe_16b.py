"""DeepSeekMoE-16B — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066].

28L, d_model=2048, 16H (GQA kv=16), per-expert d_ff=1408, vocab 102400.
First layer uses a dense FFN (intermediate 10944), as in the release.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,  # dense-FFN layers (layer 0)
    moe_d_ff=1408,  # fine-grained routed/shared experts
    vocab_size=102400,
    n_experts=64,
    n_experts_per_token=6,
    n_shared_experts=2,
    first_k_dense=1,
    mlp_variant="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=160,
        moe_d_ff=48,
        vocab_size=512,
        n_experts=8,
        n_experts_per_token=2,
        n_shared_experts=2,
        first_k_dense=1,
        mlp_variant="swiglu",
        dtype="float32",
    )
