"""Configuration dataclasses; the port's own copy of
`repro/configs/base.py`, field for field and value for value.

Covers every assigned architecture family (dense / moe / ssm / hybrid /
vlm) plus the simulation-side (paper) configs, the input shapes, the
mesh, and the hardware model used for roofline analysis.

Configs are frozen dataclasses: hashable, usable as static args to jit.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Per-layer structure
# ---------------------------------------------------------------------------

# Mixer kinds (the sequence-mixing half of a block).
MIXER_ATTN = "attn"
MIXER_MAMBA = "mamba"
MIXER_MLSTM = "mlstm"
MIXER_SLSTM = "slstm"

# FFN kinds (the channel-mixing half of a block).
FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_NONE = "none"


@dataclass(frozen=True)
class LayerSpec:
    """Structure of one transformer/SSM block."""

    mixer: str  # attn | mamba | mlstm | slstm
    ffn: str  # dense | moe | none


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters.

    One instance fully determines parameter shapes; the `layer_specs()`
    method expands the per-layer structure (attention/mamba/moe interleave)
    used by hybrid architectures.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads (gemma overrides to 256)

    # --- MLP ---
    mlp_variant: str = "swiglu"  # swiglu | geglu | gelu (non-gated)
    mlp_bias: bool = False

    # --- norm / residual topology ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    parallel_block: bool = False  # command-r style attn || mlp
    tie_embeddings: bool = False
    logits_softcap: float = 0.0

    # --- rotary embeddings ---
    rope_theta: float = 10_000.0
    use_rope: bool = True

    # --- MoE ---
    n_experts: int = 0
    n_experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert intermediate (fine-grained MoE)
    first_k_dense: int = 0  # deepseek: first k layers use a dense FFN
    moe_layer_period: int = 1  # jamba: MoE every `period` layers
    moe_layer_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01

    # --- hybrid / SSM layer pattern ---
    attn_layer_period: int = 1  # jamba: attention every `period` layers
    attn_layer_offset: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # xLSTM: sLSTM block every `slstm_every` layers (at offset-th position);
    # 0 disables (all-mLSTM).
    slstm_every: int = 0
    slstm_offset: int = 0
    xlstm_expand: int = 2
    chunk_size: int = 256  # chunkwise-parallel chunk for mLSTM/mamba train

    # --- modality frontend stubs ---
    frontend: str = "none"  # none | vision | audio
    frontend_tokens: int = 0  # prefix positions supplied as embeddings

    # --- numerics ---
    dtype: str = "bfloat16"
    vocab_pad_to: int = 256

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def d_inner(self) -> int:
        """Inner width of mamba/xlstm mixers."""
        expand = self.mamba_expand if self.family != "ssm" else self.xlstm_expand
        return expand * self.d_model

    def mixer_for_layer(self, i: int) -> str:
        if self.family in ("dense", "moe", "vlm", "audio"):
            return MIXER_ATTN
        if self.family == "hybrid":
            if self.attn_layer_period and i % self.attn_layer_period == self.attn_layer_offset:
                return MIXER_ATTN
            return MIXER_MAMBA
        if self.family == "ssm":
            if self.slstm_every and i % self.slstm_every == self.slstm_offset:
                return MIXER_SLSTM
            return MIXER_MLSTM
        raise ValueError(f"unknown family {self.family}")

    def ffn_for_layer(self, i: int) -> str:
        if self.d_ff == 0 and self.n_experts == 0:
            return FFN_NONE
        if self.n_experts == 0:
            return FFN_DENSE
        if i < self.first_k_dense:
            return FFN_DENSE
        if i % self.moe_layer_period == self.moe_layer_offset:
            return FFN_MOE
        return FFN_DENSE

    def layer_specs(self) -> tuple[LayerSpec, ...]:
        return tuple(
            LayerSpec(self.mixer_for_layer(i), self.ffn_for_layer(i))
            for i in range(self.n_layers)
        )

    @property
    def has_kv_cache(self) -> bool:
        """True if any layer uses attention (needs a KV cache for decode)."""
        return any(s.mixer == MIXER_ATTN for s in self.layer_specs())

    @property
    def subquadratic(self) -> bool:
        """True if the arch can decode with O(1)-per-token state growth in
        the mixer majority (SSM/hybrid) — gate for long_500k."""
        return self.family in ("ssm", "hybrid")

    # ------------------------------------------------------------------
    # Parameter counting (for MODEL_FLOPS and memory napkin math).
    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        q = self.d_model * self.n_heads * hd
        kv = 2 * self.d_model * self.n_kv_heads * hd
        o = self.n_heads * hd * self.d_model
        return q + kv + o

    def _dense_ffn_params(self, d_ff: int) -> int:
        mats = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
        return mats * self.d_model * d_ff

    def _moe_ffn_params(self) -> tuple[int, int]:
        """(total, active-per-token) parameters of one MoE FFN layer."""
        d_ff = self.moe_d_ff or self.d_ff
        per_expert = self._dense_ffn_params(d_ff)
        router = self.d_model * self.n_experts
        shared = self.n_shared_experts * per_expert
        total = self.n_experts * per_expert + shared + router
        active = self.n_experts_per_token * per_expert + shared + router
        return total, active

    def _mamba_params(self) -> int:
        di, ds = self.mamba_expand * self.d_model, self.mamba_d_state
        in_proj = self.d_model * 2 * di
        conv = di * self.mamba_d_conv
        dt_rank = max(1, self.d_model // 16)
        x_proj = di * (dt_rank + 2 * ds)
        dt_proj = dt_rank * di
        out = di * self.d_model
        return in_proj + conv + x_proj + dt_proj + out + 2 * di  # A_log-ish, D

    def _mlstm_params(self) -> int:
        # mLSTM block: pre-up-projection (x2: cell input + output gate),
        # causal conv, block-diagonal per-head q/k/v, scalar i/f gates,
        # down projection.
        di = self.xlstm_expand * self.d_model
        hd = di // self.n_heads
        in_proj = self.d_model * 2 * di
        conv = di * self.mamba_d_conv
        qkv = 3 * self.n_heads * hd * hd  # block-diagonal
        gates = 2 * di  # i/f gate projections (per-channel -> per-head pooled)
        out = di * self.d_model
        return in_proj + conv + qkv + gates + out

    def _slstm_params(self) -> int:
        # sLSTM block: 4 gates x (dense input + block-diagonal recurrent),
        # plus the post-up-projection FFN (factor 4/3, GeLU) of the xLSTM
        # paper's sLSTM block.
        d, h = self.d_model, self.n_heads
        gates = 4 * (d * d + d * (d // max(1, h)))
        d_ffs = int(round(4 * d / 3))
        ffn = 2 * d * d_ffs
        return gates + ffn

    def param_count(self) -> int:
        n = self.padded_vocab * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.padded_vocab * self.d_model
        for spec in self.layer_specs():
            if spec.mixer == MIXER_ATTN:
                n += self._attn_params()
            elif spec.mixer == MIXER_MAMBA:
                n += self._mamba_params()
            elif spec.mixer == MIXER_MLSTM:
                n += self._mlstm_params()
            elif spec.mixer == MIXER_SLSTM:
                n += self._slstm_params()
            if spec.ffn == FFN_DENSE:
                n += self._dense_ffn_params(self.d_ff)
            elif spec.ffn == FFN_MOE:
                total, _ = self._moe_ffn_params()
                n += total
            n += 2 * self.d_model  # norms
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed-active experts)."""
        n = self.padded_vocab * self.d_model
        if not self.tie_embeddings:
            n += self.padded_vocab * self.d_model
        for spec in self.layer_specs():
            if spec.mixer == MIXER_ATTN:
                n += self._attn_params()
            elif spec.mixer == MIXER_MAMBA:
                n += self._mamba_params()
            elif spec.mixer == MIXER_MLSTM:
                n += self._mlstm_params()
            elif spec.mixer == MIXER_SLSTM:
                n += self._slstm_params()
            if spec.ffn == FFN_DENSE:
                n += self._dense_ffn_params(self.d_ff)
            elif spec.ffn == FFN_MOE:
                _, active = self._moe_ffn_params()
                n += active
            n += 2 * self.d_model
        return n


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

KIND_TRAIN = "train"
KIND_PREFILL = "prefill"
KIND_DECODE = "decode"


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", KIND_TRAIN, 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", KIND_PREFILL, 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", KIND_DECODE, 32_768, 128)
LONG_500K = ShapeConfig("long_500k", KIND_DECODE, 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(applicable, reason-if-not). long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not model.subquadratic:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""


# ---------------------------------------------------------------------------
# Sharding / execution strategy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardingConfig:
    """How a model is laid out on the mesh for a given shape.

    `strategy` picks the parameter layout; the boolean knobs are the
    hillclimbing levers recorded in EXPERIMENTS.md §Perf.
    """

    strategy: str = "fsdp_tp"  # dp_tp | fsdp_tp
    expert_parallel: bool = True  # shard experts over the model axis
    seq_sharded_kv: bool = False  # decode: shard KV cache sequence axis
    kv_seq_axis: str = "data"  # mesh axis for the KV sequence shards
    seq_sharded_activations: bool = False  # sequence parallelism for residuals
    remat: str = "block"  # none | block | full
    grad_accum: int = 1  # microbatch count (train)
    scan_layers: bool = True  # scan over identical layer groups
    compress_grads: bool = False  # int8 error-feedback cross-pod all-reduce


@dataclass(frozen=True)
class MeshSpec:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    @property
    def data_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))


SINGLE_POD = MeshSpec((16, 16), ("data", "model"))
MULTI_POD = MeshSpec((2, 16, 16), ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# Hardware model: the reference's TPU v5e-class roofline constants, kept
# so the two packages' configs stay equal. No figure of the port uses
# them; its H100 peaks are in chip_smoke.py.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12  # per chip
    hbm_bw: float = 819e9  # bytes/s per chip
    ici_bw: float = 50e9  # bytes/s per link
    hbm_bytes: float = 16e9  # per chip


V5E = HardwareSpec()


# ---------------------------------------------------------------------------
# Training / serving run configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_fp32: bool = True


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    shape: ShapeConfig
    sharding: ShardingConfig = ShardingConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    seed: int = 0
    ckpt_every: int = 100
    ckpt_dir: str = "/tmp/repro_ckpt"
    log_every: int = 10


def with_overrides(cfg, **kw):
    """Functional update for frozen configs."""
    return dataclasses.replace(cfg, **kw)
