"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; the
Hopper architecture white paper for the lanes), at its full power limit
of 700 W: HBM3 at 3.35 TB/s; float32 instructions at 132 SMs x 128 FP32
lanes x 1.98 GHz, a fused multiply-add counting as one instruction (the
data sheet's 67 TFLOP/s counts it as two); int32 at half the lanes."""

PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS = 132 * 128 * 1.98e9
PEAK_I32_OPS = 67e12 / 4


def bound_s(n_bytes: float, f32_ops: float, i32_ops: float) -> float:
    """The least seconds the card takes: the larger of the bytes at the
    memory's peak and the operations at their pipes' peaks."""
    return max(n_bytes / PEAK_BYTES_S, f32_ops / PEAK_F32_OPS,
               i32_ops / PEAK_I32_OPS)
