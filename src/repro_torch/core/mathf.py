"""Port-owned float32 math whose bits match the reference's XLA:CPU.

`log_f32` is Eigen's Cephes-style `plog` as XLA:CPU compiles it for
`jnp.log` on a float32: a frexp-style split x = m * 2^e with m in
[0.5, 1), a shift of m below sqrt(1/2) into [sqrt(1/2), sqrt(2)), and a
degree-8 polynomial in z = m - 1 evaluated with five multiply-adds that
LLVM contracts into fused multiply-adds on an FMA-capable x86 host.
`torch.log` differs from `jnp.log` on about 14% of the uniforms the
SSA draws, by one ulp, which is enough to fork trajectories, so the
port computes its own.

Here each fused multiply-add is emulated as a float64 product and sum
rounded once to float32; on every value `bits_to_uniform` can produce
this equals the hardware FMA (the exhaustive test holds it against
`jnp.log`). The CUDA kernel (`kernels/csrc/ssa_window.cu`) spells the
same routine with `__fmaf_rn` and explicitly rounded `_rn` arithmetic.
Every other operation is a plain float32 operation: torch evaluates
each as its own rounded kernel, so nothing else is contracted.
"""
from __future__ import annotations

import numpy as np
import torch

_F = np.float32
FLT_MIN = float(_F(1.17549435e-38))
SQRTHF = float(_F(0.707106781186547524))
# Cephes logf polynomial coefficients, highest degree first
P = tuple(float(_F(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
    -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
    2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
LN2_LO = float(_F(-2.12194440e-4))
LN2_HI = float(_F(0.693359375))


def _fma(a, b, c):
    """fma(a, b, c) on float32 tensors (or float32-exact scalars):
    a*b is exact in float64, the sum is rounded once to float32."""
    def d(v):
        return v.double() if isinstance(v, torch.Tensor) else v
    return (d(a) * d(b) + d(c)).float()


def log_f32(u: torch.Tensor) -> torch.Tensor:
    """Natural log of positive finite float32 values, bitwise equal to
    XLA:CPU's `jnp.log` on every output of `bits_to_uniform`."""
    x = torch.clamp_min(u, FLT_MIN)
    bits = x.view(torch.int32).to(torch.int64)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x807FFFFF) | 0x3F000000).to(torch.int32).view(
        torch.float32)
    lt = m < SQRTHF
    zero = torch.zeros_like(m)
    e = e - torch.where(lt, torch.ones_like(m), zero)
    z = (m - 1.0) + torch.where(lt, m, zero)
    z2 = z * z
    z3 = z2 * z
    y = _fma(z, P[0], P[1])
    y = _fma(y, z, P[2])
    y1 = _fma(z, P[3], P[4])
    y1 = _fma(y1, z, P[5])
    y1 = _fma(z3, y, y1)
    y2 = _fma(z, P[6], P[7])
    y2 = _fma(y2, z, P[8])
    t = _fma(z3, y1, y2)
    s = _fma(z3, t, e * LN2_LO)
    a = _fma(-0.5, z2, z)
    return _fma(LN2_HI, e, a + s)
