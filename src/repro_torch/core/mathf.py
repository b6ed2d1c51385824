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

`exp_f32` is the Cephes-style `expf` XLA:CPU compiles for `jnp.exp`:
clamp x to [-87.8, 88.8], n = floor(x log2(e) + 1/2) clamped to
[-127, 127], r = x - n ln2 in two parts (0.693359375 and
-2.12194440e-4), a degree-5 polynomial p(r) in Horner form, and
(1 + (r + r^2 p)) 2^n with 2^n built from its exponent bits. The two
reduction steps and the six polynomial steps are fused multiply-adds
on an FMA-capable x86 host; emulated as above, the result equals
`jnp.exp` bit for bit on [-16, 0], the range the tau-leap Poisson
sampler evaluates (`tests/test_torch_tau_leap.py`). `torch.exp`
differs there on about 10% of inputs. XLA flushes subnormal results to
zero and this routine does not, so below about -87.3 the two differ.
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
# Cephes expf: clamp range, log2(e), and the polynomial, highest first
EXP_LO = float(_F(-87.8))
EXP_HI = float(_F(88.8))
LOG2E = float(_F(1.44269504088896341))
EXP_P = tuple(float(_F(c)) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


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


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """e^x of float32 values, bitwise equal to XLA:CPU's `jnp.exp` on
    [-16, 0] (tested on whole binades there) and on its normal results
    in general."""
    x = torch.clamp(x, EXP_LO, EXP_HI)
    n = torch.clamp(torch.floor(_fma(x, LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(n, -LN2_HI, x)
    r = _fma(n, -LN2_LO, r)
    z = r * r
    y = _fma(r, EXP_P[0], EXP_P[1])
    for c in EXP_P[2:]:
        y = _fma(y, r, c)
    y = 1.0 + _fma(y, z, r)
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return y * two_n
