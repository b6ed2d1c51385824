"""float32 log and exp as the simulators spell them: Cephes-style
polynomials whose multiply-adds are fused (one rounding each). A fused
multiply-add is a float64 product, exact for float32 factors, and a
float64 sum rounded once to float32."""
from __future__ import annotations

import numpy as np

F32 = np.float32
FLT_MIN = F32(1.17549435e-38)
SQRTHF = F32(0.707106781186547524)
LOG_P = tuple(F32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
    -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
    2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
LN2_LO = F32(-2.12194440e-4)
LN2_HI = F32(0.693359375)
EXP_LO = F32(-87.8)
EXP_HI = F32(88.8)
LOG2E = F32(1.44269504088896341)
EXP_P = tuple(F32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def fma(a, b, c):
    """a * b + c rounded once to float32."""
    d = np.float64
    return (np.asarray(a, d) * np.asarray(b, d)
            + np.asarray(c, d)).astype(F32)


def log_f32(u):
    """Natural log of positive finite float32 values."""
    x = np.maximum(np.asarray(u, F32), FLT_MIN)
    bits = x.view(np.int32).astype(np.int64)
    e = ((bits >> 23) - 127).astype(F32) + F32(1.0)
    m = ((bits & 0x807FFFFF) | 0x3F000000).astype(np.int32).view(F32)
    lt = m < SQRTHF
    e = e - np.where(lt, F32(1.0), F32(0.0))
    z = (m - F32(1.0)) + np.where(lt, m, F32(0.0))
    z2 = z * z
    z3 = z2 * z
    y = fma(fma(z, LOG_P[0], LOG_P[1]), z, LOG_P[2])
    y1 = fma(fma(z, LOG_P[3], LOG_P[4]), z, LOG_P[5])
    y1 = fma(z3, y, y1)
    y2 = fma(fma(z, LOG_P[6], LOG_P[7]), z, LOG_P[8])
    t = fma(z3, y1, y2)
    s = fma(z3, t, e * LN2_LO)
    a = fma(F32(-0.5), z2, z)
    return fma(LN2_HI, e, a + s)


def exp_f32(x):
    """e^x of float32 values (normal results)."""
    x = np.clip(np.asarray(x, F32), EXP_LO, EXP_HI)
    n = np.clip(np.floor(fma(x, LOG2E, F32(0.5))), F32(-127.0), F32(127.0))
    r = fma(n, -LN2_HI, x)
    r = fma(n, -LN2_LO, r)
    z = r * r
    y = fma(r, EXP_P[0], EXP_P[1])
    for c in EXP_P[2:]:
        y = fma(y, r, c)
    y = F32(1.0) + fma(y, z, r)
    two_n = ((n.astype(np.int32) + 127) << 23).astype(np.int32).view(F32)
    return y * two_n
