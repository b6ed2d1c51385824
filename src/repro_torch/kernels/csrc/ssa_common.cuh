// Bit-exact building blocks shared by the port's kernels (ssa_window.cu,
// sparse_window.cu, propensity.cu, tau_window.cu, sparse_tau_window.cu):
// one spelling of the random stream, the logarithm, the exponential, the
// Poisson sampler and the combination counts, so every kernel draws and
// rounds as the plain torch twins do (repro_torch/core/stream.py,
// mathf.py, reactions.py, tau_leap.py); and the exact windows' lane
// columns and persistent-lane ticket.
//
// Every float operation is an explicitly rounded intrinsic (`_rn`), so
// nvcc's default --fmad=true cannot contract a multiply into an add; the
// only fused multiply-adds are the five of `log_f32` and the eight of
// `exp_f32`, where XLA:CPU contracts them too.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssa {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// 20-round threefry2x32 (Salmon et al., SC'11): counter (c0, c1), key (k0, k1)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int blk = 0; blk < 5; ++blk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rot[(blk & 1) * 4 + i]) ^ x0;
    }
    x0 += ks[(blk + 1) % 3];
    x1 += ks[(blk + 2) % 3] + (uint32_t)(blk + 1);
  }
  o0 = x0;
  o1 = x1;
}

// top 23 bits -> mantissa of [1, 2) -> [U_MIN, 1), U_MIN = float32(1e-12)
__device__ __forceinline__ float bits_to_uniform(uint32_t b) {
  const float f = __uint_as_float((b >> 9) | 0x3F800000u);
  return fmaxf(__fsub_rn(f, 1.0f), 0x1.197998p-40f);
}

// Eigen's Cephes-style plog as XLA:CPU compiles it (five contracted FMAs);
// the same routine as repro_torch/core/mathf.py::log_f32
__device__ __forceinline__ float log_f32(float u) {
  const float x = fmaxf(u, 0x1.0p-126f);
  const uint32_t bits = __float_as_uint(x);
  float e = __fadd_rn(1.0f, (float)((int)(bits >> 23) - 127));
  const float m = __uint_as_float((bits & 0x807FFFFFu) | 0x3F000000u);
  const bool lt = m < 0x1.6a09e6p-1f;
  e = __fsub_rn(e, lt ? 1.0f : 0.0f);
  const float z = __fadd_rn(__fsub_rn(m, 1.0f), lt ? m : 0.0f);
  const float z2 = __fmul_rn(z, z);
  const float z3 = __fmul_rn(z2, z);
  float y = __fmaf_rn(z, 0x1.204376p-4f, -0x1.d7a37p-4f);
  y = __fmaf_rn(y, z, 0x1.de4a34p-4f);
  float y1 = __fmaf_rn(z, -0x1.fcba9ep-4f, 0x1.23d37ep-3f);
  y1 = __fmaf_rn(y1, z, -0x1.555ca0p-3f);
  y1 = __fmaf_rn(z3, y, y1);
  float y2 = __fmaf_rn(z, 0x1.999d58p-3f, -0x1.fffff8p-3f);
  y2 = __fmaf_rn(y2, z, 0x1.555554p-2f);
  const float t = __fmaf_rn(z3, y1, y2);
  const float s = __fmaf_rn(z3, t, __fmul_rn(e, -0x1.bd0106p-13f));
  const float a = __fmaf_rn(-0.5f, z2, z);
  return __fmaf_rn(0x1.63p-1f, e, __fadd_rn(a, s));
}

// Cephes-style expf as XLA:CPU compiles it for jnp.exp (two FMAs in the
// range reduction, six in the polynomial); the same routine as
// repro_torch/core/mathf.py::exp_f32
__device__ __forceinline__ float exp_f32(float x) {
  x = fminf(fmaxf(x, -0x1.5f3334p+6f), 0x1.633334p+6f);  // [-87.8, 88.8]
  const float n = fminf(
      fmaxf(floorf(__fmaf_rn(x, 0x1.715476p+0f, 0.5f)), -127.0f), 127.0f);
  float r = __fmaf_rn(n, -0x1.63p-1f, x);      // x - n * 0.693359375
  r = __fmaf_rn(n, 0x1.bd0106p-13f, r);        // - n * -2.12194440e-4
  const float z = __fmul_rn(r, r);
  float y = __fmaf_rn(r, 0x1.a0d2cep-13f, 0x1.6e879cp-10f);
  y = __fmaf_rn(y, r, 0x1.11121p-7f);
  y = __fmaf_rn(y, r, 0x1.555382p-5f);
  y = __fmaf_rn(y, r, 0x1.555554p-3f);
  y = __fmaf_rn(y, r, 0.5f);
  y = __fadd_rn(1.0f, __fmaf_rn(y, z, r));
  return __fmul_rn(y, __int_as_float(((int)n + 127) << 23));
}

// Inverse-transform Poisson draw for lam >= 0: the number of the first 64
// CDF terms below u (pmf = exp(-lam), then pmf *= lam / i, cdf += pmf), as
// core/tau_leap.py::poisson_from_uniform counts them. The cdf never falls
// when lam >= 0, so the loop stops at the first term that reaches u.
__device__ __forceinline__ float poisson_from_uniform(float u, float lam) {
  float pmf = exp_f32(-lam);
  float cdf = pmf;
  float k = 0.0f;
  for (int i = 1; cdf < u; ++i) {
    k = __fadd_rn(k, 1.0f);
    if (i == 64) break;
    pmf = __fmul_rn(pmf, __fdiv_rn(lam, (float)i));
    cdf = __fadd_rn(cdf, pmf);
  }
  return k;
}

// the 64-bit counter (lo, hi) plus inc < 2^32, carry into hi
__device__ __forceinline__ void ctr_add(uint32_t lo, uint32_t hi,
                                        uint32_t inc, uint32_t& lo_out,
                                        uint32_t& hi_out) {
  lo_out = lo + inc;
  hi_out = hi + (lo_out < lo ? 1u : 0u);
}

// C(p, c) for one reactant slot with c >= 1, as `comb_factors` evaluates
// it: the falling factorial p (p-1) ... over c!, unrolled to max_c
// (iterations past c keep the running values). A caller passing a
// constant max_c (the dense kernels' MAX_COEF) gets the loop fully
// unrolled. Operations are skipped where the result is exact without
// them: for c = 1, 1 * max(p - 0, 0) is max(p, 0) for every p; ff / 2
// and ff * 0.5 are the same real number rounded once (ff is never NaN:
// every factor is max(., 0) of a non-NaN p - i).
__device__ __forceinline__ float comb_factor(float p, int c, int max_c) {
  if (c == 1) return fmaxf(p, 0.0f);
  float ff = 1.0f;
  for (int i = 0; i < max_c; ++i) {
    if (c > i) ff = __fmul_rn(ff, fmaxf(__fsub_rn(p, (float)i), 0.0f));
  }
  if (c == 2) return __fmul_rn(ff, 0.5f);
  float fact = 2.0f;  // c!, exact in float32
  for (int i = 2; i < max_c; ++i) {
    if (c > i) fact = __fmul_rn(fact, (float)(i + 1));
  }
  return __fdiv_rn(ff, fact);
}

// exponential waiting time of the direct method: -log(u1) / max(a0, 1e-30)
__device__ __forceinline__ float waiting_time(float u1, float a0) {
  return __fdiv_rn(-log_f32(u1), fmaxf(a0, 0x1.4484cp-100f));
}

// One lane's column of a store laid out lanes minor, STRIDE lanes wide:
// element i at p[i * STRIDE]. A warp's 32 threads on 32 neighbouring
// columns of shared memory read 32 distinct banks whatever row each of
// them reads (STRIDE a multiple of 32); a constant stride makes every
// row's offset an immediate.
template <int STRIDE>
struct Column {
  float* p;
  __device__ __forceinline__ float& operator[](int i) const {
    return p[i * STRIDE];
  }
};

// Persistent lanes: the next ticket of a counter that starts at 0 (the
// caller adds the lanes the grid took first). Threads of a warp that ask
// together share one atomic and take consecutive tickets. Needs a block
// width that is a multiple of 32.
__device__ __forceinline__ int take_lane(int* ticket) {
  const unsigned act = __activemask();
  const int me = threadIdx.x & 31;
  const int leader = __ffs(act) - 1;
  int base = 0;
  if (me == leader) base = atomicAdd(ticket, __popc(act));
  base = __shfl_sync(act, base, leader);
  return base + __popc(act & ((1u << me) - 1u));
}

}  // namespace ssa
