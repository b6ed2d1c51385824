// Fused sparse exact-SSA window for Hopper (sm_90a), one thread per lane.
//
// Replaces the Pallas TPU kernel
// `repro/kernels/ssa_step.py::_sparse_window_kernel` (driven there by
// `repro/kernels/ops.py::sparse_window_chunk_loop`). The step is the
// reference's `gillespie.sparse_ssa_step`: the (R,) propensity vector is
// carried across events and, after reaction j fires, only the rows of its
// dependency list dep(j) are recomputed. It serves the networks the dense
// kernel cannot hold (hundreds of species and reactions, or a reactant
// coefficient above 4).
//
//   Seed    at launch every a[r] from x: rates first, slots in order, the
//           comb unroll to the system's max_c (propensities are a pure
//           function of x, so a seed per launch has the carried bits);
//   Resolve a0 = left-to-right sum of the carry; threefry2x32 uniforms;
//           tau = -log(u1) / max(a0, 1e-30); j = first r whose running
//           sum reaches u2*a0 (0 when none);
//   Update  x += the D entries of row j; recompute the K dep rows of j in
//           the reference's slot order; a lane whose next event would
//           cross the horizon freezes there; the counter advances once
//           per active step.
//
// Layout. The lane's populations live in its row of the output `x_out`
// (global memory): S runs to hundreds, too many for registers. The carry
// is a scratch tensor laid out (R+1, B), lanes minor, so the 32 lanes of a
// warp read one 128-byte line per reaction in the a0 sum and the scan; row
// R takes the writes of pad dep entries and is never read. The packed
// recipe rows (int_tab, flt_tab: `gillespie.bind_sparse_step`) are read
// through the read-only cache. Shared rates come packed in flt_tab (and,
// for the seed, as the (R+1,) rates operand); per-lane rates are read from
// the (B, R+1) operand.
//
// Bits. Explicit `_rn` intrinsics and the port's `log_f32` from
// ssa_common.cuh; the a0 sum and the scan run left to right.
//
// Bound: for a large network, bytes of the carry, not ALU work. Each
// active step reads R carried floats for a0 and up to j+1 more for the
// scan. At R = 560 that is over 2 KB a step, which the 50 MB L2 cannot
// hold for a whole ensemble, so the carry streams from HBM. The kernel is
// the simple, correct form: keeping the carry on chip (shared memory
// tiles, a partial-sum tree) is later work.

#include "ssa_common.cuh"

namespace {

__global__ void sparse_window_kernel(
    const float* __restrict__ x, const float* __restrict__ t,
    const int* __restrict__ dead, const uint32_t* __restrict__ key,
    const uint32_t* __restrict__ ctr, const uint32_t* __restrict__ ctr_hi,
    const int* __restrict__ idx_pad, const int* __restrict__ coef_pad,
    const int* __restrict__ int_tab, const float* __restrict__ flt_tab,
    const float* __restrict__ rates_pad, int rates_per_lane, float horizon,
    int n_steps, int B, int S, int R, int M, int D, int K, int max_c,
    float* __restrict__ carry, float* __restrict__ x_out,
    float* __restrict__ t_out, int* __restrict__ dead_out,
    int* __restrict__ steps_out, uint32_t* __restrict__ ctr_out,
    uint32_t* __restrict__ ctr_hi_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int wi = D + K + K * M;
  const int wf = D + K * M + (rates_per_lane ? 0 : K);
  const float* rate =
      rates_per_lane ? rates_pad + (size_t)lane * (R + 1) : rates_pad;
  float* xl = x_out + (size_t)lane * S;
  float* a = carry + lane;  // a[r * B]: reaction r of this lane
  for (int s = 0; s < S; ++s) xl[s] = x[(size_t)lane * S + s];

  for (int r = 0; r < R; ++r) {
    float v = __ldg(rate + r);
    for (int m = 0; m < M; ++m) {
      const int c = __ldg(coef_pad + r * M + m);
      if (c > 0) {  // a slot with c == 0 contributes exactly 1
        v = __fmul_rn(v, ssa::comb_factor(xl[__ldg(idx_pad + r * M + m)], c,
                                          max_c));
      }
    }
    a[(size_t)r * B] = v;
  }

  float tl = t[lane];
  bool dl = dead[lane] > 0;
  const uint32_t k0 = key[2 * (size_t)lane];
  const uint32_t k1 = key[2 * (size_t)lane + 1];
  uint32_t c_lo = ctr[lane];
  uint32_t c_hi = ctr_hi[lane];
  int steps = 0;

  // a lane that is not live stays so: its remaining steps are no-ops
  for (int it = 0; it < n_steps && tl < horizon && !dl; ++it) {
    float a0 = 0.0f;
    for (int r = 0; r < R; ++r) a0 = __fadd_rn(a0, a[(size_t)r * B]);
    const bool now_dead = a0 <= 0.0f;
    uint32_t b0, b1;
    ssa::threefry2x32(k0, k1, c_lo, c_hi, b0, b1);
    const float u1 = ssa::bits_to_uniform(b0);
    const float u2 = ssa::bits_to_uniform(b1);
    const float t_next = __fadd_rn(tl, ssa::waiting_time(u1, a0));
    if (!now_dead && t_next <= horizon) {
      const float thresh = __fmul_rn(u2, a0);
      int j = 0;  // first true, 0 when none (the reference's argmax)
      float cum = 0.0f;
      for (int r = 0; r < R; ++r) {
        cum = __fadd_rn(cum, a[(size_t)r * B]);
        if (cum >= thresh) {
          j = r;
          break;
        }
      }
      const int* it_row = int_tab + (size_t)j * wi;
      const float* ft_row = flt_tab + (size_t)j * wf;
      for (int q = 0; q < D; ++q) {  // pads index S: dropped
        const int s = __ldg(it_row + q);
        if (s < S) xl[s] = __fadd_rn(xl[s], __ldg(ft_row + q));
      }
      for (int kk = 0; kk < K; ++kk) {  // pad entries R hit the junk row
        const int rr = __ldg(it_row + D + kk);
        float v = rates_per_lane ? __ldg(rate + rr)
                                 : __ldg(ft_row + D + K * M + kk);
        for (int m = 0; m < M; ++m) {
          const int c = (int)__ldg(ft_row + D + kk * M + m);
          if (c > 0) {
            const int s = __ldg(it_row + D + K + kk * M + m);
            v = __fmul_rn(v, ssa::comb_factor(xl[s], c, max_c));
          }
        }
        a[(size_t)rr * B] = v;
      }
      tl = t_next;
      ++steps;
    } else {
      // dead, or the next event would cross: freeze at the horizon
      tl = horizon;
      dl = now_dead;
    }
    c_lo += 1u;
    c_hi += (c_lo == 0u) ? 1u : 0u;
  }

  t_out[lane] = tl;
  dead_out[lane] = dl ? 1 : 0;
  steps_out[lane] = steps;
  ctr_out[lane] = c_lo;
  ctr_hi_out[lane] = c_hi;
}

}  // namespace

extern "C" int sparse_window_launch(
    const void* x, const void* t, const void* dead, const void* key,
    const void* ctr, const void* ctr_hi, const void* idx_pad,
    const void* coef_pad, const void* int_tab, const void* flt_tab,
    const void* rates_pad, int rates_per_lane, float horizon, int n_steps,
    int B, int S, int R, int M, int D, int K, int max_c, void* carry,
    void* x_out, void* t_out, void* dead_out, void* steps_out,
    void* ctr_out, void* ctr_hi_out, void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || R < 1 || M < 1 || D < 1 || K < 1 || max_c < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  sparse_window_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)t, (const int*)dead,
      (const uint32_t*)key, (const uint32_t*)ctr, (const uint32_t*)ctr_hi,
      (const int*)idx_pad, (const int*)coef_pad, (const int*)int_tab,
      (const float*)flt_tab, (const float*)rates_pad, rates_per_lane,
      horizon, n_steps, B, S, R, M, D, K, max_c, (float*)carry,
      (float*)x_out, (float*)t_out, (int*)dead_out, (int*)steps_out,
      (uint32_t*)ctr_out, (uint32_t*)ctr_hi_out);
  return (int)cudaGetLastError();
}
