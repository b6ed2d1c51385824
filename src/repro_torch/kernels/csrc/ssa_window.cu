// Fused dense exact-SSA window for Hopper (sm_90a), one thread per lane.
//
// Replaces the Pallas TPU kernel `repro/kernels/ssa_step.py::_window_kernel`
// (driven there by `repro/kernels/ops.py::window_chunk_loop`). Each lane
// runs up to `n_steps` direct-method events toward `horizon`:
//
//   Match   rates-first products of C(n, c), the populations gathered by
//           reactant index (the reference's one-hot matmul gives the same
//           bits on integer-valued float32 populations);
//   Resolve threefry2x32 uniforms from the lane's (key, counter) stream,
//           tau = -log(u1) / max(a0, 1e-30), first r with cumsum >= u2*a0;
//   Update  x += delta[j]; a lane whose next event would cross the horizon
//           freezes there; the counter advances once per active step.
//
// A lane stops as soon as it is no longer live (clock at the horizon or
// dead). Steps of a finished lane are exact no-ops in the reference, so a
// lane's final state has the bits that repeated shorter launches give: one
// launch with n_steps = chunk_steps * max_chunks replaces the reference's
// device-side chunk loop, and a window is one launch with no mid-window
// synchronisation.
//
// Bits. The stream, `log_f32` and the comb factors come from
// ssa_common.cuh, shared with the other kernels: explicitly rounded
// intrinsics only, never CUDA's logf. Sums over reactions run left to
// right. The propensities are computed twice per event (once for
// a0, once for the scan) so no per-lane R array is needed; recomputation
// gives the same bits.
//
// Bound: ALU work, not bytes. Per window a lane reads and writes about
// 62 bytes of pool state, against a few hundred integer and float
// operations for each of its hundreds to thousands of events (20 threefry
// rounds, the log polynomial, two Match passes, the scan, the update).
// The system tables (reactant index and coefficient, delta, and the rates
// when every lane shares them) sit in shared memory; the lane's
// populations live in a per-thread array that the reactant gather indexes,
// which puts it in local memory (L1-resident).
//
// Build: kernels/build.py (sm_90a, one library with the other kernels).
// C interface, bound by ctypes.

#include "ssa_common.cuh"

#define SSA_MAX_S 64
#define SSA_MAX_R 64
#define SSA_MAX_REACTANTS 4
#define SSA_MAX_COEF 4

namespace {

// rates-first propensity of reaction r: rate * C(n_0, c_0) * ... in slot
// order; a slot with c == 0 contributes exactly 1 and is skipped
__device__ __forceinline__ float propensity(int r, const float* xs,
                                            const int* s_idx,
                                            const int* s_coef, float rate) {
  float a = rate;
#pragma unroll
  for (int m = 0; m < SSA_MAX_REACTANTS; ++m) {
    const int c = s_coef[r * SSA_MAX_REACTANTS + m];
    if (c > 0) {
      const float p = xs[s_idx[r * SSA_MAX_REACTANTS + m]];
      a = __fmul_rn(a, ssa::comb_factor(p, c, SSA_MAX_COEF));
    }
  }
  return a;
}

__global__ void ssa_window_kernel(
    const float* __restrict__ x, const float* __restrict__ t,
    const int* __restrict__ dead, const uint32_t* __restrict__ key,
    const uint32_t* __restrict__ ctr, const uint32_t* __restrict__ ctr_hi,
    const int* __restrict__ idx, const int* __restrict__ coef,
    const float* __restrict__ delta, const float* __restrict__ rates,
    int rates_per_lane, float horizon, int n_steps, int B, int S, int R,
    float* __restrict__ x_out, float* __restrict__ t_out,
    int* __restrict__ dead_out, int* __restrict__ steps_out,
    uint32_t* __restrict__ ctr_out, uint32_t* __restrict__ ctr_hi_out) {
  extern __shared__ int smem[];
  int* s_idx = smem;
  int* s_coef = s_idx + R * SSA_MAX_REACTANTS;
  float* s_delta = reinterpret_cast<float*>(s_coef + R * SSA_MAX_REACTANTS);
  float* s_rates = s_delta + R * S;
  for (int i = threadIdx.x; i < R * SSA_MAX_REACTANTS; i += blockDim.x) {
    s_idx[i] = idx[i];
    s_coef[i] = coef[i];
  }
  for (int i = threadIdx.x; i < R * S; i += blockDim.x) s_delta[i] = delta[i];
  if (!rates_per_lane) {
    for (int i = threadIdx.x; i < R; i += blockDim.x) s_rates[i] = rates[i];
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const float* rate = rates_per_lane ? rates + (size_t)lane * R : s_rates;

  float xs[SSA_MAX_S + 1];
  for (int s = 0; s < S; ++s) xs[s] = x[(size_t)lane * S + s];
  xs[S] = 1.0f;
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
    for (int r = 0; r < R; ++r) {
      a0 = __fadd_rn(a0, propensity(r, xs, s_idx, s_coef, rate[r]));
    }
    const bool now_dead = a0 <= 0.0f;
    uint32_t b0, b1;
    ssa::threefry2x32(k0, k1, c_lo, c_hi, b0, b1);
    const float u1 = ssa::bits_to_uniform(b0);
    const float u2 = ssa::bits_to_uniform(b1);
    const float tau = ssa::waiting_time(u1, a0);
    const float t_next = __fadd_rn(tl, tau);
    if (!now_dead && t_next <= horizon) {
      const float thresh = __fmul_rn(u2, a0);
      int j = 0;  // first true, 0 when none (the reference's argmax)
      float cum = 0.0f;
      for (int r = 0; r < R; ++r) {
        cum = __fadd_rn(cum, propensity(r, xs, s_idx, s_coef, rate[r]));
        if (cum >= thresh) {
          j = r;
          break;
        }
      }
      const float* d = s_delta + j * S;
      for (int s = 0; s < S; ++s) xs[s] = __fadd_rn(xs[s], d[s]);
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

  for (int s = 0; s < S; ++s) x_out[(size_t)lane * S + s] = xs[s];
  t_out[lane] = tl;
  dead_out[lane] = dl ? 1 : 0;
  steps_out[lane] = steps;
  ctr_out[lane] = c_lo;
  ctr_hi_out[lane] = c_hi;
}

}  // namespace

extern "C" int ssa_window_launch(
    const void* x, const void* t, const void* dead, const void* key,
    const void* ctr, const void* ctr_hi, const void* idx, const void* coef,
    const void* delta, const void* rates, int rates_per_lane, float horizon,
    int n_steps, int B, int S, int R, void* x_out, void* t_out,
    void* dead_out, void* steps_out, void* ctr_out, void* ctr_hi_out,
    void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || S > SSA_MAX_S || R < 1 || R > SSA_MAX_R) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  const size_t smem = (size_t)R * SSA_MAX_REACTANTS * 2 * sizeof(int) +
                      (size_t)R * S * sizeof(float) + (size_t)R * sizeof(float);
  ssa_window_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)t, (const int*)dead,
      (const uint32_t*)key, (const uint32_t*)ctr, (const uint32_t*)ctr_hi,
      (const int*)idx, (const int*)coef, (const float*)delta,
      (const float*)rates, rates_per_lane, horizon, n_steps, B, S, R,
      (float*)x_out, (float*)t_out, (int*)dead_out, (int*)steps_out,
      (uint32_t*)ctr_out, (uint32_t*)ctr_hi_out);
  return (int)cudaGetLastError();
}
