// Fused dense adaptive tau-leap window for Hopper (sm_90a), one thread per
// lane.
//
// Replaces the Pallas TPU kernel
// `repro/kernels/ssa_step.py::_tau_window_kernel` (driven there by
// `repro/kernels/ops.py::tau_window_chunk_loop`). Each lane runs up to
// `n_steps` tau-leap-or-exact iterations toward `horizon` (tau_step.cuh,
// the step of repro_torch/core/tau_leap.py::tau_step_core) and stops as
// soon as it is no longer live. A finished lane's iterations are exact
// no-ops in the reference, so one launch with n_steps = chunk_steps *
// max_chunks replaces the reference's device-side chunk loop; each lane's
// count of active iterations comes back, from which the host recovers the
// reference's chunk count.
//
// Layout. For systems of S <= 64 species and R <= 64 reactions with
// reactant coefficients <= 4: every table (reactant index and
// coefficient, delta by columns and by rows, the g_i table, the reactant
// mask, and the rates when every lane shares them) sits in shared memory;
// the lane's populations, propensities and Poisson counts live in
// per-thread arrays that the step indexes, which puts them in local memory
// (L1-resident).
//
// Bound: ALU work, not bytes. Per window a lane reads and writes its pool
// state once (about 70 bytes for lv8), against hundreds of float and
// integer operations per iteration: the Match, the Cao bound's divisions,
// ceil(R/2) threefry blocks and one Poisson inversion per reaction (an
// exp_f32 and up to 63 divide-multiply-add terms) per leap attempt.
//
// Build: kernels/build.py (sm_90a, one library with the other kernels).
// C interface, bound by ctypes.

#include "tau_step.cuh"

#define TAU_MAX_S 64
#define TAU_MAX_R 64
#define TAU_MAX_COEF 4

namespace {

struct LocalStore {
  float xs[TAU_MAX_S];
  float as[TAU_MAX_R];
  float ks[TAU_MAX_R];
  __device__ float& x(int i) { return xs[i]; }
  __device__ float& a(int j) { return as[j]; }
  __device__ float& kc(int j) { return ks[j]; }
};

template <class T>
__device__ __forceinline__ T* stage(const T* src, int n, char*& cursor) {
  T* dst = reinterpret_cast<T*>(cursor);
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  cursor += (size_t)n * sizeof(T);
  return dst;
}

__global__ void tau_window_kernel(
    const float* __restrict__ x, const float* __restrict__ t,
    const int* __restrict__ dead, const int* __restrict__ no_leap,
    const uint32_t* __restrict__ key, const uint32_t* __restrict__ ctr,
    const uint32_t* __restrict__ ctr_hi, const int* __restrict__ idx,
    const int* __restrict__ coef, const int* __restrict__ col_j,
    const float* __restrict__ col_v, const int* __restrict__ row_idx,
    const float* __restrict__ row_val, const float* __restrict__ rates,
    const float* __restrict__ gi, const float* __restrict__ rmask,
    int rates_per_lane, float horizon, int n_steps, float eps,
    float fallback, int B, int S, int R, int L, int D, int G,
    float* __restrict__ x_out, float* __restrict__ t_out,
    int* __restrict__ dead_out, int* __restrict__ steps_out,
    int* __restrict__ leaps_out, uint32_t* __restrict__ ctr_out,
    uint32_t* __restrict__ ctr_hi_out, int* __restrict__ iters_out) {
  extern __shared__ __align__(16) char smem[];
  char* cursor = smem;
  tau::Tables tb;
  tb.idx = stage(idx, R * 4, cursor);
  tb.coef = stage(coef, R * 4, cursor);
  tb.col_j = stage(col_j, S * L, cursor);
  tb.col_v = stage(col_v, S * L, cursor);
  tb.row_idx = stage(row_idx, (R + 1) * D, cursor);
  tb.row_val = stage(row_val, (R + 1) * D, cursor);
  tb.gi = stage(gi, G * S, cursor);
  tb.rmask = stage(rmask, S, cursor);
  const float* s_rates = rates_per_lane ? rates : stage(rates, R, cursor);
  tb.S = S;
  tb.R = R;
  tb.L = L;
  tb.D = D;
  tb.G = G;
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const float* rate = rates_per_lane ? rates + (size_t)lane * R : s_rates;
  const float fb = no_leap[lane] > 0 ? INFINITY : fallback;

  LocalStore st;
  for (int s = 0; s < S; ++s) st.xs[s] = x[(size_t)lane * S + s];
  tau::Lane ln;
  ln.t = t[lane];
  ln.dead = dead[lane] > 0;
  ln.c_lo = ctr[lane];
  ln.c_hi = ctr_hi[lane];
  ln.steps = 0;
  ln.leaps = 0;
  const uint32_t k0 = key[2 * (size_t)lane];
  const uint32_t k1 = key[2 * (size_t)lane + 1];

  int it = 0;  // a lane that is not live stays so: later iterations no-op
  for (; it < n_steps && ln.t < horizon && !ln.dead; ++it) {
    tau::iteration(st, tb, rate, TAU_MAX_COEF, horizon, eps, fb, k0, k1,
                   ln);
  }

  for (int s = 0; s < S; ++s) x_out[(size_t)lane * S + s] = st.xs[s];
  t_out[lane] = ln.t;
  dead_out[lane] = ln.dead ? 1 : 0;
  steps_out[lane] = ln.steps;
  leaps_out[lane] = ln.leaps;
  ctr_out[lane] = ln.c_lo;
  ctr_hi_out[lane] = ln.c_hi;
  iters_out[lane] = it;
}

}  // namespace

extern "C" int tau_window_launch(
    const void* x, const void* t, const void* dead, const void* no_leap,
    const void* key, const void* ctr, const void* ctr_hi, const void* idx,
    const void* coef, const void* col_j, const void* col_v,
    const void* row_idx, const void* row_val, const void* rates,
    const void* gi, const void* rmask, int rates_per_lane, float horizon,
    int n_steps, float eps, float fallback, int B, int S, int R, int L, int D,
    int G, int max_c, void* x_out, void* t_out, void* dead_out,
    void* steps_out, void* leaps_out, void* ctr_out, void* ctr_hi_out,
    void* iters_out, void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || S > TAU_MAX_S || R < 1 || R > TAU_MAX_R || L < 1 || D < 1 ||
      G < 1 || max_c != TAU_MAX_COEF) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      sizeof(int) * ((size_t)8 * R + 2 * (size_t)S * L + 2 * (size_t)(R + 1) * D +
                     (size_t)G * S + S + (rates_per_lane ? 0 : R));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tau_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  tau_window_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)t, (const int*)dead,
      (const int*)no_leap, (const uint32_t*)key, (const uint32_t*)ctr,
      (const uint32_t*)ctr_hi, (const int*)idx, (const int*)coef,
      (const int*)col_j, (const float*)col_v, (const int*)row_idx,
      (const float*)row_val, (const float*)rates, (const float*)gi,
      (const float*)rmask, rates_per_lane, horizon, n_steps, eps, fallback, B,
      S, R, L, D, G, (float*)x_out, (float*)t_out, (int*)dead_out,
      (int*)steps_out, (int*)leaps_out, (uint32_t*)ctr_out,
      (uint32_t*)ctr_hi_out, (int*)iters_out);
  return (int)cudaGetLastError();
}
