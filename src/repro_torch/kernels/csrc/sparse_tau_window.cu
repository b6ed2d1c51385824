// Fused sparse adaptive tau-leap window for Hopper (sm_90a), one thread
// per lane.
//
// Replaces the Pallas TPU kernel
// `repro/kernels/ssa_step.py::_sparse_tau_window_kernel` (driven there by
// `repro/kernels/ops.py::sparse_tau_window_chunk_loop`): the dense tau
// kernel's step (tau_step.cuh) for networks it cannot hold — hundreds of
// species and reactions, or a reactant coefficient above 4 (the comb unroll
// goes to the system's own `max_c`). The reference keeps dense (R, S) delta
// products for mu, sig2 and dx; this kernel walks the nonzeros of each
// species' column of delta in ascending reaction order, which gives the same
// bits (a skipped zero adds +0), and the rows of delta for the exact
// sub-step.
//
// Layout. The tables are read from global memory through the read-only
// cache (a few tens of KB for ring80). The lane's populations (S, B),
// propensities (R, B) and Poisson counts (R, B) live in scratch tensors
// allocated per launch, lanes minor, so the 32 lanes of a warp touch one
// 128-byte line per species or reaction. Per-lane rates are read from the
// (B, R) operand.
//
// Bound: for a large network, bytes of the scratch, not ALU work. Each
// iteration writes R propensities and reads them again for a0's scan, the
// Cao sums (two reads per nonzero of delta) and the draws, and each leap
// attempt writes R counts and reads them per nonzero twice. At R = 560 that
// is tens of KB per lane and iteration, far beyond what the 50 MB L2 holds
// for a whole ensemble, so it streams from HBM. This is the simple, correct
// form: keeping the lane's arrays on chip is later work.
//
// Build: kernels/build.py (sm_90a, one library with the other kernels).
// C interface, bound by ctypes.

#include "tau_step.cuh"

namespace {

struct ScratchStore {
  float* xs;
  float* as;
  float* ks;
  size_t B;
  __device__ float& x(int i) { return xs[(size_t)i * B]; }
  __device__ float& a(int j) { return as[(size_t)j * B]; }
  __device__ float& kc(int j) { return ks[(size_t)j * B]; }
};

__global__ void sparse_tau_window_kernel(
    const float* __restrict__ x, const float* __restrict__ t,
    const int* __restrict__ dead, const int* __restrict__ no_leap,
    const uint32_t* __restrict__ key, const uint32_t* __restrict__ ctr,
    const uint32_t* __restrict__ ctr_hi, const int* __restrict__ idx,
    const int* __restrict__ coef, const int* __restrict__ col_j,
    const float* __restrict__ col_v, const int* __restrict__ row_idx,
    const float* __restrict__ row_val, const float* __restrict__ rates,
    const float* __restrict__ gi, const float* __restrict__ rmask,
    int rates_per_lane, float horizon, int n_steps, float eps,
    float fallback, int B, int S, int R, int L, int D, int G, int max_c,
    float* __restrict__ xs, float* __restrict__ as, float* __restrict__ ks,
    float* __restrict__ x_out, float* __restrict__ t_out,
    int* __restrict__ dead_out, int* __restrict__ steps_out,
    int* __restrict__ leaps_out, uint32_t* __restrict__ ctr_out,
    uint32_t* __restrict__ ctr_hi_out, int* __restrict__ iters_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const tau::Tables tb{idx, coef, col_j, col_v, row_idx, row_val,
                       gi,  rmask, S,   R,     L,       D,       G};
  const float* rate = rates_per_lane ? rates + (size_t)lane * R : rates;
  const float fb = no_leap[lane] > 0 ? INFINITY : fallback;

  ScratchStore st{xs + lane, as + lane, ks + lane, (size_t)B};
  for (int s = 0; s < S; ++s) st.x(s) = x[(size_t)lane * S + s];
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
    tau::iteration(st, tb, rate, max_c, horizon, eps, fb, k0, k1, ln);
  }

  for (int s = 0; s < S; ++s) x_out[(size_t)lane * S + s] = st.x(s);
  t_out[lane] = ln.t;
  dead_out[lane] = ln.dead ? 1 : 0;
  steps_out[lane] = ln.steps;
  leaps_out[lane] = ln.leaps;
  ctr_out[lane] = ln.c_lo;
  ctr_hi_out[lane] = ln.c_hi;
  iters_out[lane] = it;
}

}  // namespace

extern "C" int sparse_tau_window_launch(
    const void* x, const void* t, const void* dead, const void* no_leap,
    const void* key, const void* ctr, const void* ctr_hi, const void* idx,
    const void* coef, const void* col_j, const void* col_v,
    const void* row_idx, const void* row_val, const void* rates,
    const void* gi, const void* rmask, int rates_per_lane, float horizon,
    int n_steps, float eps, float fallback, int B, int S, int R, int L, int D,
    int G, int max_c, void* xs, void* as, void* ks, void* x_out, void* t_out,
    void* dead_out, void* steps_out, void* leaps_out, void* ctr_out,
    void* ctr_hi_out, void* iters_out, void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || R < 1 || L < 1 || D < 1 || G < 1 || max_c < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  sparse_tau_window_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)t, (const int*)dead,
      (const int*)no_leap, (const uint32_t*)key, (const uint32_t*)ctr,
      (const uint32_t*)ctr_hi, (const int*)idx, (const int*)coef,
      (const int*)col_j, (const float*)col_v, (const int*)row_idx,
      (const float*)row_val, (const float*)rates, (const float*)gi,
      (const float*)rmask, rates_per_lane, horizon, n_steps, eps, fallback, B,
      S, R, L, D, G, max_c, (float*)xs, (float*)as, (float*)ks,
      (float*)x_out, (float*)t_out, (int*)dead_out, (int*)steps_out,
      (int*)leaps_out, (uint32_t*)ctr_out, (uint32_t*)ctr_hi_out,
      (int*)iters_out);
  return (int)cudaGetLastError();
}
