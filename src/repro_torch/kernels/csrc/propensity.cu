// The Match alone for Hopper (sm_90a): (B, R) mass-action propensities,
// one thread per (lane, reaction).
//
// Replaces the Pallas TPU kernel `repro/kernels/propensity.py::
// _propensity_kernel` (`propensity_call`), which tiles 256 lanes x 256
// reactions and gathers populations with one-hot matmuls. Here each
// thread gathers its reactant populations by index, which gives the
// one-hot dot's bits on integer-valued float32 populations, and keeps the
// reference kernel's association: the slot factors C(n, c) multiplied from
// 1.0 in slot order, comb unroll to MAX_COEF = 4, the rate multiplied
// LAST (unlike the rates-first `propensities` of the SSA steps).
//
// Bound: bytes. A thread reads a few populations and one rate and writes
// one float, against a handful of float operations; consecutive threads
// take consecutive reactions of one lane, so the writes coalesce and the
// lane's population row is shared through L1.

#include "ssa_common.cuh"

#define PROP_MAX_COEF 4

namespace {

__global__ void propensity_kernel(const float* __restrict__ x,
                                  const int* __restrict__ idx,
                                  const int* __restrict__ coef,
                                  const float* __restrict__ rates,
                                  int rates_per_lane, int B, int S, int R,
                                  int M, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * R) return;
  const int b = (int)(i / R);
  const int r = (int)(i % R);
  float a = 1.0f;
  for (int m = 0; m < M; ++m) {
    const int c = __ldg(coef + r * M + m);
    if (c > 0) {  // a pad slot's factor is exactly 1
      const float p = __ldg(x + (size_t)b * S + __ldg(idx + r * M + m));
      a = __fmul_rn(a, ssa::comb_factor(p, c, PROP_MAX_COEF));
    }
  }
  out[i] = __fmul_rn(a, __ldg(rates + (rates_per_lane ? i : (size_t)r)));
}

}  // namespace

extern "C" int propensity_launch(const void* x, const void* idx,
                                 const void* coef, const void* rates,
                                 int rates_per_lane, int B, int S, int R,
                                 int M, void* out, void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (S < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const size_t n = (size_t)B * R;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  propensity_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)idx, (const int*)coef,
      (const float*)rates, rates_per_lane, B, S, R, M, (float*)out);
  return (int)cudaGetLastError();
}
