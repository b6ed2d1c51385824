// A CPU stand-in for the CUDA runtime, enough to run the generated dense
// window kernel (kernels/netgen.py) built by g++: each CUDA thread is an
// OS thread, a block's threads share one barrier, the blocks of a grid
// run one after another on a "card" of two SMs, one block each, so lanes
// past the first wave come from the persistent-lane ticket. Every float
// operation rounds once to nearest (build with -ffp-contract=off);
// a warp's collectives see one thread.
#pragma once
#include <stdint.h>

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __launch_bounds__(...)

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline thread_local std::barrier<>* stub_barrier = nullptr;

inline void __syncthreads() { stub_barrier->arrive_and_wait(); }
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline unsigned __activemask() { return 1u << (threadIdx.x & 31); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class T>
inline T __shfl_sync(unsigned, T v, int) {
  return v;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __int_as_float(int u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}
inline float __fsub_rn(float a, float b) {
  volatile float r = a - b;
  return r;
}
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fdiv_rn(float a, float b) {
  volatile float r = a / b;
  return r;
}
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }

typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// kernel<<<blocks, threads, 0, stream>>>(p), rewritten by the test
template <class K, class P>
void stub_launch(K kernel, int blocks, int threads, P p) {
  blockDim = {(unsigned)threads, 1, 1};
  gridDim = {(unsigned)blocks, 1, 1};
  for (int b = 0; b < blocks; ++b) {
    std::barrier<> bar(threads);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) {
      ts.emplace_back([&, b, t] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        stub_barrier = &bar;
        kernel(p);
      });
    }
    for (auto& th : ts) th.join();
  }
}
