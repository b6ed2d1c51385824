// The Match alone for Hopper (sm_90a): (B, R) mass-action propensities,
// a block walking tiles of lanes.
//
// Replaces the Pallas TPU kernel `repro/kernels/propensity.py::
// _propensity_kernel` (`propensity_call`), which tiles 256 lanes x 256
// reactions and gathers populations with one-hot matmuls. Here each
// output gathers its reactant populations by index, which gives the
// one-hot dot's bits on integer-valued float32 populations, and keeps the
// reference kernel's association: the slot factors C(n, c) multiplied in
// slot order, comb unroll to MAX_COEF = 4, the rate multiplied LAST
// (unlike the rates-first `propensities` of the SSA steps).
//
// Bound: bytes (the outputs, and per-lane rates where given; ring80 at
// 2^18 lanes writes 587 MB), but only while the work per output stays a
// handful of instructions: no division, no table read or decode, no
// dependent device-memory gather per output. So:
//
// - A tile of `tile` lanes reads a contiguous block of x and writes a
//   contiguous block of out (and of per-lane rates). Route "shared"
//   stages the tile's population rows in shared memory with 16-byte
//   cp.async copies, double buffered, so the next tile's rows arrive
//   while this one computes; route "global" (a lane's row, or the
//   tables, too large for a block, or more than four slots a reaction)
//   gathers from x.
// - A thread's unit of work is an item: one reaction over a run of
//   item_lanes lanes of the tile (8 on the shared route, 4 on the global
//   one, where 8 spill). The reaction's slots are read and decoded once
//   for the run. Thread t of T takes items t, t + T, ...,
//   reactions minor, so a warp reads 32 neighbouring reactions' tables
//   and rates (no shared-memory bank conflicts) and each of its stores
//   (and per-lane rate loads) covers 128 contiguous bytes. (run,
//   reaction) is walked by 32-bit increments from a start and a step
//   divided once per thread.
// - The shared route keeps the reaction tables in shared memory, a
//   reaction's (at most four) slots packed as one int4 word of
//   species | coef << 24, live slots first in slot order and pad slots
//   (factor exactly 1) dropped, with the shared rates beside them.
// - A slot with c <= 2 takes the two factors of comb_factor's unroll
//   branch-free; c >= 3 calls ssa::comb_factor itself.
// - Persistent blocks: one wave, each walking tiles blockIdx, blockIdx +
//   gridDim, ... (tiles are equal work, so no ticket is needed).
//
// A NaN population gives a NaN factor, as the twin's clamp_min keeps NaN
// (fmaxf would turn it into 0).

#include <cuda_pipeline_primitives.h>

#include "ssa_common.cuh"

#define PROP_MAX_COEF 4

namespace {

struct MatchParams {
  const float* __restrict__ x;      // (B, S)
  const int* __restrict__ idx;      // (R, M)
  const int* __restrict__ coef;     // (R, M)
  const float* __restrict__ rates;  // (R,) or (B, R)
  float* __restrict__ out;          // (B, R)
  int rates_per_lane, B, S, R, M;
  int tile;     // lanes a tile
  int n_tiles;  // ceil(B / tile)
};

// C(p, c) as the twin evaluates it (comb_factors, unrolled to MAX_COEF),
// a NaN population kept. For c <= 2 the unroll's first two factors,
// branch-free: 1 * max(p - 0, 0) is max(p, 0), and ff / 2 is ff * 0.5
// (the same bits as ssa::comb_factor, 2% faster on ring80 than calling it
// for every c; PERF.md).
__device__ __forceinline__ float slot_factor(float p, int c) {
  float f;
  if (c <= 2) {
    const float m0 = fmaxf(p, 0.0f);
    const float f2 = __fmul_rn(
        __fmul_rn(m0, fmaxf(__fsub_rn(p, 1.0f), 0.0f)), 0.5f);
    f = c == 1 ? m0 : f2;
  } else {
    f = ssa::comb_factor(p, c, PROP_MAX_COEF);
  }
  return p != p ? p : f;
}

// the factor of one packed slot word against a lane's row
__device__ __forceinline__ float word_factor(int w, const float* xrow) {
  return slot_factor(xrow[w & 0xFFFFFF], (int)((unsigned)w >> 24));
}

// The product of a reaction's (at most four) packed words, live first:
// from the first factor on (1 * f is f; a NaN is made canonical by the
// rate's multiply as by the twin's), stopping at the first pad.
__device__ __forceinline__ float match_words(const int4 w,
                                             const float* xrow) {
  if (w.x == 0) return 1.0f;  // no reactant: the empty product
  float a = word_factor(w.x, xrow);
  if (w.y != 0) {
    a = __fmul_rn(a, word_factor(w.y, xrow));
    if (w.z != 0) {
      a = __fmul_rn(a, word_factor(w.z, xrow));
      if (w.w != 0) a = __fmul_rn(a, word_factor(w.w, xrow));
    }
  }
  return a;
}

// global route: the raw tables and a gather from x
__device__ __forceinline__ float match_gather(const MatchParams& p,
                                              const float* xrow, int r) {
  float a = 1.0f;
  for (int m = 0; m < p.M; ++m) {
    const int c = __ldg(p.coef + r * p.M + m);
    if (c > 0) {
      a = __fmul_rn(a, slot_factor(__ldg(xrow + __ldg(p.idx + r * p.M + m)),
                                   c));
    }
  }
  return a;
}

// lanes of an item's run: 8 on the shared route (ring80: 2-5% faster than
// 4), 4 on the global route (8 spill there); PERF.md
__host__ __device__ constexpr int item_lanes(bool staged) {
  return staged ? 8 : 4;
}

// The tile's outputs. Item i is reaction i % R over the lanes of run
// i / R (L lanes a run); thread t of T takes items t, t + T, ...;
// (c, r) is item t's (run, reaction), (dc, dr) the step T as runs and
// reactions. xt: the tile's first population row (shared or global);
// srates: the shared rates (shared or global memory; unused per lane).
template <bool STAGED>
__device__ __forceinline__ void match_tile(const MatchParams& p,
                                           const int4* tab,
                                           const float* srates,
                                           const float* xt, int tile,
                                           int c, int r, int dc, int dr) {
  constexpr int L = item_lanes(STAGED);
  const int t0 = tile * p.tile;
  const int lanes = min(p.tile, p.B - t0);
  const int n_items = (lanes + L - 1) / L * p.R;
  const size_t base = (size_t)t0 * p.R;
  float* out = p.out + base;
  const float* rl = p.rates_per_lane ? p.rates + base : nullptr;
  for (int i = threadIdx.x; i < n_items; i += blockDim.x) {
    const int l0 = c * L;
    const int nl = min(L, lanes - l0);
    const int o = l0 * p.R + r;  // the run's first output in the tile
    const float* xr = xt + l0 * p.S;
    float rv[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      rv[j] = rl == nullptr ? srates[r]
              : j < nl      ? __ldcs(rl + o + j * p.R)
                            : 0.0f;
    }
    const int4 w = STAGED ? tab[r] : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (j < nl) {
        const float* xrow = xr + j * p.S;
        const float a =
            STAGED ? match_words(w, xrow) : match_gather(p, xrow, r);
        out[o + j * p.R] = __fmul_rn(a, rv[j]);
      }
    }
    r += dr;
    c += dc;
    if (r >= p.R) {
      r -= p.R;
      ++c;
    }
  }
}

// Start the copy of tile `tile`'s population rows into dst (16-byte
// aligned): 16-byte cp.async where the source allows, else 4-byte.
__device__ __forceinline__ void stage_tile(const MatchParams& p, float* dst,
                                           int tile) {
  const int t0 = tile * p.tile;
  const int n = min(p.tile, p.B - t0) * p.S;
  const float* src = p.x + (size_t)t0 * p.S;
  int done = 0;
  if (((uintptr_t)src & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) {
    __pipeline_memcpy_async(dst + i, src + i, 4);
  }
  __pipeline_commit();
}

// The parts of the shared route's dynamic shared memory, in 4-byte words
// and each a multiple of 16 bytes: the packed table, the shared rates,
// one tile buffer (`propensity.match_smem_bytes`).
__host__ __device__ __forceinline__ int table_words(int R) {
  return 4 * R;
}
__host__ __device__ __forceinline__ int rates_floats(int R) {
  return (R + 3) / 4 * 4;
}
__host__ __device__ __forceinline__ int buffer_floats(int tile, int S) {
  return (tile * S + 3) / 4 * 4;
}

template <bool STAGED>
__global__ void __launch_bounds__(256)
    propensity_kernel(MatchParams p) {
  extern __shared__ int4 smem4[];
  const int4* tab = smem4;
  const float* srates = p.rates;
  float* buf0 = nullptr;  // the two tile buffers
  float* buf1 = nullptr;
  if (STAGED) {
    // each reaction's live slots packed first, in slot order;
    // coefficients above MAX_COEF give C(n, 4)'s bits, as the unroll
    int* words = reinterpret_cast<int*>(smem4);
    for (int r = threadIdx.x; r < p.R; r += blockDim.x) {
      int k = 0;
      for (int m = 0; m < p.M; ++m) {
        const int c = p.coef[r * p.M + m];
        if (c > 0) {
          words[4 * r + k++] = (p.idx[r * p.M + m] & 0xFFFFFF) |
                                ((c < PROP_MAX_COEF ? c : PROP_MAX_COEF)
                                 << 24);
        }
      }
      for (; k < 4; ++k) words[4 * r + k] = 0;
    }
    float* sr = reinterpret_cast<float*>(words + table_words(p.R));
    if (!p.rates_per_lane) {
      for (int i = threadIdx.x; i < p.R; i += blockDim.x) sr[i] = p.rates[i];
      srates = sr;
    }
    buf0 = sr + rates_floats(p.R);
    buf1 = buf0 + buffer_floats(p.tile, p.S);
  }
  // this thread's first item of a tile, and its step, as (run, reaction)
  const int c0 = (int)threadIdx.x / p.R, r0 = (int)threadIdx.x - c0 * p.R;
  const int dc = (int)blockDim.x / p.R, dr = (int)blockDim.x - dc * p.R;
  int tile = blockIdx.x;
  if (STAGED && tile < p.n_tiles) stage_tile(p, buf0, tile);
  for (bool odd = false; tile < p.n_tiles; tile += gridDim.x, odd = !odd) {
    const float* xt;
    if (STAGED) {
      const int next = tile + gridDim.x;
      if (next < p.n_tiles) {
        stage_tile(p, odd ? buf0 : buf1, next);
        __pipeline_wait_prior(1);  // this tile's copies are done
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();  // its rows (and, first, the tables) are visible
      xt = odd ? buf1 : buf0;
    } else {
      xt = p.x + (size_t)tile * p.tile * p.S;
    }
    match_tile<STAGED>(p, tab, srates, xt, tile, c0, r0, dc, dr);
    if (STAGED) __syncthreads();  // xt's buffer free for the tile after next
  }
}

template <bool STAGED>
int launch(const MatchParams& p, size_t smem, cudaStream_t stream) {
  const int threads = 256;
  auto kernel = propensity_kernel<STAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long wave = (long)n_sm * per_sm;
  const int blocks = (int)(p.n_tiles < wave ? p.n_tiles : wave);
  kernel<<<blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, S), rates (R,) or (B, R) (rates_per_lane), out (B, R) float32;
// idx, coef (R, M) int32, live slots (coef > 0) naming a species < S.
// route 1: "shared" (the tile's rows and the tables in shared memory;
// M <= 4), 0: "global"; tile: lanes a tile
// (`propensity.match_lanes_per_tile`).
// Returns a CUDA error code (0 on success).
extern "C" int propensity_launch(const void* x, const void* idx,
                                 const void* coef, const void* rates,
                                 int rates_per_lane, int B, int S, int R,
                                 int M, int route, int tile, void* out,
                                 void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (S < 1 || M < 1 || tile < 1 || route < 0 || route > 1 ||
      (long)tile * S >= (1L << 30) || (long)tile * R >= (1L << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  const MatchParams p{(const float*)x, (const int*)idx, (const int*)coef,
                      (const float*)rates, (float*)out, rates_per_lane,
                      B, S, R, M, tile, (int)((B + (long)tile - 1) / tile)};
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) return launch<false>(p, 0, st);
  const size_t smem =
      sizeof(float) * ((size_t)table_words(R) + rates_floats(R) +
                       2 * (size_t)buffer_floats(tile, S));
  if (M > 4 || smem > 232448) return (int)cudaErrorInvalidValue;
  return launch<true>(p, smem, st);
}
