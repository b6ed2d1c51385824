// Fused sparse adaptive tau-leap window for Hopper (sm_90a), one warp per
// lane.
//
// Replaces the Pallas TPU kernel
// `repro/kernels/ssa_step.py::_sparse_tau_window_kernel` (driven there by
// `repro/kernels/ops.py::sparse_tau_window_chunk_loop`): the dense tau
// kernel's step (tau_step.cuh) for networks it cannot hold — hundreds of
// species and reactions, or a reactant coefficient above 4 (the comb unroll
// goes to the system's own `max_c`). The reference keeps dense (R, S) delta
// products for mu, sig2 and dx; this kernel walks the nonzeros of each
// species' column of delta in ascending reaction order for mu and sig2,
// which gives the same bits (a skipped zero adds +0), and the rows of delta
// for dx (a sum of integers, exact in any order) and the exact sub-step.
//
// Work. A large network's iteration is wide: on ring80 (S = 320, R = 560)
// 560 Match rows, 320 species' Cao sums, 280 counter blocks and 560
// Poisson inversions. The 32 threads of a warp share them: Match rows,
// Cao species, counter blocks and species of the leap check are dealt
// round the warp (rank, rank + 32, ...); tau_c and max a_j are warp
// minima and maxima, "some x_i + dx_i < 0" one vote, dx an atomic sum in
// shared memory. What must stay in order is done by every thread alike
// (the same instructions a single thread would issue, with broadcast
// reads): a0 as the left-to-right fold with a checkpoint every 32 rows,
// and the exact sub-step's scan, which counts the checkpoints below u2 a0
// and refolds one block (sparse_step.cuh, as the sparse exact kernel).
//
// Layout. Each lane's arrays sit in shared memory, one region a warp
// (`ssa_step.sparse_tau_lane_floats`): the checkpoints, the propensities
// padded with zeros to whole blocks of 32, the populations and the leap's
// increments dx. At ring80 that is 4.9 KB a lane: 16 lanes (warps) a
// block, two blocks an SM; ring256 (S = 1,024, R = 1,792) takes 15.4 KB,
// 14 lanes a block, one block an SM. The wrapper picks the lanes a block
// from (S, R) (`ssa_step.sparse_tau_lanes_per_block`) and raises where one
// lane's arrays do not fit a block (S and R in the thousands; no model of
// the repository comes near). The tables are read from global memory
// through L1 (43.5 KB for ring80); a packed, entry-major copy of them
// (one load for a reaction's slots, coalesced column walks) was slower on
// ring80 in a timing of variants not kept. The launch bound of two blocks
// an SM caps registers at 64 (some spill); in the same timing 32 warps an
// SM ran ring80's window faster than 16 warps at 105 registers.
//
// Persistent lanes: the grid is one wave; a warp whose lane stops writes it
// out and takes the next lane from an atomic ticket, so lanes do not wait
// for each other. Per-lane bits are unchanged: lanes are independent.
//
// Bound: operations. A lane reads and writes its pool row once a window;
// an iteration does thousands of float and integer operations (`tau_ops`
// in chip_smoke.py), and the folds are chains of dependent adds. The
// threads of a warp issue the fold's 560 adds together, and an iteration's
// phases (Match, fold, Cao bound, draws) each end in a warp reduction or
// vote, so a warp's iteration is a chain of latencies that two blocks of 16
// warps an SM only partly hide.
//
// Build: kernels/build.py (sm_90a, one library with the other kernels).
// C interface, bound by ctypes.

#include "sparse_step.cuh"
#include "tau_step.cuh"

namespace {

constexpr unsigned kAll = 0xFFFFFFFFu;
// most lanes (warps) a block, for the launch bound; the wrapper's
// `ssa_step.TAU_LANES_PER_BLOCK` caps the lanes it passes (a larger block
// fails the occupancy query and the launch returns its error)
constexpr int kMaxLanes = 16;


// a lane's arrays in its warp's region of shared memory
struct WarpStore {
  float* xs;
  float* as;
  float* ds;
  __device__ __forceinline__ float& x(int i) { return xs[i]; }
  __device__ __forceinline__ float& a(int j) { return as[j]; }
  __device__ __forceinline__ float& dx(int i) { return ds[i]; }
  __device__ __forceinline__ void add_dx(int i, float v) {
    atomicAdd(ds + i, v);  // integers below 2^24: exact in any order
  }
};

struct Params {
  const float* x;
  const float* t;
  const int* dead;
  const int* no_leap;
  const uint32_t* key;
  const uint32_t* ctr;
  const uint32_t* ctr_hi;
  const int4* idx;    // (R, 4) reactant species
  const int4* coef;   // (R, 4) reactant coefficients
  tau::Tables tb;     // the column, row and g_i tables
  const float* rates;  // (R,) shared or (B, R) per lane
  int rates_per_lane;
  float horizon;
  int n_steps;
  float eps, fallback;
  int B, max_c;
  int rows;     // floats of a lane's region
  int n_slots;  // lanes the grid takes first (one per warp)
  int* ticket;  // persistent lanes: the next lane is n_slots + ticket
  float* x_out;
  float* t_out;
  int* dead_out;
  int* steps_out;
  int* leaps_out;
  uint32_t* ctr_out;
  uint32_t* ctr_hi_out;
  int* iters_out;
};

__host__ __device__ __forceinline__ int ceil4(int n) { return (n + 3) & ~3; }

// floats of a lane's region: checkpoints, padded propensities, x, dx
__host__ __device__ __forceinline__ int lane_floats(int S, int R) {
  return sparse::ck_rows(R) + sparse::carry_rows(R) + 2 * ceil4(S);
}

// one reactant slot's factor into v; an empty slot contributes exactly 1
__device__ __forceinline__ float slot(float v, const float* xs, int s, int c,
                                      int max_c) {
  return c > 0 ? __fmul_rn(v, ssa::comb_factor(xs[s], c, max_c)) : v;
}

// MAXC > 0: the comb unroll's bound as a constant, at least the system's
// max_c (iterations past a slot's c are exact no-ops); 0: p.max_c
template <int MAXC>
__global__ void __launch_bounds__(32 * kMaxLanes, 2)
    sparse_tau_window_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const tau::Warp tm{(int)(threadIdx.x & 31)};
  const int me = tm.me;
  const tau::Tables tb = p.tb;
  const int S = tb.S, R = tb.R;
  const int nblk = sparse::n_checkpoints(R);
  const int max_c = MAXC > 0 ? MAXC : p.max_c;
  const uint32_t n_pairs = (uint32_t)((R + 1) / 2);
  float* ck = reinterpret_cast<float*>(smem4) +
              (size_t)(threadIdx.x >> 5) * p.rows;
  float* a = ck + sparse::ck_rows(R);
  WarpStore st{a + sparse::carry_rows(R), a,
               a + sparse::carry_rows(R) + ceil4(S)};
  int lane = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (lane >= p.n_slots) return;  // the whole warp
  // the fold's zero padding and first checkpoint, never written again
  for (int r = R + me; r < sparse::carry_rows(R); r += 32) a[r] = 0.0f;
  ck[0] = 0.0f;

  for (;;) {
    tm.sync();  // the previous lane's last reads are done
    for (int s = me; s < S; s += 32) st.x(s) = p.x[(size_t)lane * S + s];
    const float* rate =
        p.rates_per_lane ? p.rates + (size_t)lane * R : p.rates;
    const float fb = p.no_leap[lane] > 0 ? INFINITY : p.fallback;
    tau::Lane ln{p.t[lane],   p.dead[lane] > 0, p.ctr[lane],
                 p.ctr_hi[lane], 0,           0};
    const uint32_t k0 = p.key[2 * (size_t)lane];
    const uint32_t k1 = p.key[2 * (size_t)lane + 1];

    int it = 0;  // a lane that is not live stays so: later iterations no-op
    for (; it < p.n_steps && ln.t < p.horizon && !ln.dead; ++it) {
      tm.sync();  // x written, the last iteration's reads of a done
      float mx = 0.0f;
      bool neg = false;
      for (int j = me; j < R; j += 32) {
        const int4 id = __ldg(p.idx + j);
        const int4 cf = __ldg(p.coef + j);
        float v = __ldg(rate + j);
        v = slot(v, st.xs, id.x, cf.x, max_c);
        v = slot(v, st.xs, id.y, cf.y, max_c);
        v = slot(v, st.xs, id.z, cf.z, max_c);
        v = slot(v, st.xs, id.w, cf.w, max_c);
        a[j] = v;
        mx = fmaxf(mx, v);
        neg |= !(v >= 0.0f);
      }
      const float a_max = tm.max(mx);
      const bool bad = tm.any(neg);  // the scan's monotone premise fails
      tm.sync();
      const float a0 = sparse::fold_from<false>(ck, a, 0, nblk);
      tm.sync();
      const bool now_dead = a0 <= 0.0f;
      // the gate and a0 are the same on every thread: warp-uniform
      const tau::Gate g = tau::leap_gate(a0, a_max, p.horizon, ln.t, fb);
      float tau_l = 0.0f;
      bool do_leap = false;
      if (!now_dead && g.pass) {
        tau_l = tau::leap_tau(tm, st, tb, p.eps, g);
        do_leap = __fmul_rn(tau_l, a0) >= fb;
      }
      bool ok1 = false;
      const bool leaped = do_leap && tau::leap(tm, st, tb, k0, k1, p.horizon,
                                               tau_l, ln, ok1);
      if (!leaped) {
        float u2, t_next;
        tau::exact_draws(k0, k1, ln, do_leap ? 2u * n_pairs : 0u, a0, u2,
                         t_next);
        if (!now_dead && t_next <= p.horizon) {
          const float thresh = __fmul_rn(u2, a0);
          const int j = bad ? sparse::scan_linear(a, R, thresh)
                            : sparse::scan_monotone(ck, a, nblk, thresh);
          for (int q = me; q < tb.D; q += 32) {  // distinct species
            const int s = tb.row_idx[j * tb.D + q];
            if (s < S) st.x(s) = __fadd_rn(st.x(s), tb.row_val[j * tb.D + q]);
          }
          ln.t = t_next;
          ++ln.steps;
        } else {
          // dead, or the next event would cross: freeze at the horizon
          ln.t = p.horizon;
          ln.dead = now_dead;
        }
      }
      tau::account(ln, R, do_leap, ok1, leaped);
    }

    tm.sync();
    for (int s = me; s < S; s += 32) p.x_out[(size_t)lane * S + s] = st.x(s);
    if (me == 0) {
      p.t_out[lane] = ln.t;
      p.dead_out[lane] = ln.dead ? 1 : 0;
      p.steps_out[lane] = ln.steps;
      p.leaps_out[lane] = ln.leaps;
      p.ctr_out[lane] = ln.c_lo;
      p.ctr_hi_out[lane] = ln.c_hi;
      p.iters_out[lane] = it;
    }
    int next = 0;
    if (me == 0) next = atomicAdd(p.ticket, 1);
    lane = p.n_slots + __shfl_sync(kAll, next, 0);
    if (lane >= p.B) break;
  }
}

// One wave of blocks (or fewer, when the lanes run out first) of `lanes`
// warps, each warp with one region of p0.rows floats.
template <int MAXC>
int launch(const Params& p0, int lanes, int* grid_lanes,
           cudaStream_t stream) {
  auto kernel = sparse_tau_window_kernel<MAXC>;
  const int threads = 32 * lanes;
  const size_t smem = (size_t)p0.rows * lanes * sizeof(float);
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
  const long need = (p0.B + lanes - 1) / lanes;
  const int blocks = (int)(need < wave ? need : wave);
  Params p = p0;
  const long taken = (long)blocks * lanes;
  p.n_slots = (int)(taken < p0.B ? taken : p0.B);
  *grid_lanes = p.n_slots;
  kernel<<<blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace


// idx / coef (R, 4) int32; col_j / col_v (S, L); row_idx / row_val (R+1,
// D); rates (R,) or (B, R); gi (G, S); rmask (S,). `lanes` warps (lanes) a
// block, each with a region of `rows` floats (at least lane_floats(S, R),
// a multiple of 4). ticket: one int32, zero. grid_lanes (host): set to the
// lanes the grid takes first, one per warp; the others come from the
// ticket. Returns a CUDA error code (0 on success).
extern "C" int sparse_tau_window_launch(
    const void* x, const void* t, const void* dead, const void* no_leap,
    const void* key, const void* ctr, const void* ctr_hi, const void* idx,
    const void* coef, const void* col_j, const void* col_v,
    const void* row_idx, const void* row_val, const void* rates,
    const void* gi, const void* rmask, int rates_per_lane, float horizon,
    int n_steps, float eps, float fallback, int B, int S, int R, int L, int D,
    int G, int max_c, int lanes, int rows, void* ticket, int* grid_lanes,
    void* x_out, void* t_out, void* dead_out, void* steps_out,
    void* leaps_out, void* ctr_out, void* ctr_hi_out, void* iters_out,
    void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || R < 1 || L < 1 || D < 1 || G < 1 || max_c < 1 || lanes < 1 ||
      rows < lane_floats(S, R) || rows % 4 != 0 || grid_lanes == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const tau::Tables tb{(const int*)idx,     (const int*)coef,
                       (const int*)col_j,   (const float*)col_v,
                       (const int*)row_idx, (const float*)row_val,
                       (const float*)gi,    (const float*)rmask,
                       S,                   R,
                       L,                   D,
                       G};
  const Params p{(const float*)x, (const float*)t, (const int*)dead,
                 (const int*)no_leap, (const uint32_t*)key,
                 (const uint32_t*)ctr, (const uint32_t*)ctr_hi,
                 (const int4*)idx, (const int4*)coef, tb,
                 (const float*)rates, rates_per_lane, horizon, n_steps, eps,
                 fallback, B, max_c, rows, 0, (int*)ticket, (float*)x_out,
                 (float*)t_out, (int*)dead_out, (int*)steps_out,
                 (int*)leaps_out, (uint32_t*)ctr_out, (uint32_t*)ctr_hi_out,
                 (int*)iters_out};
  const cudaStream_t st = (cudaStream_t)stream;
  // the comb unroll as a constant 2 for systems whose coefficients are at
  // most 2 (every model of the repository but the pentamer): ring80's
  // window 2 at 2^18 lanes took 35.8 ms against 39.1 with the bound read
  // from p.max_c (benchmarks/tau_kernel_window.py, both trees timed in one
  // run on an H100 80GB HBM3 at 700 W)
  return max_c <= 2 ? launch<2>(p, lanes, grid_lanes, st)
                    : launch<0>(p, lanes, grid_lanes, st);
}
