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
// reactant coefficients <= 4: every table (reactant index and coefficient,
// delta by columns and by rows, the g_i table, the reactant mask, the
// dependency masks, and the rates when every lane shares them) sits in
// shared memory, and so do the lanes' populations, leap increments and
// propensities: (2S + R) rows x 128 lanes, lanes minor (ssa::Column), as
// ssa_window.cu keeps its carry: a per-thread array that the Match's
// gather indexes would sit on the stack. ptxas: no stack, 48 registers at
// the bound of 10 blocks an SM.
//
// Work. After an exact sub-step fires j, only the rows of dep(j) are
// recomputed, from a bit mask per reaction (`ssa_step.dense_dep_mask`):
// propensities are a pure function of the populations, and j changed no
// other row's; a0 is refolded left to right over the carried values. An
// iteration that cannot leap (windows where populations have crashed:
// 1-9% of lv8's iterations leap there) skips the Cao bound: tau <=
// min(horizon - t, LAM_MAX / max a_j), so that times a0 below the fallback
// decides it (tau_step.cuh). Both skips are taken by the converged threads
// of a warp together (one vote each): a thread that runs the whole Match
// or the Cao bound without needing it gets the same bits, and a warp runs
// the union of its threads' paths anyway.
//
// Persistent lanes: the grid is one wave and further lanes come from an
// atomic ticket. While a warp's lanes run alike (leaping windows: the
// longest of its 32 lanes took at most 5/4 of their mean iterations), its
// threads run their lanes to the end and take 32 new ones together; once
// they did not, the warp refills each thread the moment its lane ends, in
// the loop its other threads iterate in. On lv8 x 2^20, timed with
// variants not kept: refilling per thread from the start was slower where
// lanes run alike (a desynchronised warp diverges more), and much faster
// where they do not (step-slot efficiency 0.48-0.73 in windows 5-8, PERF.md
// section 5). Per-lane bits are unchanged: lanes are independent.
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

constexpr int kLanes = 128;  // threads (lanes) a block

namespace {

using Lanes = ssa::Column<kLanes>;

// the lane's columns in shared memory, one thread's: x (S rows), dx (S
// rows), a (R rows)
struct ColumnStore {
  Lanes xs;  // row 0 of the thread's columns
  int S;
  __device__ __forceinline__ float& x(int i) { return xs[i]; }
  __device__ __forceinline__ float& dx(int i) { return xs[S + i]; }
  __device__ __forceinline__ float& a(int j) { return xs[2 * S + j]; }
  __device__ __forceinline__ void add_dx(int i, float v) {
    float& d = dx(i);
    d = __fadd_rn(d, v);
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
  const int* idx;
  const int* coef;
  const int* col_j;
  const float* col_v;
  const int* row_idx;
  const float* row_val;
  const float* rates;                  // (R,) shared or (B, R) per lane
  const float* gi;
  const float* rmask;
  const unsigned long long* dep_mask;  // (R,) bit r: r in dep(j)
  int rates_per_lane;
  float horizon;
  int n_steps;
  float eps, fallback;
  int B, S, R, L, D, G;
  int slots;    // lanes the grid takes first (one per thread)
  int* ticket;  // persistent lanes: the next lane is slots + ticket
  float* x_out;
  float* t_out;
  int* dead_out;
  int* steps_out;
  int* leaps_out;
  uint32_t* ctr_out;
  uint32_t* ctr_hi_out;
  int* iters_out;
};

// rates-first propensity of reaction r: rate * C(n_0, c_0) * ... in slot
// order; a slot with c == 0 contributes exactly 1 and is skipped
__device__ __forceinline__ float propensity(int r, const Lanes& xs,
                                            const int4* s_idx,
                                            const int4* s_coef,
                                            const float* rate) {
  const int4 id = s_idx[r];
  const int4 cf = s_coef[r];
  const int sp[4] = {id.x, id.y, id.z, id.w};
  const int c[4] = {cf.x, cf.y, cf.z, cf.w};
  float a = rate[r];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (c[m] > 0) {
      a = __fmul_rn(a, ssa::comb_factor(xs[sp[m]], c[m], TAU_MAX_COEF));
    }
  }
  return a;
}

template <class T>
__device__ __forceinline__ T* stage(const T* src, int n, char*& cursor) {
  T* dst = reinterpret_cast<T*>(cursor);
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  cursor += (size_t)n * sizeof(T);
  return dst;
}

// shared memory: idx, coef (R int4 each), masks (R u64), then the 4-byte
// tables (col_j, col_v, row_idx, row_val, gi, rmask, shared rates), then
// the lanes' columns: x, dx (S rows each) and a (R rows)
__host__ __device__ __forceinline__ size_t table_bytes(int S, int R, int L,
                                                       int D, int G) {
  return (size_t)R * (2 * sizeof(int4) + sizeof(unsigned long long)) +
         4 * ((size_t)2 * S * L + 2 * (size_t)(R + 1) * D + (size_t)G * S +
              S + R);
}


// One iteration of a live lane. `match`: every propensity is to be
// recomputed (after a leap, or at the lane's start); `fired`: the reaction
// the last exact sub-step fired, whose dep(j) rows are to be recomputed
// otherwise (-1: none). The whole Match runs where any of the converged
// threads needs it: a carried row is a pure function of x, so recomputing
// it gives its bits. The Cao bound runs where the gate lets some converged
// thread's leap through: a thread the gate stops cannot leap, whatever
// tau_c is.
__device__ __forceinline__ void iteration(
    const Params& p, ColumnStore& st, const tau::Tables& tb,
    const int4* s_idx, const int4* s_coef,
    const unsigned long long* s_mask, const float* rate, float fb,
    uint32_t k0, uint32_t k1, tau::Lane& ln, bool& match, int& fired) {
  const int R = tb.R, S = tb.S;
  const tau::Solo solo{};
  const uint32_t n_pairs = (uint32_t)((R + 1) / 2);
  float a0 = 0.0f, a_max = 0.0f;
  if (__any_sync(__activemask(), match)) {
    for (int r = 0; r < R; ++r) {
      const float v = propensity(r, st.xs, s_idx, s_coef, rate);
      st.a(r) = v;
      a0 = __fadd_rn(a0, v);
      a_max = fmaxf(a_max, v);
    }
  } else {
    if (fired >= 0) {
      for (unsigned long long m = s_mask[fired]; m != 0ull; m &= m - 1ull) {
        const int r = __ffsll((long long)m) - 1;
        st.a(r) = propensity(r, st.xs, s_idx, s_coef, rate);
      }
    }
    for (int r = 0; r < R; ++r) {
      const float v = st.a(r);
      a0 = __fadd_rn(a0, v);
      a_max = fmaxf(a_max, v);
    }
  }
  const bool now_dead = a0 <= 0.0f;
  float tau_l = 0.0f;
  const tau::Gate g = tau::leap_gate(a0, a_max, p.horizon, ln.t, fb);
  const bool pass = !now_dead && g.pass;
  bool do_leap = false;
  if (__any_sync(__activemask(), pass)) {
    tau_l = tau::leap_tau(solo, st, tb, p.eps, g);
    do_leap = pass && __fmul_rn(tau_l, a0) >= fb;
  }
  bool ok1 = false;
  const bool leaped = do_leap && tau::leap(solo, st, tb, k0, k1, p.horizon,
                                           tau_l, ln, ok1);
  match = leaped;
  fired = -1;
  if (!leaped) {
    float u2, t_next;
    tau::exact_draws(k0, k1, ln, do_leap ? 2u * n_pairs : 0u, a0, u2,
                     t_next);
    if (!now_dead && t_next <= p.horizon) {
      const float thresh = __fmul_rn(u2, a0);
      int j = 0;  // first true, 0 when none (never: cum reaches a0)
      float cum = 0.0f;
      for (int r = 0; r < R; ++r) {
        cum = __fadd_rn(cum, st.a(r));
        if (cum >= thresh) {
          j = r;
          break;
        }
      }
      for (int q = 0; q < tb.D; ++q) {  // pads index S: dropped
        const int s = tb.row_idx[j * tb.D + q];
        if (s < S) st.x(s) = __fadd_rn(st.x(s), tb.row_val[j * tb.D + q]);
      }
      fired = j;
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

__global__ void __launch_bounds__(kLanes, 10)
    tau_window_kernel(Params p) {
  extern __shared__ int4 smem[];
  const int S = p.S, R = p.R;
  int4* s_idx = smem;
  int4* s_coef = s_idx + R;
  unsigned long long* s_mask =
      reinterpret_cast<unsigned long long*>(s_coef + R);
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    s_idx[i] = make_int4(p.idx[4 * i], p.idx[4 * i + 1], p.idx[4 * i + 2],
                         p.idx[4 * i + 3]);
    s_coef[i] = make_int4(p.coef[4 * i], p.coef[4 * i + 1],
                          p.coef[4 * i + 2], p.coef[4 * i + 3]);
    s_mask[i] = p.dep_mask[i];
  }
  char* cursor = reinterpret_cast<char*>(s_mask + R);
  tau::Tables tb;
  tb.idx = p.idx;
  tb.coef = p.coef;
  tb.col_j = stage(p.col_j, S * p.L, cursor);
  tb.col_v = stage(p.col_v, S * p.L, cursor);
  tb.row_idx = stage(p.row_idx, (R + 1) * p.D, cursor);
  tb.row_val = stage(p.row_val, (R + 1) * p.D, cursor);
  tb.gi = stage(p.gi, p.G * S, cursor);
  tb.rmask = stage(p.rmask, S, cursor);
  float* s_rates = reinterpret_cast<float*>(cursor);
  if (!p.rates_per_lane) {
    for (int i = threadIdx.x; i < R; i += blockDim.x) s_rates[i] = p.rates[i];
  }
  cursor += (size_t)R * sizeof(float);
  tb.S = S;
  tb.R = R;
  tb.L = p.L;
  tb.D = p.D;
  tb.G = p.G;
  __syncthreads();

  float* s_lanes = reinterpret_cast<float*>(cursor) + threadIdx.x;
  ColumnStore st{Lanes{s_lanes}, S};
  const float* rate = nullptr;
  float fb = 0.0f;
  tau::Lane ln{};
  uint32_t k0 = 0, k1 = 0;
  int it = 0;
  bool match = true;
  int fired = -1;
  // lane's inputs, and the state of its first iteration
  auto start = [&](int lane) {
    for (int s = 0; s < S; ++s) st.x(s) = p.x[(size_t)lane * S + s];
    rate = p.rates_per_lane ? p.rates + (size_t)lane * R : s_rates;
    fb = p.no_leap[lane] > 0 ? INFINITY : p.fallback;
    ln.t = p.t[lane];
    ln.dead = p.dead[lane] > 0;
    ln.c_lo = p.ctr[lane];
    ln.c_hi = p.ctr_hi[lane];
    ln.steps = 0;
    ln.leaps = 0;
    k0 = p.key[2 * (size_t)lane];
    k1 = p.key[2 * (size_t)lane + 1];
    it = 0;
    match = true;
    fired = -1;
  };
  auto live = [&]() {
    return it < p.n_steps && ln.t < p.horizon && !ln.dead;
  };
  auto finish = [&](int lane) {
    for (int s = 0; s < S; ++s) p.x_out[(size_t)lane * S + s] = st.x(s);
    p.t_out[lane] = ln.t;
    p.dead_out[lane] = ln.dead ? 1 : 0;
    p.steps_out[lane] = ln.steps;
    p.leaps_out[lane] = ln.leaps;
    p.ctr_out[lane] = ln.c_lo;
    p.ctr_hi_out[lane] = ln.c_hi;
    p.iters_out[lane] = it;
  };

  // Lockstep: the warp's 32 threads each run a lane to its end, then take
  // 32 new lanes together (one atomic), as long as the warp's lanes ran
  // alike (leaping windows: the longest lane took at most 5/4 of the mean
  // iterations). Where they did not, the warp switches to refilling each
  // thread the moment its lane ends, in the loop the other threads iterate
  // in (the lockstep it saves outweighs a desynchronised warp's cost).
  constexpr unsigned kAll = 0xFFFFFFFFu;
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  for (;;) {
    const bool have = lane < p.B;
    if (have) {
      start(lane);
      for (; live(); ++it) {
        iteration(p, st, tb, s_idx, s_coef, s_mask, rate, fb, k0, k1, ln,
                  match, fired);
      }
      finish(lane);
    }
    const unsigned holders = __ballot_sync(kAll, have);
    if (holders == 0u) return;
    const int its = have ? it : 0;
    const int sum = __reduce_add_sync(kAll, its);
    const int longest = __reduce_max_sync(kAll, its);
    lane = p.slots + ssa::take_lane(p.ticket);
    if (4 * __popc(holders) * longest > 5 * sum) break;
  }

  // per-thread refill
  if (lane >= p.B) return;
  start(lane);
  for (;;) {
    // a lane that is not live stays so: its remaining iterations no-op
    if (!live()) {
      finish(lane);
      lane = p.slots + ssa::take_lane(p.ticket);
      if (lane >= p.B) return;
      start(lane);
      continue;
    }
    ++it;
    iteration(p, st, tb, s_idx, s_coef, s_mask, rate, fb, k0, k1, ln, match,
              fired);
  }
}

}  // namespace

// idx / coef (R, 4) int32; col_j / col_v (S, L); row_idx / row_val (R+1,
// D); rates (R,) or (B, R); gi (G, S); rmask (S,); dep_mask (R,) int64;
// ticket: one int32, zero. grid_lanes (host): set to the lanes the grid
// takes first, one per thread; the others come from the ticket. Returns a
// CUDA error code (0 on success).
extern "C" int tau_window_launch(
    const void* x, const void* t, const void* dead, const void* no_leap,
    const void* key, const void* ctr, const void* ctr_hi, const void* idx,
    const void* coef, const void* col_j, const void* col_v,
    const void* row_idx, const void* row_val, const void* rates,
    const void* gi, const void* rmask, const void* dep_mask,
    int rates_per_lane, float horizon, int n_steps, float eps,
    float fallback, int B, int S, int R, int L, int D, int G, int max_c,
    void* ticket, int* grid_lanes, void* x_out, void* t_out, void* dead_out,
    void* steps_out, void* leaps_out, void* ctr_out, void* ctr_hi_out,
    void* iters_out, void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || S > TAU_MAX_S || R < 1 || R > TAU_MAX_R || L < 1 || D < 1 ||
      G < 1 || max_c != TAU_MAX_COEF || grid_lanes == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = kLanes;
  const size_t smem = table_bytes(S, R, L, D, G) +
                      (size_t)(2 * S + R) * threads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tau_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tau_window_kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long wave = (long)n_sm * per_sm;
  const long need = (B + threads - 1) / threads;
  const int blocks = (int)(need < wave ? need : wave);
  *grid_lanes = blocks * threads < B ? blocks * threads : B;
  Params p{(const float*)x, (const float*)t, (const int*)dead,
           (const int*)no_leap, (const uint32_t*)key, (const uint32_t*)ctr,
           (const uint32_t*)ctr_hi, (const int*)idx, (const int*)coef,
           (const int*)col_j, (const float*)col_v, (const int*)row_idx,
           (const float*)row_val, (const float*)rates, (const float*)gi,
           (const float*)rmask, (const unsigned long long*)dep_mask,
           rates_per_lane, horizon, n_steps, eps, fallback, B, S, R, L, D,
           G, blocks * threads, (int*)ticket, (float*)x_out, (float*)t_out,
           (int*)dead_out, (int*)steps_out, (int*)leaps_out,
           (uint32_t*)ctr_out, (uint32_t*)ctr_hi_out, (int*)iters_out};
  tau_window_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
