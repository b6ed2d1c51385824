// Fused dense exact-SSA window for Hopper (sm_90a), one thread per lane.
//
// Replaces the Pallas TPU kernel `repro/kernels/ssa_step.py::_window_kernel`
// (driven there by `repro/kernels/ops.py::window_chunk_loop`). Each lane
// runs up to `n_steps` direct-method events toward `horizon`:
//
//   Match   once per lane and launch: every propensity, rates first, the
//           products of C(n, c) over the populations gathered by reactant
//           index (the reference's one-hot matmul gives the same bits on
//           integer-valued float32 populations). After reaction j fires,
//           only the rows of dep(j) are recomputed, from a bit mask per
//           reaction (`ssa_step.dense_dep_mask`): every other propensity is a
//           pure function of populations j did not change, so its carried
//           value has the bits a recomputation would give;
//   Resolve threefry2x32 uniforms from the lane's (key, counter) stream,
//           tau = -log(u1) / max(a0, 1e-30) with a0 the left-to-right fold
//           of the carried propensities, first r with cumsum >= u2*a0;
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
// right.
//
// Bound: instructions per step, not bytes (a lane reads and writes about
// 62 bytes of pool state per window against hundreds to thousands of
// events). Per event: threefry's 20 rounds, the log polynomial, the fold
// and the scan over R carried values, the S-wide update and the dep(j)
// rows' Match (2.8 rows of 9 on lv8), with no division where the comb
// factor is exact without one (c <= 2). The lane's populations and
// propensities sit in shared memory, (S + R) rows x 128 lanes, lanes
// minor: the reactant gather indexes them, which would put a per-thread
// array in local memory; as columns, a warp's 32 reads of any rows hit 32
// distinct banks, and the constant stride makes each row's offset an
// immediate (ptxas: 40 registers, no stack, no spills). The system tables
// (reactant index and coefficient, delta, the masks, and the rates when
// every lane shares them) sit in shared memory too.
//
// Persistent lanes: the grid is one wave. A thread whose lane stops
// writes it out and takes the next lane from an atomic ticket in the same
// loop the other threads step in, so a warp does not idle while its
// longest lane runs on (warp step-slot efficiency fell to 0.34-0.73 on lv8
// once populations crash and lanes die at different times). A new lane
// costs its seed Match, about one step. Per-lane bits are unchanged: lanes
// are independent and every output is written per lane.
//
// Build: kernels/build.py (sm_90a, one library with the other kernels).
// C interface, bound by ctypes.

#include "ssa_common.cuh"

#define SSA_MAX_S 64
#define SSA_MAX_R 64
#define SSA_MAX_COEF 4

constexpr int kLanes = 128;  // threads (lanes) a block
namespace {

using Lanes = ssa::Column<kLanes>;

struct Params {
  const float* x;
  const float* t;
  const int* dead;
  const uint32_t* key;
  const uint32_t* ctr;
  const uint32_t* ctr_hi;
  const int* idx;      // (R, 4) reactant species, S at pads
  const int* coef;     // (R, 4) reactant coefficients, 0 at pads
  const float* delta;  // (R, S)
  const float* rates;  // (R,) shared or (B, R) per lane
  const unsigned long long* dep_mask;  // (R,) bit r: r in dep(j)
  int rates_per_lane;
  float horizon;
  int n_steps, B, S, R;
  int slots;    // lanes the grid takes first (one per thread)
  int* ticket;  // persistent lanes: the next lane is slots + ticket
  float* x_out;
  float* t_out;
  int* dead_out;
  int* steps_out;
  uint32_t* ctr_out;
  uint32_t* ctr_hi_out;
};

// one reactant slot of a product; a slot with c == 0 contributes exactly
// 1 and is skipped
__device__ __forceinline__ float slot(float a, const Lanes& xs, int s,
                                      int c) {
  return c > 0 ? __fmul_rn(a, ssa::comb_factor(xs[s], c, SSA_MAX_COEF)) : a;
}

// rates-first propensity of reaction r: rate * C(n_0, c_0) * ... in slot
// order
__device__ __forceinline__ float propensity(int r, const Lanes& xs,
                                            const int4* s_idx,
                                            const int4* s_coef,
                                            const float* rate) {
  const int4 id = s_idx[r];
  const int4 cf = s_coef[r];
  float a = rate[r];
  a = slot(a, xs, id.x, cf.x);
  a = slot(a, xs, id.y, cf.y);
  a = slot(a, xs, id.z, cf.z);
  return slot(a, xs, id.w, cf.w);
}

// shared memory: idx, coef (R int4 each), masks (R u64), delta (R*S),
// shared rates (R), then the lanes' columns: x (S rows), a (R rows)
__host__ __device__ __forceinline__ size_t table_bytes(int S, int R) {
  return (size_t)R * (2 * sizeof(int4) + sizeof(unsigned long long)) +
         (size_t)R * S * sizeof(float) + (size_t)R * sizeof(float);
}

__global__ void ssa_window_kernel(Params p) {
  extern __shared__ int4 smem[];
  const int S = p.S, R = p.R;
  int4* s_idx = smem;
  int4* s_coef = s_idx + R;
  unsigned long long* s_mask =
      reinterpret_cast<unsigned long long*>(s_coef + R);
  float* s_delta = reinterpret_cast<float*>(s_mask + R);
  float* s_rates = s_delta + R * S;
  float* s_lanes = s_rates + R;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    s_idx[i] = make_int4(p.idx[4 * i], p.idx[4 * i + 1], p.idx[4 * i + 2],
                         p.idx[4 * i + 3]);
    s_coef[i] = make_int4(p.coef[4 * i], p.coef[4 * i + 1],
                          p.coef[4 * i + 2], p.coef[4 * i + 3]);
    s_mask[i] = p.dep_mask[i];
    if (!p.rates_per_lane) s_rates[i] = p.rates[i];
  }
  for (int i = threadIdx.x; i < R * S; i += blockDim.x) {
    s_delta[i] = p.delta[i];
  }
  __syncthreads();

  const Lanes xs{s_lanes + threadIdx.x};
  const Lanes a{s_lanes + S * kLanes + threadIdx.x};
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.B) return;

  const float* rate = nullptr;
  float tl = 0.0f;
  bool dl = false;
  uint32_t k0 = 0, k1 = 0, c_lo = 0, c_hi = 0;
  int steps = 0, it = 0;
  bool fresh = true;  // `lane` is to be loaded and seeded

  for (;;) {
    if (fresh) {
      fresh = false;
      for (int s = 0; s < S; ++s) xs[s] = p.x[(size_t)lane * S + s];
      rate = p.rates_per_lane ? p.rates + (size_t)lane * R : s_rates;
      for (int r = 0; r < R; ++r) {
        a[r] = propensity(r, xs, s_idx, s_coef, rate);
      }
      tl = p.t[lane];
      dl = p.dead[lane] > 0;
      k0 = p.key[2 * (size_t)lane];
      k1 = p.key[2 * (size_t)lane + 1];
      c_lo = p.ctr[lane];
      c_hi = p.ctr_hi[lane];
      steps = 0;
      it = 0;
    }
    // a lane that is not live stays so: its remaining steps are no-ops
    if (it >= p.n_steps || !(tl < p.horizon) || dl) {
      for (int s = 0; s < S; ++s) p.x_out[(size_t)lane * S + s] = xs[s];
      p.t_out[lane] = tl;
      p.dead_out[lane] = dl ? 1 : 0;
      p.steps_out[lane] = steps;
      p.ctr_out[lane] = c_lo;
      p.ctr_hi_out[lane] = c_hi;
      lane = p.slots + ssa::take_lane(p.ticket);
      if (lane >= p.B) break;
      fresh = true;
      continue;
    }
    ++it;
    float a0 = 0.0f;
    for (int r = 0; r < R; ++r) a0 = __fadd_rn(a0, a[r]);
    const bool now_dead = a0 <= 0.0f;
    uint32_t b0, b1;
    ssa::threefry2x32(k0, k1, c_lo, c_hi, b0, b1);
    const float u1 = ssa::bits_to_uniform(b0);
    const float u2 = ssa::bits_to_uniform(b1);
    const float t_next = __fadd_rn(tl, ssa::waiting_time(u1, a0));
    if (!now_dead && t_next <= p.horizon) {
      const float thresh = __fmul_rn(u2, a0);
      int j = 0;  // first true, 0 when none (the reference's argmax)
      float cum = 0.0f;
      for (int r = 0; r < R; ++r) {
        cum = __fadd_rn(cum, a[r]);
        if (cum >= thresh) {
          j = r;
          break;
        }
      }
      const float* d = s_delta + j * S;
      for (int s = 0; s < S; ++s) xs[s] = __fadd_rn(xs[s], d[s]);
      for (unsigned long long m = s_mask[j]; m != 0ull; m &= m - 1ull) {
        const int r = __ffsll((long long)m) - 1;
        a[r] = propensity(r, xs, s_idx, s_coef, rate);
      }
      tl = t_next;
      ++steps;
    } else {
      // dead, or the next event would cross: freeze at the horizon
      tl = p.horizon;
      dl = now_dead;
    }
    c_lo += 1u;
    c_hi += (c_lo == 0u) ? 1u : 0u;
  }
}

}  // namespace

// idx / coef (R, 4) int32; delta (R, S) float32; rates (R,) or (B, R);
// dep_mask (R,) int64; ticket: one int32, zero. Returns a CUDA error code
// (0 on success).
extern "C" int ssa_window_launch(
    const void* x, const void* t, const void* dead, const void* key,
    const void* ctr, const void* ctr_hi, const void* idx, const void* coef,
    const void* delta, const void* rates, const void* dep_mask,
    int rates_per_lane, float horizon, int n_steps, int B, int S, int R,
    void* ticket, void* x_out, void* t_out, void* dead_out, void* steps_out,
    void* ctr_out, void* ctr_hi_out, void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || S > SSA_MAX_S || R < 1 || R > SSA_MAX_R) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = kLanes;
  const size_t smem =
      table_bytes(S, R) + (size_t)(S + R) * threads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssa_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ssa_window_kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long wave = (long)n_sm * per_sm;
  const long need = (B + threads - 1) / threads;
  const int blocks = (int)(need < wave ? need : wave);
  Params p{(const float*)x, (const float*)t, (const int*)dead,
           (const uint32_t*)key, (const uint32_t*)ctr,
           (const uint32_t*)ctr_hi, (const int*)idx, (const int*)coef,
           (const float*)delta, (const float*)rates,
           (const unsigned long long*)dep_mask, rates_per_lane, horizon,
           n_steps, B, S, R, blocks * threads, (int*)ticket,
           (float*)x_out, (float*)t_out, (int*)dead_out, (int*)steps_out,
           (uint32_t*)ctr_out, (uint32_t*)ctr_hi_out};
  ssa_window_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
