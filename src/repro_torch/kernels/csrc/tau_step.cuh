// The pieces of one adaptive tau-leap iteration, shared by the dense
// (tau_window.cu, a thread per lane) and sparse (sparse_tau_window.cu, a
// warp per lane) tau kernels; the same step as
// repro_torch/core/tau_leap.py::tau_step_core, which the plain twins loop.
// Each piece is written once over a `Team` (the threads that run one lane:
// `Solo` or `Warp`) and a `Store` (where the lane's populations x(i),
// propensities a(j) and leap increments dx(i) live):
//
//   Match    a_j rates first, slots in order (the kernels' own loops);
//            a0 left to right (one fold, every thread of the team alike);
//   gate     tau <= m = min(horizon - t, LAM_MAX / max(max_j a_j, 1e-30)),
//            so m a0 < fallback means no leap: the Cao bound is skipped
//            (`leap_gate`, then `leap_tau`);
//   Cao tau  per consumed species i, mu_i and sig2_i left to right over the
//            nonzeros of column i of delta, the g_i bound, bnd = max(eps x_i
//            / g_i, 1), tau_c = min_i min(bnd / |mu_i|, bnd^2 / sig2_i);
//            tau = min(tau_c, horizon - t, LAM_MAX / max_j a_j);
//   leap     if tau a0 >= fallback: K_j ~ Poisson(a_j tau) from the
//            ceil(R/2) counter blocks at ctr; if some x_i + dx_i < 0, retry
//            once at tau/2 with the blocks at ctr + ceil(R/2);
//   exact    otherwise (or after two rejections) one direct-method step on
//            the block at ctr (at ctr + 2 ceil(R/2) after two rejections)
//            (the kernels' own scans and updates).
//
// The counter then advances by what the reference's stream accounting
// consumes. Bits: explicit `_rn` intrinsics, the port's exp_f32 and log_f32.
//
// Orders that do not change a bit, and why:
//   - dx_i is a sum of integers K_j delta_ji below 2^24 (K_j <= 64, and
//     populations and stoichiometries are integers far below 2^24), exact
//     in any order, so the lanes' threads add reaction rows' terms into dx
//     in whatever order they finish (the twin walks columns). Its zero is
//     +0 either way (a sum from +0 is -0 only if every term and the start
//     are -0), so x + dx is the twin's one rounded add.
//   - min and max select one of their operands: over values that are not
//     NaN the result does not depend on the order. tau_c's terms r1, r2 are
//     > 0 or +inf, never NaN: |mu| > 0 and sig2 > 0 exclude a NaN
//     denominator, and bnd, bnd^2 are finite for finite populations below
//     2^24 (g_i >= 1). max_j a_j is read only through max(., 1e-30), which
//     maps -0, +0 and any negative value alike. A NaN a_j (a NaN rate) makes
//     a0 NaN, and then neither the twin nor the kernels leap: tau a0 >=
//     fallback and m a0 >= fallback are both false.
//   - the gate: tau_l <= m and a0 > 0 make __fmul_rn(tau_l, a0) <=
//     __fmul_rn(m, a0) (rounding is monotone), so a lane the gate stops
//     would not leap in the twin either; it goes to the exact sub-step at
//     counter offset 0, as the twin's does.
//   - work skipped where its result is known: a species whose |mu| and
//     sig2 are both not > 0 has two +inf terms (no g_i, no bnd); a
//     reaction with lam = +-0 draws K = 0 (exp_f32(-0) = 1 > u).
// A species column's pads sit at its end (reaction index R), so the column
// walks stop there; a delta row's pads carry species S and are skipped.
#pragma once

#include "ssa_common.cuh"

namespace tau {

constexpr float kLamMax = 16.0f;          // core/tau_leap.py LAM_MAX
constexpr float kFloor = 0x1.4484cp-100f;  // float32(1e-30)

// The system's tables (core/tau_leap.py::TauTables) wherever they live.
struct Tables {
  const int* idx;       // (R, 4) reactant species, S at pads
  const int* coef;      // (R, 4) reactant coefficients, 0 at pads
  const int* col_j;     // (S, L) nonzero reactions of column i, R at pads
  const float* col_v;   // (S, L) their delta values
  const int* row_idx;   // (R+1, D) species reaction j changes, S at pads
  const float* row_val; // (R+1, D) by how much
  const float* gi;      // (G, S) Cao g_i coefficients
  const float* rmask;   // (S,) 1 where some reaction consumes i
  int S, R, L, D, G;
};

// The lane's clock, flags, counter and tallies (every thread of the team
// holds the same values).
struct Lane {
  float t;
  bool dead;
  uint32_t c_lo, c_hi;
  int steps, leaps;
};

// One thread runs the lane: every team operation is the identity.
struct Solo {
  static constexpr int kSize = 1;
  __device__ __forceinline__ int rank() const { return 0; }
  __device__ __forceinline__ void sync() const {}
  __device__ __forceinline__ bool any(bool b) const { return b; }
  __device__ __forceinline__ float min(float v) const { return v; }
  __device__ __forceinline__ float max(float v) const { return v; }
};

// The 32 threads of a warp run the lane, converged at every call below.
// min and max reduce by a butterfly: a selection, so every thread ends
// with the same value whatever the order (no operand is NaN, see above).
struct Warp {
  static constexpr int kSize = 32;
  static constexpr unsigned kAll = 0xFFFFFFFFu;
  int me;  // the thread's index in its warp
  __device__ __forceinline__ int rank() const { return me; }
  __device__ __forceinline__ void sync() const { __syncwarp(kAll); }
  __device__ __forceinline__ bool any(bool b) const {
    return __any_sync(kAll, b) != 0;
  }
  __device__ __forceinline__ float min(float v) const {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kAll, v, o));
    return v;
  }
  __device__ __forceinline__ float max(float v) const {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
    return v;
  }
};

// Cao's tau_c: the team's share of the consumed species (i = rank,
// rank + size, ...), each exactly as the twin computes it, then the team's
// minimum.
template <class Team, class Store>
__device__ __forceinline__ float cao_tau(const Team& tm, Store& st,
                                         const Tables& tb, float eps) {
  const int S = tb.S, R = tb.R, L = tb.L;
  float tau_c = INFINITY;
  for (int i = tm.rank(); i < S; i += Team::kSize) {
    if (!(tb.rmask[i] > 0.0f)) continue;  // only consumed species
    float mu = 0.0f, sig2 = 0.0f;
    for (int l = 0; l < L; ++l) {
      const int j = tb.col_j[i * L + l];
      if (j >= R) break;
      const float v = tb.col_v[i * L + l];
      const float aj = st.a(j);
      mu = __fadd_rn(mu, __fmul_rn(aj, v));
      sig2 = __fadd_rn(sig2, __fmul_rn(aj, __fmul_rn(v, v)));
    }
    const float amu = fabsf(mu);
    if (!(amu > 0.0f) && !(sig2 > 0.0f)) continue;  // both terms are +inf
    const float xi = st.x(i);
    float g = tb.gi[i];
    for (int k = 1; k < tb.G; ++k) {  // a zero row adds exactly +0
      const float c = tb.gi[k * S + i];
      if (c != 0.0f) {
        g = __fadd_rn(g, __fdiv_rn(c, fmaxf(__fsub_rn(xi, (float)k), 1.0f)));
      }
    }
    const float bnd = fmaxf(__fdiv_rn(__fmul_rn(eps, xi), g), 1.0f);
    const float r1 =
        amu > 0.0f ? __fdiv_rn(bnd, fmaxf(amu, kFloor)) : INFINITY;
    const float r2 = sig2 > 0.0f
                         ? __fdiv_rn(__fmul_rn(bnd, bnd), fmaxf(sig2, kFloor))
                         : INFINITY;
    tau_c = fminf(tau_c, fminf(r1, r2));
  }
  return tm.min(tau_c);
}

// The gate of a live lane whose a0 is not <= 0: tau <= m = min(horizon -
// t, cap), cap = LAM_MAX / max(max_j a_j, 1e-30), so a lane with m a0 <
// fallback does not leap and needs no Cao bound.
struct Gate {
  float left, cap;
  bool pass;
};

__device__ __forceinline__ Gate leap_gate(float a0, float a_max,
                                          float horizon, float t,
                                          float fallback) {
  Gate g;
  g.left = __fsub_rn(horizon, t);
  g.cap = __fdiv_rn(kLamMax, fmaxf(a_max, kFloor));
  g.pass = __fmul_rn(fminf(g.left, g.cap), a0) >= fallback;
  return g;
}

// tau_l = min(tau_c, horizon - t, cap); the lane leaps if tau_l a0 >=
// fallback
template <class Team, class Store>
__device__ __forceinline__ float leap_tau(const Team& tm, Store& st,
                                          const Tables& tb, float eps,
                                          const Gate& g) {
  return fminf(fminf(cao_tau(tm, st, tb, eps), g.left), g.cap);
}

// One reaction's Poisson count at tau from its uniform's bits, added to dx
// along the reaction's delta row.
template <class Store>
__device__ __forceinline__ void add_counts(Store& st, const Tables& tb, int j,
                                           uint32_t bits, float tau) {
  const float lam = __fmul_rn(st.a(j), tau);
  if (lam == 0.0f) return;  // exp_f32(-0) = 1 > u: K = 0
  const float k = ssa::poisson_from_uniform(ssa::bits_to_uniform(bits), lam);
  if (k > 0.0f) {  // K = 0 adds +-0 to an exact sum
    for (int q = 0; q < tb.D; ++q) {
      const int s = tb.row_idx[j * tb.D + q];
      if (s < tb.S) {
        st.add_dx(s, __fmul_rn(k, tb.row_val[j * tb.D + q]));
      }
    }
  }
}

// One leap attempt at tau from the ceil(R/2) counter blocks at ctr + off
// (block p gives reactions 2p and 2p+1; the team takes blocks rank, rank +
// size, ...). Applies x += dx and returns true if no population goes
// negative (or NaN, as the twin's all(x + dx >= 0)); else leaves x as it
// was. Team-uniform result.
template <class Team, class Store>
__device__ __forceinline__ bool leap_attempt(const Team& tm, Store& st,
                                             const Tables& tb, uint32_t k0,
                                             uint32_t k1, const Lane& ln,
                                             uint32_t off, float tau) {
  const int S = tb.S;
  for (int i = tm.rank(); i < S; i += Team::kSize) st.dx(i) = 0.0f;
  tm.sync();
  const int n_pairs = (tb.R + 1) / 2;
  for (int p = tm.rank(); p < n_pairs; p += Team::kSize) {
    uint32_t lo, hi, b0, b1;
    ssa::ctr_add(ln.c_lo, ln.c_hi, off + (uint32_t)p, lo, hi);
    ssa::threefry2x32(k0, k1, lo, hi, b0, b1);
    add_counts(st, tb, 2 * p, b0, tau);
    if (2 * p + 1 < tb.R) add_counts(st, tb, 2 * p + 1, b1, tau);
  }
  tm.sync();
  bool bad = false;
  for (int i = tm.rank(); i < S; i += Team::kSize) {
    bad |= !(__fadd_rn(st.x(i), st.dx(i)) >= 0.0f);
  }
  if (tm.any(bad)) return false;
  for (int i = tm.rank(); i < S; i += Team::kSize) {
    st.x(i) = __fadd_rn(st.x(i), st.dx(i));
  }
  tm.sync();
  return true;
}

// The leap of a lane whose tau_l a0 reached the fallback: attempt 1 at
// tau_l, the retry at tau_l / 2 on the next ceil(R/2) blocks. Returns whether a leap
// was applied (and advances the clock and tallies); ok1 tells whether
// attempt 1 was.
template <class Team, class Store>
__device__ __forceinline__ bool leap(const Team& tm, Store& st,
                                     const Tables& tb, uint32_t k0,
                                     uint32_t k1, float horizon, float tau_l,
                                     Lane& ln, bool& ok1) {
  const uint32_t n_pairs = (uint32_t)((tb.R + 1) / 2);
  float tau_done = tau_l;
  ok1 = leap_attempt(tm, st, tb, k0, k1, ln, 0u, tau_l);
  if (!ok1) {
    tau_done = __fmul_rn(0.5f, tau_l);
    if (!leap_attempt(tm, st, tb, k0, k1, ln, n_pairs, tau_done)) {
      return false;
    }
  }
  ln.t = fminf(__fadd_rn(ln.t, tau_done), horizon);
  ++ln.steps;
  ++ln.leaps;
  return true;
}

// The exact sub-step's draws, from the block after the leap attempts'
// (offset 0 when the lane did not try to leap): u2 and the clock it would
// reach.
__device__ __forceinline__ void exact_draws(uint32_t k0, uint32_t k1,
                                            const Lane& ln, uint32_t off,
                                            float a0, float& u2,
                                            float& t_next) {
  uint32_t lo, hi, b0, b1;
  ssa::ctr_add(ln.c_lo, ln.c_hi, off, lo, hi);
  ssa::threefry2x32(k0, k1, lo, hi, b0, b1);
  u2 = ssa::bits_to_uniform(b1);
  t_next = __fadd_rn(ln.t, ssa::waiting_time(ssa::bits_to_uniform(b0), a0));
}

// stream accounting: accepted attempt 1 = ceil(R/2) blocks, a retried leap
// 2 ceil(R/2), the exact sub-step one more
__device__ __forceinline__ void account(Lane& ln, int R, bool do_leap,
                                        bool ok1, bool leaped) {
  const uint32_t n_pairs = (uint32_t)((R + 1) / 2);
  const uint32_t used = (do_leap ? (ok1 ? n_pairs : 2u * n_pairs) : 0u) +
                        (leaped ? 0u : 1u);
  ssa::ctr_add(ln.c_lo, ln.c_hi, used, ln.c_lo, ln.c_hi);
}

}  // namespace tau
