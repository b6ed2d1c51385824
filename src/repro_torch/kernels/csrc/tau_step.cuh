// One adaptive tau-leap iteration of one lane, shared by the dense
// (tau_window.cu) and sparse (sparse_tau_window.cu) tau kernels; the same
// step as repro_torch/core/tau_leap.py::tau_step_core, which the plain twins
// loop. The kernels differ only in where the tables and the lane's arrays
// live, so the step is written once over a `Store` that hands out the
// lane's populations x(i), propensities a(j) and Poisson counts kc(j).
//
//   Match    a_j rates first, slots in order; a0 left to right; max a_j;
//   Cao tau  per consumed species i, mu_i and sig2_i left to right over the
//            nonzeros of column i of delta, the g_i bound, bnd = max(eps x_i
//            / g_i, 1), tau_c = min_i min(bnd / |mu_i|, bnd^2 / sig2_i);
//            tau = min(tau_c, horizon - t, LAM_MAX / max_j a_j);
//   leap     if tau a0 >= fallback: K_j ~ Poisson(a_j tau) from the
//            ceil(R/2) counter blocks at ctr; if some x_i + dx_i < 0, retry
//            once at tau/2 with the blocks at ctr + ceil(R/2);
//   exact    otherwise (or after two rejections) one direct-method step on
//            the block at ctr (at ctr + 2 ceil(R/2) after two rejections).
//
// The counter then advances by what the reference's stream accounting
// consumes. Bits: explicit `_rn` intrinsics, the port's exp_f32 and log_f32;
// dx is a sum of integers below 2^24, exact in any order. A species column's
// pads sit at its end (reaction index R), so the column walks stop there.
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

// The lane's clock, flags, counter and tallies.
struct Lane {
  float t;
  bool dead;
  uint32_t c_lo, c_hi;
  int steps, leaps;
};

// Poisson counts of one leap attempt at tau from the ceil(R/2) counter
// blocks at ctr + off: block p gives reactions 2p and 2p+1.
template <class Store>
__device__ __forceinline__ void leap_draws(Store& st, const Tables& tb,
                                           uint32_t k0, uint32_t k1,
                                           const Lane& ln, uint32_t off,
                                           float tau) {
  const int n_pairs = (tb.R + 1) / 2;
  for (int p = 0; p < n_pairs; ++p) {
    uint32_t lo, hi, b0, b1;
    ssa::ctr_add(ln.c_lo, ln.c_hi, off + (uint32_t)p, lo, hi);
    ssa::threefry2x32(k0, k1, lo, hi, b0, b1);
    const int j = 2 * p;
    st.kc(j) = ssa::poisson_from_uniform(ssa::bits_to_uniform(b0),
                                         __fmul_rn(st.a(j), tau));
    if (j + 1 < tb.R) {
      st.kc(j + 1) = ssa::poisson_from_uniform(ssa::bits_to_uniform(b1),
                                               __fmul_rn(st.a(j + 1), tau));
    }
  }
}

// x_i + dx_i, dx_i = sum of kc_j delta_ji over column i's nonzeros
template <class Store>
__device__ __forceinline__ float leap_target(Store& st, const Tables& tb,
                                             int i) {
  float dx = 0.0f;
  for (int l = 0; l < tb.L; ++l) {
    const int j = tb.col_j[i * tb.L + l];
    if (j >= tb.R) break;
    dx = __fadd_rn(dx, __fmul_rn(st.kc(j), tb.col_v[i * tb.L + l]));
  }
  return __fadd_rn(st.x(i), dx);
}

// apply the drawn leap if no population goes negative; returns whether it
// did
template <class Store>
__device__ __forceinline__ bool leap_accept(Store& st, const Tables& tb) {
  for (int i = 0; i < tb.S; ++i) {
    if (leap_target(st, tb, i) < 0.0f) return false;
  }
  for (int i = 0; i < tb.S; ++i) st.x(i) = leap_target(st, tb, i);
  return true;
}

// one iteration of a live lane (t < horizon, not dead); `fallback` is +inf
// for a lane pinned to exact steps; max_c the comb-factor unroll
template <class Store>
__device__ __forceinline__ void iteration(Store& st, const Tables& tb,
                                          const float* rate, int max_c,
                                          float horizon, float eps,
                                          float fallback, uint32_t k0,
                                          uint32_t k1, Lane& ln) {
  const int R = tb.R, S = tb.S;
  const uint32_t n_pairs = (uint32_t)((R + 1) / 2);
  float a0 = 0.0f;
  float a_max = 0.0f;
  for (int j = 0; j < R; ++j) {
    float v = rate[j];
    for (int m = 0; m < 4; ++m) {
      const int c = tb.coef[j * 4 + m];
      if (c > 0) {  // a slot with c == 0 contributes exactly 1
        v = __fmul_rn(v, ssa::comb_factor(st.x(tb.idx[j * 4 + m]), c, max_c));
      }
    }
    st.a(j) = v;
    a0 = __fadd_rn(a0, v);
    a_max = fmaxf(a_max, v);
  }
  const bool now_dead = a0 <= 0.0f;

  bool do_leap = false;
  float tau_l = 0.0f;
  if (!now_dead) {
    float tau_c = INFINITY;
    for (int i = 0; i < S; ++i) {
      if (!(tb.rmask[i] > 0.0f)) continue;  // only consumed species bound
      float mu = 0.0f, sig2 = 0.0f;
      for (int l = 0; l < tb.L; ++l) {
        const int j = tb.col_j[i * tb.L + l];
        if (j >= R) break;
        const float v = tb.col_v[i * tb.L + l];
        const float aj = st.a(j);
        mu = __fadd_rn(mu, __fmul_rn(aj, v));
        sig2 = __fadd_rn(sig2, __fmul_rn(aj, __fmul_rn(v, v)));
      }
      const float xi = st.x(i);
      float g = tb.gi[i];
      for (int k = 1; k < tb.G; ++k) {  // a zero row adds exactly +0
        const float c = tb.gi[k * S + i];
        if (c != 0.0f) {
          g = __fadd_rn(g, __fdiv_rn(c, fmaxf(__fsub_rn(xi, (float)k), 1.0f)));
        }
      }
      const float bnd = fmaxf(__fdiv_rn(__fmul_rn(eps, xi), g), 1.0f);
      const float amu = fabsf(mu);
      const float r1 =
          amu > 0.0f ? __fdiv_rn(bnd, fmaxf(amu, kFloor)) : INFINITY;
      const float r2 = sig2 > 0.0f
                           ? __fdiv_rn(__fmul_rn(bnd, bnd), fmaxf(sig2, kFloor))
                           : INFINITY;
      tau_c = fminf(tau_c, fminf(r1, r2));
    }
    tau_l = fminf(fminf(tau_c, __fsub_rn(horizon, ln.t)),
                  __fdiv_rn(kLamMax, fmaxf(a_max, kFloor)));
    do_leap = __fmul_rn(tau_l, a0) >= fallback;
  }

  bool ok1 = false, leaped = false;
  float tau_done = 0.0f;
  if (do_leap) {
    leap_draws(st, tb, k0, k1, ln, 0u, tau_l);
    ok1 = leap_accept(st, tb);
    if (ok1) {
      leaped = true;
      tau_done = tau_l;
    } else {  // the retry at tau/2 on the next ceil(R/2) blocks
      const float tau_h = __fmul_rn(0.5f, tau_l);
      leap_draws(st, tb, k0, k1, ln, n_pairs, tau_h);
      if (leap_accept(st, tb)) {
        leaped = true;
        tau_done = tau_h;
      }
    }
  }
  if (leaped) {
    ln.t = fminf(__fadd_rn(ln.t, tau_done), horizon);
    ++ln.steps;
    ++ln.leaps;
  } else {
    // the exact sub-step: its block follows the two attempts' when both
    // were rejected
    uint32_t lo, hi, b0, b1;
    ssa::ctr_add(ln.c_lo, ln.c_hi, do_leap ? 2u * n_pairs : 0u, lo, hi);
    ssa::threefry2x32(k0, k1, lo, hi, b0, b1);
    const float u1 = ssa::bits_to_uniform(b0);
    const float u2 = ssa::bits_to_uniform(b1);
    const float t_next = __fadd_rn(ln.t, ssa::waiting_time(u1, a0));
    if (!now_dead && t_next <= horizon) {
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
      ln.t = t_next;
      ++ln.steps;
    } else {
      // dead, or the next event would cross: freeze at the horizon
      ln.t = horizon;
      ln.dead = now_dead;
    }
  }
  // stream accounting: accepted attempt 1 = ceil(R/2) blocks, a retried
  // leap 2 ceil(R/2), the exact sub-step one more
  const uint32_t used = (do_leap ? (ok1 ? n_pairs : 2u * n_pairs) : 0u) +
                        (leaped ? 0u : 1u);
  ssa::ctr_add(ln.c_lo, ln.c_hi, used, ln.c_lo, ln.c_hi);
}

}  // namespace tau
