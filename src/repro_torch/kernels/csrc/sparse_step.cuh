// One lane's sparse exact-SSA window, shared by the routes of
// sparse_window.cu: the reference's `gillespie.sparse_ssa_step` looped, as
// repro_torch/core/gillespie.py spells it and `sparse_window_plain` runs
// it. The routes differ only in where the lane's region lives (shared
// memory or an HBM scratch tensor), so the lane is written once.
//
//   Seed    every a[r] from x: rates first, slots in order, the comb
//           unroll to the system's max_c;
//   a0      the left-to-right fold of a[0..R-1], with its running sum
//           kept at every 32nd row: ck[k] = fold of a[0..32k-1]. After j
//           fires only the rows of dep(j) change, so the next fold resumes
//           at the checkpoint at or below dep(j)'s lowest row (`dep_lo`):
//           the same rounded adds from the same value, the same a0. The
//           carry is padded with zeros to whole blocks; adding +0 to a
//           running sum that starts at +0 changes no bit;
//   Resolve threefry2x32 uniforms; tau = -log(u1) / max(a0, 1e-30); j =
//           the first r whose running sum reaches u2*a0 (0 when none). No
//           a[r] below 0 (and none NaN) makes the running sum
//           non-decreasing under rounding, so every row below the last
//           checkpoint under u2*a0 is short of it: the scan counts the
//           checkpoints below the threshold and refolds one block of 32
//           rows from the last of them. A lane holding a row that is not
//           >= 0 (a negative sweep rate, a NaN) scans from row 0 instead;
//           `bad` counts those rows;
//   Update  x += the delta entries of row j; recompute the dep(j) rows in
//           the reference's slot order; a lane whose next event would
//           cross the horizon freezes there; the counter advances once per
//           active step.
//
// Layout. A lane's region is `rows` floats, contiguous and 16-byte
// aligned: the checkpoints (padded to a multiple of 4), then the carry
// (R rows and the zero padding). A fold starts at a multiple of
// 32 rows, so its float4 reads of lanes t and t+1 sit rows/4 16-byte
// words apart; with rows/4 odd the 8 lanes of a quarter-warp read 8
// distinct bank groups whatever block each of them is in. Reaction j's
// update recipe is one row of `recipe` (`ssa_step.sparse_recipe`): its
// delta entries as (species, value bits) pairs, padded to a multiple of 4
// words, then per dep row two int4 words: (reaction, rate bits, 0, 0)
// and its four packed slots; a packed slot is species | coefficient <<
// 24, 0 for an empty slot. The seed reads `slots`, the (R+1, 4) packed slots of
// every reaction. Each is read as int4 words, and every load of an event
// is issued before any of its results is used.
//
// Pad entries (species S, reaction R) are skipped: the reference drops
// them into a junk column that is never read.
#pragma once

#include "ssa_common.cuh"

namespace sparse {

// a checkpoint of the a0 fold every 2^kCkShift rows
constexpr int kCkShift = 5;
constexpr int kBlock = 1 << kCkShift;

__host__ __device__ __forceinline__ int n_checkpoints(int R) {
  return ((R - 1) >> kCkShift) + 1;
}

// the checkpoints' rows, padded so that a[0] is 16-byte aligned
__host__ __device__ __forceinline__ int ck_rows(int R) {
  return (n_checkpoints(R) + 3) & ~3;
}

// the carry's rows: R, then zeros up to whole blocks. Folding a zero adds
// nothing (the running sum starts at +0 and is never -0), so the fold and
// the scan read whole blocks.
__host__ __device__ __forceinline__ int carry_rows(int R) {
  return n_checkpoints(R) << kCkShift;
}

struct Params {
  const float* x;
  const float* t;
  const int* dead;
  const uint32_t* key;
  const uint32_t* ctr;
  const uint32_t* ctr_hi;
  const int4* slots;     // (R+1, 4) packed reactant slots
  const int4* recipe;    // (R+1, W) update recipes, W/4 int4 each
  const float* rates_pad;  // (R+1,) shared or (B, R+1) per lane
  const int* dep_lo;     // (R+1,) lowest row of dep(j), R when empty
  int rates_per_lane;
  float horizon;
  int n_steps, B, S, R, D, K, max_c;
  int rows;        // floats in a lane's region
  float* scratch;  // HBM route: (slots, rows)
  int n_slots;     // lanes the grid takes first (one per thread)
  int* ticket;     // persistent lanes: the next lane is n_slots + ticket
  float* x_out;
  float* t_out;
  int* dead_out;
  int* steps_out;
  uint32_t* ctr_out;
  uint32_t* ctr_hi_out;
};

__device__ __forceinline__ int not_nonneg(float v) {
  return v >= 0.0f ? 0 : 1;
}

// a packed slot's coefficient and species
__device__ __forceinline__ int coef_of(int packed) {
  return (int)((unsigned)packed >> 24);
}
__device__ __forceinline__ int species_of(int packed) {
  return packed & 0xFFFFFF;
}

// the populations of a row's four slots, 0 for an empty slot
__device__ __forceinline__ void gather(const float* xs, const int4& s,
                                       float (&g)[4]) {
  g[0] = coef_of(s.x) > 0 ? xs[species_of(s.x)] : 0.0f;
  g[1] = coef_of(s.y) > 0 ? xs[species_of(s.y)] : 0.0f;
  g[2] = coef_of(s.z) > 0 ? xs[species_of(s.z)] : 0.0f;
  g[3] = coef_of(s.w) > 0 ? xs[species_of(s.w)] : 0.0f;
}

// one slot's factor into v; an empty slot contributes exactly 1
__device__ __forceinline__ float slot(float v, float x, int packed,
                                      int max_c) {
  const int c = coef_of(packed);
  return c > 0 ? __fmul_rn(v, ssa::comb_factor(x, c, max_c)) : v;
}

// rate * C(x_0, c_0) * ... in slot order (rates first), from the slots'
// gathered populations g
__device__ __forceinline__ float product(float v, const int4& s,
                                         const float (&g)[4], int max_c) {
  v = slot(v, g[0], s.x, max_c);
  v = slot(v, g[1], s.y, max_c);
  v = slot(v, g[2], s.z, max_c);
  return slot(v, g[3], s.w, max_c);
}

// dep rows kk .. kk+3 of a recipe's dep block: (reaction, rate bits, ...)
// and the packed slots; reaction R past K
__device__ __forceinline__ void load_dep(const int4* dep, int kk, int K,
                                         int R, int4 (&h)[4],
                                         int4 (&s)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const bool in = kk + u < K;
    h[u] = in ? __ldg(dep + 2 * (kk + u)) : make_int4(R, 0, 0, 0);
    s[u] = in ? __ldg(dep + 2 * (kk + u) + 1) : make_int4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ float fold4(float acc, const float4& q) {
  acc = __fadd_rn(acc, q.x);
  acc = __fadd_rn(acc, q.y);
  acc = __fadd_rn(acc, q.z);
  return __fadd_rn(acc, q.w);
}

constexpr int kV = kBlock / 4;  // float4 words of a block

__device__ __forceinline__ void load_block(const float* a, int r,
                                           float4 (&q)[kV]) {
#pragma unroll
  for (int i = 0; i < kV; ++i) q[i] = reinterpret_cast<const float4*>(a + r)[i];
}

// a0: the fold of the carry from the checkpoint of block k0 on, writing
// each later block's checkpoint; the next block's reads are in flight
// while this block's adds run. UNIFORM (the carry in shared memory): the
// warp walks the blocks from the least k0 of its active threads together
// (a thread before its own k0 adds into a sum it then drops), so no
// thread waits at a branch; else each thread reads only its own blocks.
template <bool UNIFORM>
__device__ __forceinline__ float fold_from(float* ck, const float* a, int k0,
                                           int nblk) {
  int k = UNIFORM ? (int)__reduce_min_sync(__activemask(), (unsigned)k0)
                  : k0;
  const float start = ck[k0];
  float acc = 0.0f;
  float4 q0[kV], q1[kV];
  load_block(a, k << kCkShift, q0);
  while (k < nblk) {
    if (k + 1 < nblk) load_block(a, (k + 1) << kCkShift, q1);
    if (k == k0) acc = start;
    if (k >= k0) ck[k] = acc;
#pragma unroll
    for (int i = 0; i < kV; ++i) acc = fold4(acc, q0[i]);
    if (++k >= nblk) break;
    if (k + 1 < nblk) load_block(a, (k + 1) << kCkShift, q0);
    if (k == k0) acc = start;
    if (k >= k0) ck[k] = acc;
#pragma unroll
    for (int i = 0; i < kV; ++i) acc = fold4(acc, q1[i]);
    ++k;
  }
  return acc;
}

// j for a lane whose rows are all >= 0, where running sums never fall:
// the checkpoints k >= 1 below thresh are the blocks the scan skips, and
// within the next block the sums below thresh come before the first that
// reaches it (its zero rows past R repeat a0 >= thresh). Both are counts
// of independent compares.
__device__ __forceinline__ int scan_monotone(const float* ck, const float* a,
                                             int nblk, float thresh) {
  int n0 = 0, n1 = 0, n2 = 0, n3 = 0;
  int k = 1;
  for (; k + 3 < nblk; k += 4) {
    n0 += ck[k] < thresh ? 1 : 0;
    n1 += ck[k + 1] < thresh ? 1 : 0;
    n2 += ck[k + 2] < thresh ? 1 : 0;
    n3 += ck[k + 3] < thresh ? 1 : 0;
  }
  for (; k < nblk; ++k) n0 += ck[k] < thresh ? 1 : 0;
  const int kl = (n0 + n1) + (n2 + n3);
  float cum = ck[kl];
  float4 q[kV];
  load_block(a, kl << kCkShift, q);
  int m[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    cum = __fadd_rn(cum, q[i].x);
    m[0] += cum < thresh ? 1 : 0;
    cum = __fadd_rn(cum, q[i].y);
    m[1] += cum < thresh ? 1 : 0;
    cum = __fadd_rn(cum, q[i].z);
    m[2] += cum < thresh ? 1 : 0;
    cum = __fadd_rn(cum, q[i].w);
    m[3] += cum < thresh ? 1 : 0;
  }
  const int below = (m[0] + m[1]) + (m[2] + m[3]);
  // none reaches thresh only if thresh > a0: the reference's argmax, 0
  return below < kBlock ? (kl << kCkShift) + below : 0;
}

// j for any lane: the running sum from row 0
__device__ __forceinline__ int scan_linear(const float* a, int R,
                                           float thresh) {
  float cum = 0.0f;
  for (int r = 0; r < R; ++r) {
    cum = __fadd_rn(cum, a[r]);
    if (cum >= thresh) return r;
  }
  return 0;
}

// The direct method's draws from the counter block (lo, hi): u2 and
// -log(u1), which the step divides by max(a0, 1e-30).
__device__ __forceinline__ void draws(uint32_t k0, uint32_t k1, uint32_t lo,
                                      uint32_t hi, float& u2, float& nlog) {
  uint32_t b0, b1;
  ssa::threefry2x32(k0, k1, lo, hi, b0, b1);
  nlog = -ssa::log_f32(ssa::bits_to_uniform(b0));
  u2 = ssa::bits_to_uniform(b1);
}

// populations of one row's slots with delta pairs (e0, e1) applied:
// g holds xs before the event; a slot on a changed species takes its new
// value (the species of a row's delta entries are distinct)
__device__ __forceinline__ void apply_pairs(const int4& s, float (&g)[4],
                                            const int4& e, float xa,
                                            float xb) {
  const int sp[4] = {species_of(s.x), species_of(s.y), species_of(s.z),
                     species_of(s.w)};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (sp[m] == e.x) g[m] = xa;
    if (sp[m] == e.z) g[m] = xb;
  }
}

// Runs `lane` for up to n_steps events. xs holds its populations (loaded
// by the caller, and left there); region is its checkpoints and carry.
// MAXC > 0: the comb unroll's bound as a constant, at least the system's
// max_c (iterations past a slot's c are exact no-ops); 0: p.max_c.
// ON_CHIP: the region is in shared memory.
template <int MAXC, bool ON_CHIP>
__device__ __forceinline__ void run_lane(const Params& p, int lane,
                                         float* xs, float* region) {
  const int R = p.R, S = p.S, D = p.D, K = p.K;
  const int max_c = MAXC > 0 ? MAXC : p.max_c;
  float* ck = region;
  float* a = region + ck_rows(R);
  const int nblk = n_checkpoints(R);
  const float* rate =
      p.rates_per_lane ? p.rates_pad + (size_t)lane * (R + 1) : p.rates_pad;
  const int dw = (2 * D + 3) >> 2;  // int4 words of delta pairs
  const int w4 = dw + 2 * K;        // int4 words of a recipe row

  // seed, kSeed rows at a time: every load before any product
  constexpr int kSeed = 8;
  int bad = 0;
  for (int r0 = 0; r0 < R; r0 += kSeed) {
    int4 s[kSeed];
    float v[kSeed], g[kSeed][4];
#pragma unroll
    for (int u = 0; u < kSeed; ++u) {
      const int r = min(r0 + u, R);  // row R, the pad: rate 0, no slot
      s[u] = __ldg(p.slots + r);
      v[u] = __ldg(rate + r);
    }
#pragma unroll
    for (int u = 0; u < kSeed; ++u) gather(xs, s[u], g[u]);
#pragma unroll
    for (int u = 0; u < kSeed; ++u) {
      if (r0 + u < R) {
        const float w = product(v[u], s[u], g[u], max_c);
        a[r0 + u] = w;
        bad += not_nonneg(w);
      }
    }
  }
  for (int r = R; r < carry_rows(R); ++r) a[r] = 0.0f;
  ck[0] = 0.0f;

  float tl = p.t[lane];
  bool dl = p.dead[lane] > 0;
  const uint32_t k0 = p.key[2 * (size_t)lane];
  const uint32_t k1 = p.key[2 * (size_t)lane + 1];
  uint32_t c_lo = p.ctr[lane];
  uint32_t c_hi = p.ctr_hi[lane];
  int steps = 0;
  int lo = 0;  // lowest row changed since the last fold
  float u2, nlog;  // this step's draws, made ahead of it
  draws(k0, k1, c_lo, c_hi, u2, nlog);

  // a lane that is not live stays so: its remaining steps are no-ops
  for (int it = 0; it < p.n_steps && tl < p.horizon && !dl; ++it) {
    const float a0 =
        fold_from<ON_CHIP>(ck, a, min(lo, R - 1) >> kCkShift, nblk);
    const bool now_dead = a0 <= 0.0f;
    const float t_next =
        __fadd_rn(tl, __fdiv_rn(nlog, fmaxf(a0, 0x1.4484cp-100f)));
    uint32_t n_lo = c_lo + 1u;
    const uint32_t n_hi = c_hi + (n_lo == 0u ? 1u : 0u);
    if (!now_dead && t_next <= p.horizon) {
      const float thresh = __fmul_rn(u2, a0);
      const int j = bad == 0 ? scan_monotone(ck, a, nblk, thresh)
                             : scan_linear(a, R, thresh);
      const int4* rec = p.recipe + (size_t)j * w4;
      const int4* dep = rec + dw;
      lo = __ldg(p.dep_lo + j);
      int4 e0 = __ldg(rec), e1 = make_int4(S, 0, S, 0);
      if (dw > 1) e1 = __ldg(rec + 1);
      int4 h[4], s[4];
      load_dep(dep, 0, K, R, h, s);
      // the next step's draws while this event's loads are in flight
      draws(k0, k1, n_lo, n_hi, u2, nlog);
      bool done = false;  // the dep rows recomputed
      if (dw <= 2) {
        // up to four delta pairs: every population read is issued before
        // any is written
        const float x0 = e0.x < S ? xs[e0.x] : 0.0f;
        const float x1 = e0.z < S ? xs[e0.z] : 0.0f;
        const float x2 = e1.x < S ? xs[e1.x] : 0.0f;
        const float x3 = e1.z < S ? xs[e1.z] : 0.0f;
        float g[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) gather(xs, s[u], g[u]);
        const float y0 = __fadd_rn(x0, __int_as_float(e0.y));
        const float y1 = __fadd_rn(x1, __int_as_float(e0.w));
        const float y2 = __fadd_rn(x2, __int_as_float(e1.y));
        const float y3 = __fadd_rn(x3, __int_as_float(e1.w));
        if (e0.x < S) xs[e0.x] = y0;
        if (e0.z < S) xs[e0.z] = y1;
        if (e1.x < S) xs[e1.x] = y2;
        if (e1.z < S) xs[e1.z] = y3;
        if (K <= 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            apply_pairs(s[u], g[u], e0, y0, y1);
            apply_pairs(s[u], g[u], e1, y2, y3);
            const int rr = h[u].x;
            if (rr < R) {
              const float v = p.rates_per_lane ? __ldg(rate + rr)
                                               : __int_as_float(h[u].y);
              const float w = product(v, s[u], g[u], max_c);
              bad += not_nonneg(w) - not_nonneg(a[rr]);
              a[rr] = w;
            }
          }
          done = true;
        }
      } else {
        for (int q = 0; q < dw; ++q) {
          const int4 e = __ldg(rec + q);
          const float xa = e.x < S ? xs[e.x] : 0.0f;
          const float xb = e.z < S ? xs[e.z] : 0.0f;
          if (e.x < S) xs[e.x] = __fadd_rn(xa, __int_as_float(e.y));
          if (e.z < S) xs[e.z] = __fadd_rn(xb, __int_as_float(e.w));
        }
      }
      // the general path: populations already updated, four dep rows at
      // a time
      for (int kk = 0; kk < K && !done; kk += 4) {
        if (kk > 0) load_dep(dep, kk, K, R, h, s);
        float v[4], g[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = p.rates_per_lane ? __ldg(rate + h[u].x)
                                  : __int_as_float(h[u].y);
          gather(xs, s[u], g[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int rr = h[u].x;
          if (rr < R) {
            const float w = product(v[u], s[u], g[u], max_c);
            bad += not_nonneg(w) - not_nonneg(a[rr]);
            a[rr] = w;
          }
        }
      }
      tl = t_next;
      ++steps;
    } else {
      // dead, or the next event would cross: freeze at the horizon
      tl = p.horizon;
      dl = now_dead;
    }
    c_lo = n_lo;
    c_hi = n_hi;
  }

  p.t_out[lane] = tl;
  p.dead_out[lane] = dl ? 1 : 0;
  p.steps_out[lane] = steps;
  p.ctr_out[lane] = c_lo;
  p.ctr_hi_out[lane] = c_hi;
}

}  // namespace sparse
