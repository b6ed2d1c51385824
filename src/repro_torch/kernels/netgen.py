"""The dense exact-SSA window kernel, generated for one reaction network.

`window_source(network(idx, coef, delta))` writes a CUDA source in which
the network's structure is compile-time constants: S and R, each
reaction's reactant slots (species and coefficient, in slot order) and
each reaction's nonzero delta entries. The rates stay an operand, shared
(R,) or per lane (B, R), so sweeps, steering and `set_rates` reuse one
build. `build.load_network` compiles the source into a library named by
its digest; `ssa_step.bind_network` binds it.

The kernel keeps `csrc/ssa_window.cu`'s contract and bits: the
persistent-lane ticket, the outputs and error code, explicitly rounded
intrinsics only, the stream, `log_f32`, `waiting_time` and
`comb_factor` from `ssa_common.cuh`, a0 folded left to right over all R,
j the first reaction whose running sum reaches u2 * a0 (0 when none),
the freeze at the horizon and the counter bump. What changes is where a
lane lives. With every index a constant, the lane's S populations and R
rates sit in registers (the table kernel keeps them in shared memory
because its Match gathers by a runtime index), and the Match, the fold,
the scan and the Update are straight-line code with no table reads:

  Match   every propensity, each event, from the registers. A propensity
          is a pure function of the populations, so this gives the bits
          the table kernel's carried values (recomputed for dep(j) only)
          hold; with constant slots a propensity is a few multiplies,
          and a warp's lanes that fired different reactions take the
          same instructions (per-reaction cases would run one after
          another for each distinct j in the warp);
  Fold    R adds; the running sums are the scan's, kept in registers;
  Scan    j from R compares and selects, last reaction first;
  Update  one predicated block of constant adds a reaction.

-0: the table kernel adds all of delta[j] to the populations, so a -0
population turns +0 at a lane's first event. Here a lane's populations
get + 0 when it is loaded and only nonzero entries are added after; a
lane that fires no event is written from its input, so its -0 stays.
"""
from __future__ import annotations

import hashlib
from string import Template
from typing import NamedTuple

import numpy as np

from repro_torch.core.reactions import MAX_COEF


class Network(NamedTuple):
    """A dense network's structure: S species, R reactions; slots[r]:
    reaction r's reactant (species, coefficient) pairs in slot order,
    coefficients > 0; changes[r]: its nonzero (species, delta) entries
    in species order."""

    n_species: int
    n_reactions: int
    slots: tuple
    changes: tuple


def network(idx, coef, delta) -> Network:
    """The structure of the dense tables idx / coef (R, 4) and delta
    (R, S), tensors on any device. Raises ValueError where a reactant
    coefficient exceeds the comb unroll (MAX_COEF)."""
    idx, coef, dl = (np.asarray(a.cpu()) for a in (idx, coef, delta))
    r, s = dl.shape
    if int(coef.max(initial=0)) > MAX_COEF:
        raise ValueError(f"network: reactant coefficients above {MAX_COEF} "
                         f"need sparse=True")
    slots = tuple(tuple((int(i), int(c)) for i, c in zip(idx[j], coef[j])
                        if c > 0) for j in range(r))
    changes = tuple(tuple((q, float(np.float32(dl[j, q])))
                          for q in range(s) if dl[j, q] != 0)
                    for j in range(r))
    return Network(s, r, slots, changes)


def network_name(net: Network) -> str:
    """`net_<digest>`: the namespace of the network's kernel, a digest
    of its structure (rates are no part of it)."""
    h = hashlib.sha256(repr(tuple(net)).encode())
    return f"net_{h.hexdigest()[:16]}"


def _f32(v: float) -> str:
    """A float32 value as an exact C++ literal."""
    if v.is_integer() and abs(v) < 2 ** 24:
        return f"{int(v)}.0f"
    return f"{float(np.float32(v)).hex()}f"


def _match(net: Network) -> str:
    """a[r] = rate first, then one comb factor a slot in slot order (the
    association every kernel and the twin share)."""
    lines = []
    for r in range(net.n_reactions):
        a = f"k[{r}]"
        for s, c in net.slots[r]:
            a = f"__fmul_rn({a}, ssa::comb_factor(x[{s}], {c}, kMaxCoef))"
        lines.append(f"  a[{r}] = {a};")
    return "\n".join(lines)


def _update(net: Network) -> str:
    """x += delta[j], nonzero entries only."""
    lines = []
    for r in range(net.n_reactions):
        adds = " ".join(f"x[{s}] = __fadd_rn(x[{s}], {_f32(v)});"
                        for s, v in net.changes[r])
        if adds:
            lines.append(f"  if (j == {r}) {{ {adds} }}")
    return "\n".join(lines)


_SOURCE = Template(r"""// Dense exact-SSA window for one reaction network: S = $S species,
// R = $R reactions. Generated by repro_torch/kernels/netgen.py from the
// network's tables (the structure is compile-time constants, the rates an
// operand); the same contract and bits as csrc/ssa_window.cu, and like it
// the port of the Pallas kernel repro/kernels/ssa_step.py::_window_kernel.
// Bound: instructions per event (threefry's integer rounds, the log, the
// network's Match, fold, scan and Update), with the lane in registers.
#include "ssa_common.cuh"

namespace $name {

constexpr int S = $S;
constexpr int R = $R;
constexpr int kMaxCoef = $max_coef;
constexpr int kLanes = 128;  // threads (lanes) a block

struct Params {
  const float* x;
  const float* t;
  const int* dead;
  const uint32_t* key;
  const uint32_t* ctr;
  const uint32_t* ctr_hi;
  const float* rates;  // (R,) shared or (B, R) per lane
  int rates_per_lane;
  float horizon;
  int n_steps, B;
  int slots;    // lanes the grid takes first (one per thread)
  int* ticket;  // persistent lanes: the next lane is slots + ticket
  float* x_out;
  float* t_out;
  int* dead_out;
  int* steps_out;
  uint32_t* ctr_out;
  uint32_t* ctr_hi_out;
};

// every propensity from the populations x and the rates k
__device__ __forceinline__ void match(const float (&x)[S],
                                      const float (&k)[R], float (&a)[R]) {
$match
}

// x += delta[j]
__device__ __forceinline__ void update(int j, float (&x)[S]) {
$update
}

__global__ void __launch_bounds__(kLanes) ssa_window_kernel(Params p) {
  __shared__ float s_rates[R];
  if (!p.rates_per_lane) {
    for (int i = threadIdx.x; i < R; i += blockDim.x) s_rates[i] = p.rates[i];
  }
  __syncthreads();
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.B) return;

  float x[S], k[R];
  float tl = 0.0f;
  bool dl = false;
  uint32_t k0 = 0, k1 = 0, c_lo = 0, c_hi = 0;
  int steps = 0, it = 0;
  bool fresh = true;  // `lane` is to be loaded

  for (;;) {
    if (fresh) {
      fresh = false;
      // + 0: a -0 population turns +0, as at the first event of the
      // full-width update x + delta[j]
#pragma unroll
      for (int s = 0; s < S; ++s) {
        x[s] = __fadd_rn(p.x[(size_t)lane * S + s], 0.0f);
      }
      const float* rate =
          p.rates_per_lane ? p.rates + (size_t)lane * R : s_rates;
#pragma unroll
      for (int r = 0; r < R; ++r) k[r] = rate[r];
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
      float* xo = p.x_out + (size_t)lane * S;
      if (steps == 0) {  // no event: the input's bits, -0 included
#pragma unroll
        for (int s = 0; s < S; ++s) xo[s] = p.x[(size_t)lane * S + s];
      } else {
#pragma unroll
        for (int s = 0; s < S; ++s) xo[s] = x[s];
      }
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
    // the Match, then a0 folded left to right from 0; the running sums
    // are the scan's
    float cum[R];
    match(x, k, cum);
    float a0 = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) cum[r] = a0 = __fadd_rn(a0, cum[r]);
    const bool now_dead = a0 <= 0.0f;
    uint32_t b0, b1;
    ssa::threefry2x32(k0, k1, c_lo, c_hi, b0, b1);
    const float u1 = ssa::bits_to_uniform(b0);
    const float u2 = ssa::bits_to_uniform(b1);
    const float t_next = __fadd_rn(tl, ssa::waiting_time(u1, a0));
    if (!now_dead && t_next <= p.horizon) {
      const float thresh = __fmul_rn(u2, a0);
      int j = 0;  // first true, 0 when none (the reference's argmax)
#pragma unroll
      for (int r = R - 1; r >= 0; --r) j = cum[r] >= thresh ? r : j;
      update(j, x);
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

}  // namespace $name

// rates (R,) or (B, R); ticket: one int32, zero. Returns a CUDA error
// code (0 on success).
extern "C" int ssa_window_net_launch(
    const void* x, const void* t, const void* dead, const void* key,
    const void* ctr, const void* ctr_hi, const void* rates,
    int rates_per_lane, float horizon, int n_steps, int B, void* ticket,
    void* x_out, void* t_out, void* dead_out, void* steps_out,
    void* ctr_out, void* ctr_hi_out, void* stream) {
  using namespace $name;
  if (B <= 0) return 0;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ssa_window_kernel, kLanes, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long wave = (long)n_sm * per_sm;
  const long need = (B + kLanes - 1) / kLanes;
  const int blocks = (int)(need < wave ? need : wave);
  Params p{(const float*)x, (const float*)t, (const int*)dead,
           (const uint32_t*)key, (const uint32_t*)ctr,
           (const uint32_t*)ctr_hi, (const float*)rates, rates_per_lane,
           horizon, n_steps, B, blocks * kLanes, (int*)ticket,
           (float*)x_out, (float*)t_out, (int*)dead_out, (int*)steps_out,
           (uint32_t*)ctr_out, (uint32_t*)ctr_hi_out};
  ssa_window_kernel<<<blocks, kLanes, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
""")


def window_source(net: Network) -> str:
    """The CUDA source of `net`'s dense exact window kernel: entry
    `ssa_window_net_launch` (C interface), kernel
    `net_<digest>::ssa_window_kernel`, which a trace names
    `ssa_window_kernel` as it names the table kernel."""
    return _SOURCE.substitute(name=network_name(net), S=net.n_species,
                              R=net.n_reactions, max_coef=MAX_COEF,
                              match=_match(net), update=_update(net))
