// Fused sparse exact-SSA window for Hopper (sm_90a), one thread per lane.
//
// Replaces the Pallas TPU kernel
// `repro/kernels/ssa_step.py::_sparse_window_kernel` (driven there by
// `repro/kernels/ops.py::sparse_window_chunk_loop`). The step is the
// reference's `gillespie.sparse_ssa_step`: the (R,) propensity vector is
// carried across events and, after reaction j fires, only the rows of its
// dependency list dep(j) are recomputed. It serves the networks the dense
// kernel cannot hold (hundreds of species and reactions, or a reactant
// coefficient above 4). The lane's step is sparse_step.cuh: a seed per
// lane and launch, an a0 fold that resumes at the checkpoint below the
// rows that changed, a scan that counts checkpoints and refolds one block.
//
// Bound. On ring80 (R = 560) an event costs a fold of about 380 of the
// 560 rows for the lane, and a warp walks the union of its lanes' blocks
// (about all 18): one dependent float add per row, about 5 cycles each.
// The carry must sit where those reads cost nothing more, so the kernel
// has two routes, chosen by the wrapper from the shape before the launch
// (`ssa_step.sparse_window_route`, named in chip_smoke.py's output):
//
//   shared  each lane's region (checkpoints, then the carry padded with
//           zeros to whole blocks of 32 rows) in dynamic shared memory, as
//           many lanes a block (a multiple of 32, at most 128) as fit the
//           227 KB: 96 at R = 560, one block per SM. The populations stay
//           in the lane's row of x_out, read through L1 and L2. This
//           route holds R up to 1,728;
//   hbm     larger systems: the same regions in an HBM scratch tensor.
//
// Keeping the populations in shared memory too would leave 32 lanes a
// block at R = 560, 64 on lattice8x8; a trial of that layout was slower
// than this route on both. At three warps an SM
// the step is latency bound, one warp on each of three schedulers: the
// design keeps every chain short and every load early. The fold reads
// float4 words a block ahead of its adds; the scan's compares are
// independent counts; an event's recipe (one packed table row) and the
// next step's draws overlap, and every population read of an event is
// issued before any write.
//
// Persistent lanes: the grid is one wave; a warp takes 32 new lanes from
// an atomic ticket once all of its lanes have stopped, so no block waits
// for its slowest warp. A thread does not take a lane of its own:
// re-seeding R rows while the warp's other 31 threads wait would cost
// more than the lockstep it saves (warp step-slot efficiency is 0.89 on
// ring80). Per-lane bits are unchanged: lanes are independent and every
// output is written per lane.
//
// Bits. Explicit `_rn` intrinsics and the port's `log_f32` from
// ssa_common.cuh; the a0 fold and the scan run left to right, and the
// checkpoints repeat the same rounded adds (sparse_step.cuh).
//
// Build: kernels/build.py (sm_90a, one library with the other kernels).
// C interface, bound by ctypes.

#include "sparse_step.cuh"

namespace {

// ON_CHIP: each thread's region (`rows` floats: checkpoints and carry) in
// shared memory, else in p.scratch. The populations live in the lane's
// row of x_out.
template <bool ON_CHIP, int MAXC>
__global__ void sparse_window_kernel(sparse::Params p) {
  extern __shared__ float4 smem4[];
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gtid >= p.n_slots) return;
  float* region = ON_CHIP ? reinterpret_cast<float*>(smem4) +
                                (size_t)threadIdx.x * p.rows
                          : p.scratch + (size_t)gtid * p.rows;
  for (int lane = gtid; lane < p.B;
       lane = p.n_slots + ssa::take_lane(p.ticket)) {
    const float* xl = p.x + (size_t)lane * p.S;
    float* xs = p.x_out + (size_t)lane * p.S;
    for (int s = 0; s < p.S; ++s) xs[s] = xl[s];
    sparse::run_lane<MAXC, ON_CHIP>(p, lane, xs, region);
  }
}

}  // namespace

// One wave of blocks (or fewer, when the lanes run out first), each
// thread with one region: on chip, `threads` regions of p0.rows floats a
// block; in HBM, the first n_slots regions of p0.scratch.
template <bool ON_CHIP, int MAXC>
static int launch(const sparse::Params& p0, int threads, int* grid_lanes,
                  cudaStream_t stream) {
  auto kernel = sparse_window_kernel<ON_CHIP, MAXC>;
  const size_t smem =
      ON_CHIP ? (size_t)p0.rows * threads * sizeof(float) : 0;
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
  const long cap = ON_CHIP ? p0.B : p0.n_slots;  // lanes, or HBM regions
  const long wave = (long)n_sm * per_sm;
  const long need = (cap + threads - 1) / threads;
  const int blocks = (int)(need < wave ? need : wave);
  sparse::Params p = p0;
  const long taken = (long)blocks * threads;
  p.n_slots = (int)(taken < cap ? taken : cap);
  *grid_lanes = p.n_slots;
  kernel<<<blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// slots (R+1, 4) and recipe (R+1, W) int32 from `ssa_step.sparse_recipe`;
// rows: floats of a lane's region (a multiple of 4, at least the padded
// checkpoints and carry). Route 0: regions in `scratch`, (n_slots, rows)
// float32; route 1: in shared memory. `threads` lanes a block. ticket:
// one int32, zero. grid_lanes (host): set to the lanes the grid takes
// first, one per thread; the others come from the ticket. Returns a CUDA
// error code (0 on success).
extern "C" int sparse_window_launch(
    const void* x, const void* t, const void* dead, const void* key,
    const void* ctr, const void* ctr_hi, const void* slots,
    const void* recipe, const void* rates_pad, const void* dep_lo,
    int rates_per_lane, float horizon, int n_steps, int B, int S, int R,
    int W, int D, int K, int max_c, int route, int threads, int rows,
    int n_slots, void* scratch, void* ticket, int* grid_lanes,
    void* x_out, void* t_out,
    void* dead_out, void* steps_out, void* ctr_out, void* ctr_hi_out,
    void* stream) {
  if (B <= 0) return 0;
  const int need = sparse::ck_rows(R) + sparse::carry_rows(R);
  if (S < 1 || R < 1 || D < 1 || K < 1 || max_c < 1 || threads < 32 ||
      threads % 32 != 0 || route < 0 || route > 1 || rows < need ||
      rows % 4 != 0 || W != 4 * ((2 * D + 3) / 4) + 8 * K ||
      grid_lanes == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  sparse::Params p{
      (const float*)x, (const float*)t, (const int*)dead,
      (const uint32_t*)key, (const uint32_t*)ctr, (const uint32_t*)ctr_hi,
      (const int4*)slots, (const int4*)recipe, (const float*)rates_pad,
      (const int*)dep_lo, rates_per_lane, horizon, n_steps, B, S, R, D, K,
      max_c, rows, (float*)scratch, n_slots, (int*)ticket, (float*)x_out,
      (float*)t_out, (int*)dead_out, (int*)steps_out, (uint32_t*)ctr_out,
      (uint32_t*)ctr_hi_out};
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == 1) {
    // on chip, the comb unroll as a constant 2 for systems whose
    // coefficients are at most 2 (every model of the repository but the
    // pentamer): 6% off ring80's window. The HBM route, paced by its
    // scratch, gains nothing from it (PERF.md).
    return max_c <= 2 ? launch<true, 2>(p, threads, grid_lanes, st)
                      : launch<true, 0>(p, threads, grid_lanes, st);
  }
  if (n_slots < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  return launch<false, 0>(p, threads, grid_lanes, st);
}
