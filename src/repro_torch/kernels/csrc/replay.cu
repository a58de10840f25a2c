// Makespan replay of a bucket of padded plan DAGs, CUDA C++ for sm_90a: the
// first, simple port ("walk"), kept as the yardstick of replay_sm90.cu,
// which the card path takes by default; this kernel runs only when asked
// (kernels/replay/replay.py, kernel="walk").
//
// Replaces the JAX package's jitted replay
//   src/repro/sim/batch.py::_bucket_makespans (:455), a vmap over plans and
//   seeds of the lax.scan src/repro/sim/batch.py::_one_makespan (:275),
// XLA code rather than a Pallas kernel: a torch loop over the topological
// steps would launch several kernels at every one of up to 5011 steps.
//
// For every plan b of the bucket and every seed s it walks order[b, :] and
// sets, for task j = order[b, i],
//   start = max(max(0, max_k finish[pred[b, j, k]] + delay[b, j, k]), floor[b, j])
//   finish[j] = start + times[b, s, j]
// and writes out[b, s] = max_j finish[j], all in fp32.  Every operation is
// an add (rounded once, __fadd_rn, so no FMA can form; no fast-math) or an
// exact max that keeps NaN (max_nan, sm90_common.cuh, as jnp.max and
// torch.amax do), taken on the operands of the reference's scan, so the result
// equals the plain version (replay/ref.py::bucket_makespans_ref) and the
// JAX package's float32 scan bit for bit.
//
// What bounds it on the H100: each lane is one chain of n_pad dependent
// steps (up to 8192 on the §6.1 grid): a step's start needs its
// predecessors' finish times, written by earlier steps of the same lane.
// A step costs a few dependent memory reads (order, then the task's pred
// row, then the predecessors' finish times) at L1/L2 latency, so the kernel
// is bound by that chain's latency, not by bytes (each input byte read once
// takes microseconds at 3.35 TB/s) nor by operations (one add and one max
// per real pred slot).
//
// Design, simple and exact:
//   * One thread per (plan, seed) lane; one block of 32 threads per plan and
//     chunk of 32 seeds, the tail lanes of the last chunk masked.  The seeds
//     of one plan share a warp, so every order, pred, delay and floor read
//     is a warp-uniform broadcast.
//   * Finish times live in a global scratch laid out (B, n_pad, S): a warp's
//     finish[pred] reads and its finish[j] write each touch one 128-byte
//     line.  Each lane zeroes its own column first, as the reference starts
//     finish at zeros, so the result is the plain version's on any order
//     whose entries index the plan, topological or not (on the campaign's
//     orders every task is written before it is read anyway).
//   * Pred slots are filled from the left with -1 after the last real one
//     (sim/batch.py's _plan_arrays and from_plans), so the slot loop stops
//     at the first -1 and never walks the padding: the §6.1 fork-join joins
//     have 100-500 predecessors and P_pad reaches 501, most tasks 1-2.  A
//     masked slot adds the 0 that max's initial value already gives.
//   * The makespan is the max over the lane's whole finish column after
//     the walk, as the reference's max(finish): the zeroing and this pass
//     are n_pad independent coalesced stores and loads per lane, off the
//     chain of dependent steps.
//   * replay_sm90.cu keeps the finish times in shared memory and stages
//     the inputs off the chain; a level-parallel design (the tasks of one
//     topological level in parallel) is not done.
//
// C interface (loaded with ctypes): replay_makespans_f32 returns the
// cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int LANES = 32;      // seeds per block: one warp

__global__ void __launch_bounds__(LANES)
replay_kernel(const int* __restrict__ order, const int* __restrict__ pred,
              const float* __restrict__ delay, const float* __restrict__ floors,
              const float* __restrict__ times, float* __restrict__ finish,
              float* __restrict__ out, int n_pad, int p_pad, int s,
              int chunks) {
  const int64_t b = blockIdx.x / chunks;
  const int lane = (blockIdx.x % chunks) * LANES + threadIdx.x;
  if (lane >= s) return;
  order += b * n_pad;
  pred += b * n_pad * static_cast<int64_t>(p_pad);
  delay += b * n_pad * static_cast<int64_t>(p_pad);
  floors += b * n_pad;
  times += (b * s + lane) * static_cast<int64_t>(n_pad);
  finish += b * n_pad * static_cast<int64_t>(s) + lane;

  for (int j = 0; j < n_pad; ++j) finish[static_cast<int64_t>(j) * s] = 0.0f;
  for (int i = 0; i < n_pad; ++i) {
    const int j = order[i];
    const int* pj = pred + static_cast<int64_t>(j) * p_pad;
    const float* dj = delay + static_cast<int64_t>(j) * p_pad;
    float start = 0.0f;
    for (int k = 0; k < p_pad; ++k) {
      const int p = pj[k];
      if (p < 0) break;
      start = max_nan(start, __fadd_rn(finish[static_cast<int64_t>(p) * s], dj[k]));
    }
    start = max_nan(start, floors[j]);
    const float f = __fadd_rn(start, times[j]);
    finish[static_cast<int64_t>(j) * s] = f;
  }
  float best = finish[0];
#pragma unroll 8
  for (int j = 1; j < n_pad; ++j)
    best = max_nan(best, finish[static_cast<int64_t>(j) * s]);
  out[b * s + lane] = best;
}

}  // namespace

extern "C" int replay_makespans_f32(const int* order, const int* pred,
                                    const float* delay, const float* floors,
                                    const float* times, float* finish,
                                    float* out, int batch, int n_pad,
                                    int p_pad, int s, cudaStream_t stream) {
  if (batch <= 0 || n_pad <= 0 || p_pad <= 0 || s <= 0)
    return cudaErrorInvalidValue;
  const int chunks = (s + LANES - 1) / LANES;
  const int64_t blocks = static_cast<int64_t>(batch) * chunks;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  replay_kernel<<<static_cast<unsigned>(blocks), LANES, 0, stream>>>(
      order, pred, delay, floors, times, finish, out, n_pad, p_pad, s, chunks);
  return static_cast<int>(cudaGetLastError());
}
