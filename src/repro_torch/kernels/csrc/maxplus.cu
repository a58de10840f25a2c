// Tropical (max, +) matrix product for Hopper, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/maxplus/maxplus.py::maxplus_matmul (body _maxplus_kernel),
// and its batch: the JAX package vmaps the closure of
//   src/repro/kernels/maxplus/ops.py::batched_ranks over the lanes, here the
// lanes are blockIdx.z of one launch.
//
// It computes, for every lane z of a batch,
//   C[z, i, j] = max(NEG_INF, max_k A[z, i, k] + B[z, k, j])
// in fp32, NEG_INF = -1e30: one fp32 add rounded once per pair and an exact
// max, so the result does not depend on the order of k and equals the plain
// version (ref.maxplus_matmul_ref) bit for bit.  The NEG_INF floor is the
// TPU kernel's initial value of its output tile.  The max keeps NaN
// (max_nan, sm90_common.cuh), as jnp.maximum and torch.maximum do: a NaN
// operand gives NaN in every output it reaches.
//
// What bounds it on the H100: tensor cores cannot compute a (max, +)
// product, so every pair costs two instructions on the CUDA cores, FADD and
// FMNMX.  FADD runs on the FP32 pipe at 128 results per clock per SM;
// FMNMX (fp32 max) at 64 per clock per SM on compute capability 9.0 (the
// "compare, minimum, maximum" row of the CUDA programming guide's
// arithmetic-instruction throughput table); and a scheduler issues one warp
// instruction per clock, 128 thread instructions per SM.  Each of the three
// caps the product at 64 pairs per clock per SM: 132 SMs at the 1.98 GHz
// boost clock give 16.7e12 pairs/s, i.e. 2 * B * m * k * n instructions at
// 33.5e12 instructions/s, half the card's 67 TFLOP/s fp32 FMA rate.  The
// bytes (each input read once, the output written once: 3 * B * p^2 * 4 for
// a closure squaring) take about 2% of that time at p = 2944: operations
// bound.
//
// Design, against that bound:
//   * One thread block of 256 threads per (128 x 128 output tile, lane).
//     The k axis, a sequential grid axis on the TPU with the running max
//     kept in the output tile, is a loop inside the block, and the running
//     max lives in registers: 8 x 8 outputs per thread.
//   * Each step stages a 128 x 16 tile of A (transposed, rows padded by 4
//     floats against bank conflicts) and a 16 x 128 tile of B in shared
//     memory.  Per k a thread reads 4 float4s (its 8 rows of A and 8
//     columns of B, in two halves 64 apart so a warp's reads are
//     conflict-free) and issues 64 FADD + 64 FMNMX: 3% of the instructions
//     are loads, so the inner loop can approach the issue bound.
//   * Any m, k, n: fixed tiles, ragged edges masked.  A k element past the
//     edge is read as NEG_INF in both A and B, so its sum (-2e30) never
//     rises above the floor; rows and columns past the edge are computed and
//     not stored.
//   * Not yet done: the tile loads are not overlapped with the arithmetic
//     (no cp.async or TMA pipeline), and the tile shape is not tuned.
//
// C interface (loaded with ctypes): maxplus_matmul_f32 returns the
// cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int BM = 128;        // output rows per block
constexpr int BN = 128;        // output columns per block
constexpr int BK = 16;         // k elements per shared-memory stage
constexpr int TM = 8;          // output rows per thread
constexpr int TN = 8;          // output columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int APAD = 4;        // fp32 padding of a row of the A tile
constexpr float NEG_INF = -1e30f;

__global__ void __launch_bounds__(THREADS, 2)
maxplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ c, int m, int k, int n) {
  __shared__ __align__(16) float as[BK][BM + APAD];   // as[kk][i] = A[i, kk]
  __shared__ __align__(16) float bs[BK][BN];          // bs[kk][j] = B[kk, j]

  const int64_t lane = blockIdx.z;
  a += lane * m * static_cast<int64_t>(k);
  b += lane * k * static_cast<int64_t>(n);
  c += lane * m * static_cast<int64_t>(n);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // 0..15: column group
  const int ty = tid / (BN / TN);   // 0..15: row group

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = NEG_INF;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // A tile: 16 consecutive threads read 16 consecutive k of one row.
#pragma unroll
    for (int r = 0; r < BM * BK / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int i = e / BK, kk = e % BK;
      const int gi = row0 + i, gk = k0 + kk;
      as[kk][i] = (gi < m && gk < k) ? a[static_cast<int64_t>(gi) * k + gk]
                                     : NEG_INF;
    }
    // B tile: consecutive threads read consecutive columns of one row.
#pragma unroll
    for (int r = 0; r < BK * BN / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int kk = e / BN, j = e % BN;
      const int gk = k0 + kk, gj = col0 + j;
      bs[kk][j] = (gk < k && gj < n) ? b[static_cast<int64_t>(gk) * n + gj]
                                     : NEG_INF;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][BN / 2 + tx * 4]);
      const float ra[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = max_nan(acc[i][j], __fadd_rn(ra[i], rb[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4));
    if (gi >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = col0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4));
      if (gj < n) c[static_cast<int64_t>(gi) * n + gj] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int maxplus_matmul_f32(const float* a, const float* b, float* c,
                                  int batch, int m, int k, int n,
                                  cudaStream_t stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || k < 0) return cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  maxplus_kernel<<<grid, THREADS, 0, stream>>>(a, b, c, m, k, n);
  return static_cast<int>(cudaGetLastError());
}
