// The chunked SSD (state-space duality) scan of Mamba-2, its backward and
// the decode step, CUDA C++ for sm_90a.
//
// Replaces the reference's XLA device code for the SSM layer:
//   * scan      src/repro/models/layers.py:404-430, chunk_step under its
//               lax.scan (ssm_apply's recurrence);
//   * scan_grad jax.grad of the same;
//   * step      src/repro/models/layers.py:474-478, ssm_decode's state
//               update and readout.
// The plain versions are kernels/ssd/ref.py (scan_ref, scan_grad_ref,
// step_ref).  Shapes: dt (b, s, nh) fp32, xh (b, s, nh, hd), B and C (b, s,
// ns) in the compute dtype T (fp32 or bf16), A (nh) fp32, chunks of lc <=
// 256 steps (s a multiple of lc), hd * ns <= 8192.
//
// Numbers.  Every product of the recurrence sums in fp32 (fmaf, in k order)
// and is rounded once to T, where the plain version's einsum rounds; the
// elementwise steps round where it rounds, with __fmul_rn / __fadd_rn (no
// contraction): the scores r(cb), r((cb * exp(cums_i - cums_j)) * dt_j)
// masked to j <= i; y = r(r(intra) + r(r(C . S) * r(exp(cums_i)))); sdecay
// r(exp(seg - cums_j) * dt_j), its product with x rounded; the state update
// r(r(S * r(exp(seg))) + r(contrib)).  So the kernel agrees with the plain
// version to the order of fp32 sums.  The backward carries fp32: the
// forward's values as the forward rounded them, each rounding's cotangent
// passed straight through, each cotangent rounded once to its input's dtype
// (scan_grad_ref's definition).  step is elementwise and equals step_ref bit
// for bit in the state and the conv window; its readout sums over n in
// order.  Every sum runs in a fixed order: dB and dC are summed per head,
// then over the heads in head order; dA per (batch, chunk), then in that
// order; no float atomics, so two runs give the same bits.
//
// Design.  Chunk-parallel, as SSD's chunked form allows: each chunk's
// contribution to the state does not depend on the state.
//   scan: (1) the cumsum of dt * A over each chunk, one thread a (batch,
//   chunk, head), in order; (2) the scores C_i . B_j of each chunk, shared
//   by the heads, rounded to T; (3) each (chunk, batch, head)'s contribution
//   sum_j B_j (x) r(sdecay_j x_j), written where its state goes; (4) one
//   sequential pass over the chunks a state element, turning the
//   contributions into the states entering each chunk (saved for the
//   backward) and the final state; (5) the outputs, a block a (64 rows of
//   the chunk, chunk, batch, head): the masked scores times x and C times
//   the entering state.
//   scan_grad: (1)-(2) again; (3) each chunk's state cotangent from its
//   outputs, sum_i (dy_i r(exp(cums_i))) (x) C_i; (4) one reverse pass over
//   the chunks a (batch, head) turning those into the cotangent of each
//   chunk's state, with d(exp(seg)) reduced in a fixed tree; (5) a block a
//   64 rows: the state update's cotangents (dx, d sdecay, dB) and the
//   inter-chunk output's (d exp(cums), dC); (6) a block a 64 rows i: the
//   score cotangents' strip (64 x lc) in shared memory, row sums, dC; (7) a
//   block a 64 columns j: the strip (lc x 64), column sums, dx (the state
//   part added, rounded) and dB; (8) one thread a (batch, chunk, head): the
//   exponents' cotangents, the reverse cumsum, ddt and dA's partial; (9) the
//   heads' dB and dC and the partials of dA summed in order.  The (lc, lc)
//   fp32 scores of a chunk (256 KB at lc 256) never sit whole in shared
//   memory: (5)-(7) tile them over 64 rows or columns.
// Every product is one block-wide routine (gemm): a 64 x 64 output tile,
// 256 threads with a 4 x 4 register tile each, k staged through shared
// memory 32 at a time by functors that compute each operand on its load
// (the scores, sdecay * x, dy * exp(cums)).  fp32 FMA, no tensor cores.
//
// What bounds it on the H100: at mamba2-130m's training shape (8 x 2048,
// nh 24, hd 64, ns 128, lc 256) the scan moves ~136 MB with the saved states
// and does ~27 GFLOP (41 us at the byte rate; 0.40 ms at the fp32 FMA peak
// of 67 TFLOP/s, which is where this design sits, short of it by the
// staging); the backward ~196 MB and 55-60 GFLOP.  The products belong on
// the tensor cores (wgmma on TMA tiles, the state in registers): ROADMAP B3.
// step moves the state (read and write) and is bound by bytes.
//
// Launch: each entry launches its kernels on the caller's stream and
// returns the first CUDA error (0 on success); scratch comes from the
// caller's workspace (ssd_workspace_floats).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;        // rows and columns of a block's output tile
constexpr int KT = 32;          // the k depth staged at a time
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int MAX_CHUNK = 256;
constexpr int MAX_STATE = 8192;              // hd * ns
constexpr int PER_THREAD = MAX_STATE / THREADS;
constexpr int PAD = TILE + 1;                // a shared row, bank-skewed

enum Entry { SCAN = 0, SCAN_GRAD = 1, STEP = 2 };

using BF16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const BF16* p, size_t i) {
  return __bfloat162float(p[i]);
}
template <typename T> __device__ __forceinline__ T to_t(float v);
template <> __device__ __forceinline__ float to_t<float>(float v) { return v; }
template <> __device__ __forceinline__ BF16 to_t<BF16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and back
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<BF16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Dims {
  int b, s, nh, hd, ns, lc, nc;
};

// (batch, position) -> its row of the (b, s, ...) arrays
__device__ __forceinline__ size_t row(const Dims& d, int bb, int pos) {
  return static_cast<size_t>(bb) * d.s + pos;
}
// the (nc, b, nh, hd, ns) states and their cotangents
__device__ __forceinline__ size_t state_base(const Dims& d, int c, int bb,
                                             int h) {
  return ((static_cast<size_t>(c) * d.b + bb) * d.nh + h) * d.hd * d.ns;
}
// the per-head partials (nh, b, s, ns) of dB and dC
__device__ __forceinline__ size_t head_row(const Dims& d, int h, int bb,
                                           int pos) {
  return (static_cast<size_t>(h) * d.b + bb) * d.s + pos;
}

// The k operands staged for one step of a 64 x 64 output tile.
struct Stage {
  float a[KT][PAD];
  float b[KT][PAD];
};

// acc[r][c] += sum_{k in [k_lo, k_hi)} fa(k, m) * fb(k, n) for the
// thread's outputs m = m0 + ty + 16 r, n = n0 + tx + 16 c (m < M, n < N;
// the rest of the tile sums zeros).  AK / BK: the operand is contiguous in
// k, so the load runs k fastest.  Called by every thread of the block.
template <bool AK, bool BK, class FA, class FB>
__device__ void gemm(float (&acc)[4][4], int m0, int n0, int M, int N,
                     int k_lo, int k_hi, FA fa, FB fb, Stage& st) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = k_lo; k0 < k_hi; k0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < KT * TILE; idx += THREADS) {
      const int kk = AK ? idx % KT : idx / TILE;
      const int mm = AK ? idx / KT : idx % TILE;
      const int k = k0 + kk, m = m0 + mm;
      st.a[kk][mm] = (k < k_hi && m < M) ? fa(k, m) : 0.f;
    }
    for (int idx = tid; idx < KT * TILE; idx += THREADS) {
      const int kk = BK ? idx % KT : idx / TILE;
      const int nn = BK ? idx / KT : idx % TILE;
      const int k = k0 + kk, n = n0 + nn;
      st.b[kk][nn] = (k < k_hi && n < N) ? fb(k, n) : 0.f;
    }
    __syncthreads();
    const int kn = min(KT, k_hi - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = st.a[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = st.b[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
}

// f(r, c, m, n) for each of the thread's outputs inside (M, N)
template <class F>
__device__ void each(int m0, int n0, int M, int N, F f) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = m0 + ty + 16 * r, n = n0 + tx + 16 * c;
      if (m < M && n < N) f(r, c, m, n);
    }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// ------------------------------------------------------------- forward
// cums[b, c*lc + j, h] = sum_{k <= j} dt * A[h] over the chunk, in order
__global__ void __launch_bounds__(THREADS)
cums_kernel(const float* __restrict__ dt, const float* __restrict__ A, Dims d,
            float* __restrict__ cums) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= d.b * d.nc * d.nh) return;
  const int h = idx % d.nh, c = (idx / d.nh) % d.nc, bb = idx / (d.nh * d.nc);
  const float a = A[h];
  float acc = 0.f;
  for (int j = 0; j < d.lc; ++j) {
    const size_t v = row(d, bb, c * d.lc + j) * d.nh + h;
    acc = __fadd_rn(acc, __fmul_rn(dt[v], a));
    cums[v] = acc;
  }
}

// cb[c, b, i, j] = r(sum_n C[i, n] B[j, n]) for j <= i's tiles; a block a
// 64 x 64 tile of a chunk's (lc, lc)
template <typename T>
__global__ void __launch_bounds__(THREADS)
cb_kernel(const T* __restrict__ C, const T* __restrict__ B, Dims d,
          T* __restrict__ cb) {
  __shared__ Stage st;
  const int tiles = (d.lc + TILE - 1) / TILE;
  const int i0 = (blockIdx.x / tiles) * TILE, j0 = (blockIdx.x % tiles) * TILE;
  if (j0 > i0) return;                    // wholly above the diagonal
  const int c = blockIdx.y, bb = blockIdx.z;
  const size_t r0 = row(d, bb, c * d.lc);
  float acc[4][4];
  zero(acc);
  gemm<true, true>(
      acc, i0, j0, d.lc, d.lc, 0, d.ns,
      [&](int n, int i) { return ld(C, (r0 + i) * d.ns + n); },
      [&](int n, int j) { return ld(B, (r0 + j) * d.ns + n); }, st);
  T* out = cb + (static_cast<size_t>(c) * d.b + bb) * d.lc * d.lc;
  each(i0, j0, d.lc, d.lc, [&](int r, int q, int i, int j) {
    out[static_cast<size_t>(i) * d.lc + j] = to_t<T>(acc[r][q]);
  });
}

// states[c, b, h] = r(sum_j B_j (x) r(sdecay_j * x_j)), the chunk's
// contribution; a block a (chunk, batch, head)
template <typename T>
__global__ void __launch_bounds__(THREADS)
contrib_kernel(const float* __restrict__ dt, const T* __restrict__ X,
               const T* __restrict__ B, const float* __restrict__ cums,
               Dims d, T* __restrict__ states) {
  __shared__ Stage st;
  __shared__ float sd[MAX_CHUNK];
  const int c = blockIdx.x, bb = blockIdx.y, h = blockIdx.z;
  const size_t r0 = row(d, bb, c * d.lc);
  const float seg = cums[(r0 + d.lc - 1) * d.nh + h];
  for (int j = threadIdx.x; j < d.lc; j += THREADS) {
    const size_t v = (r0 + j) * d.nh + h;
    sd[j] = rnd<T>(__fmul_rn(expf(seg - cums[v]), dt[v]));
  }
  __syncthreads();
  T* out = states + state_base(d, c, bb, h);
  for (int p0 = 0; p0 < d.hd; p0 += TILE)
    for (int n0 = 0; n0 < d.ns; n0 += TILE) {
      float acc[4][4];
      zero(acc);
      gemm<false, false>(
          acc, p0, n0, d.hd, d.ns, 0, d.lc,
          [&](int j, int p) {
            return rnd<T>(__fmul_rn(
                sd[j], ld(X, ((r0 + j) * d.nh + h) * d.hd + p)));
          },
          [&](int j, int n) { return ld(B, (r0 + j) * d.ns + n); }, st);
      each(p0, n0, d.hd, d.ns, [&](int r, int q, int p, int n) {
        out[static_cast<size_t>(p) * d.ns + n] = to_t<T>(acc[r][q]);
      });
    }
}

// The sequential pass: each state element over the chunks, the chunk's
// contribution read where the entering state is written.
template <typename T>
__global__ void __launch_bounds__(THREADS)
states_kernel(const float* __restrict__ cums, Dims d, T* __restrict__ states,
              T* __restrict__ final_state) {
  const int hn = d.hd * d.ns;
  const size_t idx = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= static_cast<size_t>(d.b) * d.nh * hn) return;
  const int e = static_cast<int>(idx % hn);
  const int bh = static_cast<int>(idx / hn), h = bh % d.nh, bb = bh / d.nh;
  float sv = 0.f;
  for (int c = 0; c < d.nc; ++c) {
    const size_t at = state_base(d, c, bb, h) + e;
    const float contrib = ld(states, at);
    states[at] = to_t<T>(sv);
    const float g =
        rnd<T>(expf(cums[row(d, bb, c * d.lc + d.lc - 1) * d.nh + h]));
    sv = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(sv, g)), contrib));
  }
  final_state[static_cast<size_t>(bh) * hn + e] = to_t<T>(sv);
}

// y for 64 rows of a chunk of one (batch, head): the masked scores times x,
// plus C times the entering state times r(exp(cums_i))
template <typename T>
__global__ void __launch_bounds__(THREADS)
out_kernel(const float* __restrict__ dt, const T* __restrict__ X,
           const T* __restrict__ C, const float* __restrict__ cums,
           const T* __restrict__ cb, const T* __restrict__ states, Dims d,
           T* __restrict__ y) {
  __shared__ Stage st;
  __shared__ float cu[MAX_CHUNK], dts[MAX_CHUNK];
  const int i0 = blockIdx.x * TILE, c = blockIdx.y;
  const int bb = blockIdx.z / d.nh, h = blockIdx.z % d.nh;
  const size_t r0 = row(d, bb, c * d.lc);
  for (int j = threadIdx.x; j < d.lc; j += THREADS) {
    cu[j] = cums[(r0 + j) * d.nh + h];
    dts[j] = dt[(r0 + j) * d.nh + h];
  }
  __syncthreads();
  const T* cbc = cb + (static_cast<size_t>(c) * d.b + bb) * d.lc * d.lc;
  const T* S = states + state_base(d, c, bb, h);
  const int kmax = min(d.lc, i0 + TILE);
  for (int p0 = 0; p0 < d.hd; p0 += TILE) {
    float a1[4][4], a2[4][4];
    zero(a1);
    zero(a2);
    gemm<true, false>(
        a1, i0, p0, d.lc, d.hd, 0, kmax,
        [&](int j, int i) {
          return j <= i
                     ? rnd<T>(__fmul_rn(
                           __fmul_rn(ld(cbc, static_cast<size_t>(i) * d.lc + j),
                                     expf(cu[i] - cu[j])),
                           dts[j]))
                     : 0.f;
        },
        [&](int j, int p) { return ld(X, ((r0 + j) * d.nh + h) * d.hd + p); },
        st);
    gemm<true, true>(
        a2, i0, p0, d.lc, d.hd, 0, d.ns,
        [&](int n, int i) { return ld(C, (r0 + i) * d.ns + n); },
        [&](int n, int p) { return ld(S, static_cast<size_t>(p) * d.ns + n); },
        st);
    each(i0, p0, d.lc, d.hd, [&](int r, int q, int i, int p) {
      const float e = rnd<T>(expf(cu[i]));
      const float v = __fadd_rn(rnd<T>(a1[r][q]),
                                rnd<T>(__fmul_rn(rnd<T>(a2[r][q]), e)));
      y[((r0 + i) * d.nh + h) * d.hd + p] = to_t<T>(v);
    });
  }
}

// ------------------------------------------------------------ backward
// gs[c, b, h] = sum_i (dy_i * r(exp(cums_i))) (x) C_i: the cotangent the
// chunk's outputs give the state entering it
template <typename T>
__global__ void __launch_bounds__(THREADS)
w_kernel(const T* __restrict__ dy, const T* __restrict__ C,
         const float* __restrict__ cums, Dims d, float* __restrict__ gs) {
  __shared__ Stage st;
  __shared__ float ef[MAX_CHUNK];
  const int c = blockIdx.x, bb = blockIdx.y, h = blockIdx.z;
  const size_t r0 = row(d, bb, c * d.lc);
  for (int i = threadIdx.x; i < d.lc; i += THREADS)
    ef[i] = rnd<T>(expf(cums[(r0 + i) * d.nh + h]));
  __syncthreads();
  float* out = gs + state_base(d, c, bb, h);
  for (int p0 = 0; p0 < d.hd; p0 += TILE)
    for (int n0 = 0; n0 < d.ns; n0 += TILE) {
      float acc[4][4];
      zero(acc);
      gemm<false, false>(
          acc, p0, n0, d.hd, d.ns, 0, d.lc,
          [&](int i, int p) {
            return __fmul_rn(ld(dy, ((r0 + i) * d.nh + h) * d.hd + p), ef[i]);
          },
          [&](int i, int n) { return ld(C, (r0 + i) * d.ns + n); }, st);
      each(p0, n0, d.hd, d.ns, [&](int r, int q, int p, int n) {
        out[static_cast<size_t>(p) * d.ns + n] = acc[r][q];
      });
    }
}

// The reverse pass of a (batch, head): g, the cotangent of the state after
// chunk c, replaces gs[c]; dG[c] = sum g * S_c in a fixed tree; the
// cotangent after chunk c - 1 is g * r(exp(seg_c)) + gs[c].
template <typename T>
__global__ void __launch_bounds__(THREADS)
reverse_kernel(const T* __restrict__ states, const T* __restrict__ dfinal,
               const float* __restrict__ cums, Dims d, float* __restrict__ gs,
               float* __restrict__ dG) {
  __shared__ float red[THREADS];
  const int tid = threadIdx.x, bh = blockIdx.x, bb = bh / d.nh, h = bh % d.nh;
  const int hn = d.hd * d.ns;
  float g[PER_THREAD];
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int e = tid + q * THREADS;
    g[q] = (e < hn && dfinal != nullptr)
               ? ld(dfinal, static_cast<size_t>(bh) * hn + e)
               : 0.f;
  }
  for (int c = d.nc - 1; c >= 0; --c) {
    const size_t base = state_base(d, c, bb, h);
    const float gr =
        rnd<T>(expf(cums[row(d, bb, c * d.lc + d.lc - 1) * d.nh + h]));
    float part = 0.f;
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int e = tid + q * THREADS;
      if (e < hn) {
        const float w = gs[base + e];
        gs[base + e] = g[q];
        part = fmaf(g[q], ld(states, base + e), part);
        g[q] = __fadd_rn(__fmul_rn(g[q], gr), w);
      }
    }
    red[tid] = part;
    __syncthreads();
    for (int half = THREADS / 2; half > 0; half >>= 1) {
      if (tid < half) red[tid] = __fadd_rn(red[tid], red[tid + half]);
      __syncthreads();
    }
    if (tid == 0) dG[(static_cast<size_t>(c) * d.b + bb) * d.nh + h] = red[0];
    __syncthreads();
  }
}

// The per-position vectors of the backward, (b, s, nh) fp32 each.
struct Vecs {
  float *dsd, *dE, *rowsum, *colsum, *ddti;
};

// 64 rows j of a chunk of one (batch, head): the state update's cotangents
// (dx's state part, d sdecay, dB's state part) and the inter-chunk
// output's (d exp(cums), dC's inter part)
template <typename T>
__global__ void __launch_bounds__(THREADS)
state_grad_kernel(const float* __restrict__ dt, const T* __restrict__ X,
                  const T* __restrict__ B, const T* __restrict__ C,
                  const T* __restrict__ dy, const T* __restrict__ states,
                  const float* __restrict__ gs,
                  const float* __restrict__ cums, Dims d, Vecs vec,
                  float* __restrict__ dxs, float* __restrict__ dBh,
                  float* __restrict__ dCh) {
  __shared__ Stage st;
  __shared__ float buf[TILE][PAD];
  __shared__ float sdr[TILE], ef[TILE], racc[TILE];
  const int tid = threadIdx.x, j0 = blockIdx.x * TILE, c = blockIdx.y;
  const int bb = blockIdx.z / d.nh, h = blockIdx.z % d.nh;
  const int rows = min(TILE, d.lc - j0);
  const size_t r0 = row(d, bb, c * d.lc);
  const float seg = cums[(r0 + d.lc - 1) * d.nh + h];
  if (tid < rows) {
    const size_t v = (r0 + j0 + tid) * d.nh + h;
    sdr[tid] = rnd<T>(__fmul_rn(expf(seg - cums[v]), dt[v]));
    ef[tid] = rnd<T>(expf(cums[v]));
    racc[tid] = 0.f;
  }
  __syncthreads();
  const float* G = gs + state_base(d, c, bb, h);
  const T* S = states + state_base(d, c, bb, h);
  auto x_at = [&](int j, int p) {
    return ld(X, ((r0 + j) * d.nh + h) * d.hd + p);
  };
  auto dy_at = [&](int i, int p) {
    return ld(dy, ((r0 + i) * d.nh + h) * d.hd + p);
  };
  auto row_sums = [&](int width) {     // racc += the rows of buf, in order
    __syncthreads();
    if (tid < rows) {
      float sum = racc[tid];
      for (int q = 0; q < width; ++q) sum = __fadd_rn(sum, buf[tid][q]);
      racc[tid] = sum;
    }
    __syncthreads();
  };
  float acc[4][4];
  // dU = B . g^T; dx's state part sdecay * dU; d sdecay = sum_p x * dU
  for (int p0 = 0; p0 < d.hd; p0 += TILE) {
    zero(acc);
    gemm<true, true>(
        acc, j0, p0, d.lc, d.hd, 0, d.ns,
        [&](int n, int j) { return ld(B, (r0 + j) * d.ns + n); },
        [&](int n, int p) { return G[static_cast<size_t>(p) * d.ns + n]; },
        st);
    each(j0, p0, d.lc, d.hd, [&](int r, int q, int j, int p) {
      dxs[((r0 + j) * d.nh + h) * d.hd + p] = __fmul_rn(sdr[j - j0], acc[r][q]);
      buf[j - j0][p - p0] = __fmul_rn(x_at(j, p), acc[r][q]);
    });
    row_sums(min(TILE, d.hd - p0));
  }
  if (tid < rows) {
    vec.dsd[(r0 + j0 + tid) * d.nh + h] = racc[tid];
    racc[tid] = 0.f;
  }
  // dB's state part: U . g, U = r(sdecay * x)
  for (int n0 = 0; n0 < d.ns; n0 += TILE) {
    zero(acc);
    gemm<true, false>(
        acc, j0, n0, d.lc, d.ns, 0, d.hd,
        [&](int p, int j) {
          return rnd<T>(__fmul_rn(sdr[j - j0], x_at(j, p)));
        },
        [&](int p, int n) { return G[static_cast<size_t>(p) * d.ns + n]; },
        st);
    each(j0, n0, d.lc, d.ns, [&](int r, int q, int j, int n) {
      dBh[head_row(d, h, bb, c * d.lc + j) * d.ns + n] = acc[r][q];
    });
  }
  // Q = r(C . S^T); d exp(cums_i) = sum_p dy * Q
  for (int p0 = 0; p0 < d.hd; p0 += TILE) {
    zero(acc);
    gemm<true, true>(
        acc, j0, p0, d.lc, d.hd, 0, d.ns,
        [&](int n, int i) { return ld(C, (r0 + i) * d.ns + n); },
        [&](int n, int p) { return ld(S, static_cast<size_t>(p) * d.ns + n); },
        st);
    each(j0, p0, d.lc, d.hd, [&](int r, int q, int i, int p) {
      buf[i - j0][p - p0] = __fmul_rn(dy_at(i, p), rnd<T>(acc[r][q]));
    });
    row_sums(min(TILE, d.hd - p0));
  }
  if (tid < rows) vec.dE[(r0 + j0 + tid) * d.nh + h] = racc[tid];
  // dC's inter part: (dy * r(exp(cums))) . S
  for (int n0 = 0; n0 < d.ns; n0 += TILE) {
    zero(acc);
    gemm<true, false>(
        acc, j0, n0, d.lc, d.ns, 0, d.hd,
        [&](int p, int i) { return __fmul_rn(dy_at(i, p), ef[i - j0]); },
        [&](int p, int n) { return ld(S, static_cast<size_t>(p) * d.ns + n); },
        st);
    each(j0, n0, d.lc, d.ns, [&](int r, int q, int i, int n) {
      dCh[head_row(d, h, bb, c * d.lc + i) * d.ns + n] = acc[r][q];
    });
  }
}

// The score at (i, j <= i): (cb * exp(cums_i - cums_j)) * dt_j, and the
// parts of its cotangent from dL: dcb, d(cums_i - cums_j), d dt_j.
struct Score {
  float L, dcb, dexp, ddt;
};
__device__ __forceinline__ Score score(float cbv, float ci, float cj,
                                       float dtj, float dl) {
  const float e = expf(ci - cj);
  Score s;
  s.L = __fmul_rn(__fmul_rn(cbv, e), dtj);
  s.dcb = __fmul_rn(__fmul_rn(dl, e), dtj);
  s.dexp = __fmul_rn(dl, s.L);
  s.ddt = __fmul_rn(__fmul_rn(dl, cbv), e);
  return s;
}

// 64 rows i of a chunk of one (batch, head): the strip dL[i, :] = dy_i . x_j
// (j <= i) in shared memory as dcb, the row sums of d(cums_i - cums_j), and
// dC's intra part dcb . B added to dCh.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const float* __restrict__ dt, const T* __restrict__ X,
            const T* __restrict__ B, const T* __restrict__ dy,
            const float* __restrict__ cums, const T* __restrict__ cb, Dims d,
            Vecs vec, float* __restrict__ dCh) {
  extern __shared__ float strip[];         // [TILE][lc + 1]
  __shared__ Stage st;
  __shared__ float buf[TILE][PAD];
  __shared__ float cu[MAX_CHUNK], dts[MAX_CHUNK], racc[TILE];
  const int tid = threadIdx.x, i0 = blockIdx.x * TILE, c = blockIdx.y;
  const int bb = blockIdx.z / d.nh, h = blockIdx.z % d.nh;
  const int rows = min(TILE, d.lc - i0), sld = d.lc + 1;
  const size_t r0 = row(d, bb, c * d.lc);
  for (int j = tid; j < d.lc; j += THREADS) {
    cu[j] = cums[(r0 + j) * d.nh + h];
    dts[j] = dt[(r0 + j) * d.nh + h];
  }
  if (tid < TILE) racc[tid] = 0.f;
  __syncthreads();
  const T* cbc = cb + (static_cast<size_t>(c) * d.b + bb) * d.lc * d.lc;
  const int kmax = min(d.lc, i0 + TILE);
  float acc[4][4];
  for (int j0 = 0; j0 < kmax; j0 += TILE) {
    zero(acc);
    gemm<true, true>(
        acc, i0, j0, d.lc, kmax, 0, d.hd,
        [&](int p, int i) { return ld(dy, ((r0 + i) * d.nh + h) * d.hd + p); },
        [&](int p, int j) { return ld(X, ((r0 + j) * d.nh + h) * d.hd + p); },
        st);
    each(i0, j0, d.lc, kmax, [&](int r, int q, int i, int j) {
      float dcb = 0.f, dexp = 0.f;
      if (j <= i) {
        const Score s = score(ld(cbc, static_cast<size_t>(i) * d.lc + j),
                              cu[i], cu[j], dts[j], acc[r][q]);
        dcb = s.dcb;
        dexp = s.dexp;
      }
      strip[(i - i0) * sld + j] = dcb;
      buf[i - i0][j - j0] = dexp;
    });
    __syncthreads();
    if (tid < rows) {
      float sum = racc[tid];
      const int width = min(TILE, kmax - j0);
      for (int q = 0; q < width; ++q) sum = __fadd_rn(sum, buf[tid][q]);
      racc[tid] = sum;
    }
    __syncthreads();
  }
  if (tid < rows) vec.rowsum[(r0 + i0 + tid) * d.nh + h] = racc[tid];
  for (int n0 = 0; n0 < d.ns; n0 += TILE) {
    zero(acc);
    gemm<true, false>(
        acc, i0, n0, d.lc, d.ns, 0, kmax,
        [&](int j, int i) { return strip[(i - i0) * sld + j]; },
        [&](int j, int n) { return ld(B, (r0 + j) * d.ns + n); }, st);
    each(i0, n0, d.lc, d.ns, [&](int r, int q, int i, int n) {
      const size_t at = head_row(d, h, bb, c * d.lc + i) * d.ns + n;
      dCh[at] = __fadd_rn(dCh[at], acc[r][q]);
    });
  }
}

// 64 columns j of a chunk of one (batch, head): the strip dL[:, j] (i >= j)
// as dcb, the column sums of d(cums_i - cums_j) and of dt_j's score part,
// dx = its state part + r(L)^T . dy (rounded to T), and dB's intra part
// dcb^T . C added to dBh.
template <typename T>
__global__ void __launch_bounds__(THREADS)
cols_kernel(const float* __restrict__ dt, const T* __restrict__ X,
            const T* __restrict__ C, const T* __restrict__ dy,
            const float* __restrict__ cums, const T* __restrict__ cb,
            const float* __restrict__ dxs, Dims d, Vecs vec,
            T* __restrict__ dxh, float* __restrict__ dBh) {
  extern __shared__ float dyn[];
  float* strip = dyn;                        // [lc][PAD]
  float* b1 = strip + d.lc * PAD;            // [TILE][PAD]
  float* b2 = b1 + TILE * PAD;               // [TILE][PAD]
  __shared__ Stage st;
  __shared__ float cu[MAX_CHUNK], dts[MAX_CHUNK], c1[TILE], c2[TILE];
  const int tid = threadIdx.x, j0 = blockIdx.x * TILE, c = blockIdx.y;
  const int bb = blockIdx.z / d.nh, h = blockIdx.z % d.nh;
  const int cols = min(TILE, d.lc - j0), jend = j0 + cols;
  const size_t r0 = row(d, bb, c * d.lc);
  for (int j = tid; j < d.lc; j += THREADS) {
    cu[j] = cums[(r0 + j) * d.nh + h];
    dts[j] = dt[(r0 + j) * d.nh + h];
  }
  if (tid < TILE) c1[tid] = c2[tid] = 0.f;
  __syncthreads();
  const T* cbc = cb + (static_cast<size_t>(c) * d.b + bb) * d.lc * d.lc;
  float acc[4][4];
  for (int i0 = j0; i0 < d.lc; i0 += TILE) {
    zero(acc);
    gemm<true, true>(
        acc, i0, j0, d.lc, jend, 0, d.hd,
        [&](int p, int i) { return ld(dy, ((r0 + i) * d.nh + h) * d.hd + p); },
        [&](int p, int j) { return ld(X, ((r0 + j) * d.nh + h) * d.hd + p); },
        st);
    each(i0, j0, d.lc, jend, [&](int r, int q, int i, int j) {
      float dcb = 0.f, dexp = 0.f, ddt = 0.f;
      if (j <= i) {
        const Score s = score(ld(cbc, static_cast<size_t>(i) * d.lc + j),
                              cu[i], cu[j], dts[j], acc[r][q]);
        dcb = s.dcb;
        dexp = s.dexp;
        ddt = s.ddt;
      }
      strip[i * PAD + (j - j0)] = dcb;
      b1[(i - i0) * PAD + (j - j0)] = dexp;
      b2[(i - i0) * PAD + (j - j0)] = ddt;
    });
    __syncthreads();
    if (tid < cols) {
      float s1 = c1[tid], s2 = c2[tid];
      const int height = min(TILE, d.lc - i0);
      for (int r = 0; r < height; ++r) {
        s1 = __fadd_rn(s1, b1[r * PAD + tid]);
        s2 = __fadd_rn(s2, b2[r * PAD + tid]);
      }
      c1[tid] = s1;
      c2[tid] = s2;
    }
    __syncthreads();
  }
  if (tid < cols) {
    vec.colsum[(r0 + j0 + tid) * d.nh + h] = c1[tid];
    vec.ddti[(r0 + j0 + tid) * d.nh + h] = c2[tid];
  }
  // dx = its state part + r(L)^T . dy
  for (int p0 = 0; p0 < d.hd; p0 += TILE) {
    zero(acc);
    gemm<false, false>(
        acc, j0, p0, jend, d.hd, j0, d.lc,
        [&](int i, int j) {
          return i >= j
                     ? rnd<T>(__fmul_rn(
                           __fmul_rn(ld(cbc, static_cast<size_t>(i) * d.lc + j),
                                     expf(cu[i] - cu[j])),
                           dts[j]))
                     : 0.f;
        },
        [&](int i, int p) { return ld(dy, ((r0 + i) * d.nh + h) * d.hd + p); },
        st);
    each(j0, p0, jend, d.hd, [&](int r, int q, int j, int p) {
      const size_t at = ((r0 + j) * d.nh + h) * d.hd + p;
      dxh[at] = to_t<T>(__fadd_rn(dxs[at], acc[r][q]));
    });
  }
  // dB's intra part: dcb^T . C
  for (int n0 = 0; n0 < d.ns; n0 += TILE) {
    zero(acc);
    gemm<false, false>(
        acc, j0, n0, jend, d.ns, j0, d.lc,
        [&](int i, int j) { return strip[i * PAD + (j - j0)]; },
        [&](int i, int n) { return ld(C, (r0 + i) * d.ns + n); }, st);
    each(j0, n0, jend, d.ns, [&](int r, int q, int j, int n) {
      const size_t at = head_row(d, h, bb, c * d.lc + j) * d.ns + n;
      dBh[at] = __fadd_rn(dBh[at], acc[r][q]);
    });
  }
}

// One thread a (batch, chunk, head): the exponents' cotangents, cums' (a
// reverse cumsum, in order) into ddt and dA's partial.
__global__ void __launch_bounds__(THREADS)
finish_kernel(const float* __restrict__ dt, const float* __restrict__ A,
              const float* __restrict__ cums, const float* __restrict__ dG,
              Dims d, Vecs vec, float* __restrict__ ddt,
              float* __restrict__ da_part) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= d.b * d.nc * d.nh) return;
  const int h = idx % d.nh, c = (idx / d.nh) % d.nc, bb = idx / (d.nh * d.nc);
  const size_t r0 = row(d, bb, c * d.lc);
  const float seg = cums[(r0 + d.lc - 1) * d.nh + h], a = A[h];
  float sum = 0.f;
  for (int j = 0; j < d.lc; ++j) {
    const size_t v = (r0 + j) * d.nh + h;
    sum = fmaf(vec.dsd[v], __fmul_rn(expf(seg - cums[v]), dt[v]), sum);
  }
  const float dseg =
      __fadd_rn(__fmul_rn(dG[(static_cast<size_t>(c) * d.b + bb) * d.nh + h],
                          expf(seg)),
                sum);
  float da = 0.f, dA = 0.f;
  for (int i = d.lc - 1; i >= 0; --i) {
    const size_t v = (r0 + i) * d.nh + h;
    const float e = expf(seg - cums[v]);
    float dc = __fsub_rn(vec.rowsum[v], vec.colsum[v]);
    dc = __fadd_rn(dc, __fmul_rn(vec.dE[v], expf(cums[v])));
    dc = __fsub_rn(dc, __fmul_rn(vec.dsd[v], __fmul_rn(e, dt[v])));
    if (i == d.lc - 1) dc = __fadd_rn(dc, dseg);
    da = __fadd_rn(da, dc);
    ddt[v] = __fadd_rn(__fadd_rn(vec.ddti[v], __fmul_rn(vec.dsd[v], e)),
                       __fmul_rn(da, a));
    dA = fmaf(da, dt[v], dA);
  }
  da_part[(static_cast<size_t>(bb) * d.nc + c) * d.nh + h] = dA;
}

// dB, dC: the heads' partials summed in head order, rounded to T; dA: the
// (batch, chunk) partials summed in that order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ dBh, const float* __restrict__ dCh,
              const float* __restrict__ da_part, Dims d, T* __restrict__ dB,
              T* __restrict__ dC, float* __restrict__ dA) {
  const size_t n_e = static_cast<size_t>(d.b) * d.s * d.ns;
  const size_t e = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (e < n_e) {
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < d.nh; ++h) {
      sb = __fadd_rn(sb, dBh[h * n_e + e]);
      sc = __fadd_rn(sc, dCh[h * n_e + e]);
    }
    dB[e] = to_t<T>(sb);
    dC[e] = to_t<T>(sc);
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < d.nh; h += THREADS) {
      float s = 0.f;
      for (int bc = 0; bc < d.b * d.nc; ++bc)
        s = __fadd_rn(s, da_part[static_cast<size_t>(bc) * d.nh + h]);
      dA[h] = s;
    }
}

// --------------------------------------------------------------- step
// One decode step of a (batch, head): the state in place, the readout in
// order over n; the blocks share the conv window's shift.
template <typename T>
__global__ void __launch_bounds__(THREADS)
step_kernel(T* __restrict__ state, T* __restrict__ conv,
            const T* __restrict__ window, const T* __restrict__ xh,
            const float* __restrict__ dtv, const float* __restrict__ A,
            const T* __restrict__ Bv, const T* __restrict__ Cv, int nh,
            int hd, int ns, int conv_rows, int width, int batch,
            T* __restrict__ y) {
  __shared__ float prod[MAX_STATE];
  const int tid = threadIdx.x, bh = blockIdx.x, bb = bh / nh, h = bh % nh;
  const int hn = hd * ns;
  const float dv = dtv[bh];
  const float da = rnd<T>(expf(__fmul_rn(dv, A[h])));
  const float dtr = rnd<T>(dv);
  T* sp = state + static_cast<size_t>(bh) * hn;
  for (int e = tid; e < hn; e += THREADS) {
    const int p = e / ns, n = e % ns;
    const float xd =
        rnd<T>(__fmul_rn(ld(xh, static_cast<size_t>(bh) * hd + p), dtr));
    const float u =
        rnd<T>(__fmul_rn(xd, ld(Bv, static_cast<size_t>(bb) * ns + n)));
    const float sn = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(ld(sp, e), da)), u));
    sp[e] = to_t<T>(sn);
    prod[e] = __fmul_rn(ld(Cv, static_cast<size_t>(bb) * ns + n), sn);
  }
  __syncthreads();
  for (int p = tid; p < hd; p += THREADS) {
    float acc = 0.f;
    for (int n = 0; n < ns; ++n) acc = __fadd_rn(acc, prod[p * ns + n]);
    y[static_cast<size_t>(bh) * hd + p] = to_t<T>(acc);
  }
  const size_t per = static_cast<size_t>(conv_rows) * width;
  const size_t total = per * batch;
  for (size_t e = static_cast<size_t>(blockIdx.x) * THREADS + tid; e < total;
       e += static_cast<size_t>(gridDim.x) * THREADS) {
    const size_t b2 = e / per, rest = e % per;
    conv[e] = window[b2 * (per + width) + width + rest];
  }
}

__global__ void empty_kernel(int) {}

// ------------------------------------------------------------ launches
struct Launch {
  dim3 grid;
  size_t smem;      // dynamic shared memory
};

int div_up(int a, int b) { return (a + b - 1) / b; }

bool bad(const Dims& d, int dtype) {
  return d.b < 1 || d.nh < 1 || d.hd < 1 || d.ns < 1 || d.lc < 1 ||
         d.lc > MAX_CHUNK || d.s < d.lc || d.s % d.lc != 0 ||
         d.hd * d.ns > MAX_STATE || (dtype != 0 && dtype != 1);
}

size_t elem(int dtype) { return dtype == 1 ? 2 : 4; }
size_t up4(size_t floats) { return (floats + 3) / 4 * 4; }

// The workspace of an entry in floats, carved in this order:
// scan: cums, cb; scan_grad: cums, cb, gs, dG, the five vectors, dxs, dBh,
// dCh, da_part.
struct Work {
  float *cums, *cb, *gs, *dG, *vec, *dxs, *dBh, *dCh, *da_part;
  size_t floats;
};

Work carve(const Dims& d, int dtype, int entry, float* base) {
  const size_t n1 = static_cast<size_t>(d.b) * d.s * d.nh;
  const size_t hn = static_cast<size_t>(d.hd) * d.ns;
  const size_t sizes[9] = {
      up4(n1),
      up4((static_cast<size_t>(d.nc) * d.b * d.lc * d.lc * elem(dtype) + 3) /
          4),
      up4(static_cast<size_t>(d.nc) * d.b * d.nh * hn),
      up4(static_cast<size_t>(d.nc) * d.b * d.nh),
      up4(5 * n1),
      up4(n1 * d.hd),
      up4(static_cast<size_t>(d.nh) * d.b * d.s * d.ns),
      up4(static_cast<size_t>(d.nh) * d.b * d.s * d.ns),
      up4(static_cast<size_t>(d.b) * d.nc * d.nh)};
  const int used = entry == SCAN ? 2 : 9;
  float* p[9] = {};
  size_t at = 0;
  for (int k = 0; k < used; ++k) {
    p[k] = base == nullptr ? nullptr : base + at;
    at += sizes[k];
  }
  return Work{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], at};
}

size_t rows_smem(const Dims& d) { return sizeof(float) * TILE * (d.lc + 1); }
size_t cols_smem(const Dims& d) {
  return sizeof(float) * (static_cast<size_t>(d.lc) * PAD + 2 * TILE * PAD);
}

// The launches of an entry, in order: each kernel's grid and dynamic
// shared memory (the block is THREADS).
int launches(int entry, const Dims& d, int batch_heads, Launch* out) {
  const int t = div_up(d.lc, TILE);
  const dim3 per_thread_chunk(div_up(d.b * d.nc * d.nh, THREADS));
  const dim3 cb_grid(t * t, d.nc, d.b);
  const dim3 rows_grid(t, d.nc, d.b * d.nh);
  if (entry == SCAN) {
    const size_t hn = static_cast<size_t>(d.hd) * d.ns;
    out[0] = {per_thread_chunk, 0};
    out[1] = {cb_grid, 0};
    out[2] = {dim3(d.nc, d.b, d.nh), 0};
    out[3] = {dim3(static_cast<unsigned>(
                  (static_cast<size_t>(d.b) * d.nh * hn + THREADS - 1) /
                  THREADS)),
              0};
    out[4] = {rows_grid, 0};
    return 5;
  }
  if (entry == SCAN_GRAD) {
    out[0] = {per_thread_chunk, 0};
    out[1] = {cb_grid, 0};
    out[2] = {dim3(d.nc, d.b, d.nh), 0};
    out[3] = {dim3(d.b * d.nh), 0};
    out[4] = {rows_grid, 0};
    out[5] = {rows_grid, rows_smem(d)};
    out[6] = {rows_grid, cols_smem(d)};
    out[7] = {per_thread_chunk, 0};
    out[8] = {dim3(static_cast<unsigned>(
                  (static_cast<size_t>(d.b) * d.s * d.ns + THREADS - 1) /
                  THREADS)),
              0};
    return 9;
  }
  out[0] = {dim3(batch_heads), 0};
  return 1;
}

#define SSD_CHECK(expr)         \
  do {                          \
    const int err_ = (expr);    \
    if (err_ != 0) return err_; \
  } while (0)

// The dynamic shared memory a kernel may take, opted in (static and
// dynamic together pass 48 KB) once per card at the largest chunk, so no
// attribute call falls inside a CUDA graph's capture.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

constexpr int MAX_CARDS = 64;

template <typename T>
int prepare() {
  static bool done[MAX_CARDS] = {};
  int dev = 0;
  SSD_CHECK(static_cast<int>(cudaGetDevice(&dev)));
  if (dev < 0 || dev >= MAX_CARDS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (done[dev]) return 0;
  const Dims most{1, MAX_CHUNK, 1, 1, 1, MAX_CHUNK, 1};
  SSD_CHECK(allow_smem(rows_kernel<T>, rows_smem(most)));
  SSD_CHECK(allow_smem(cols_kernel<T>, cols_smem(most)));
  SSD_CHECK(allow_smem(empty_kernel, cols_smem(most)));
  done[dev] = true;
  return 0;
}

int last_error() { return static_cast<int>(cudaGetLastError()); }


template <typename T>
int scan_impl(const float* dt, const T* xh, const T* B, const T* C,
              const float* A, const Dims& d, const Work& w, T* y,
              T* final_state, T* states, cudaStream_t stream) {
  Launch g[9];
  launches(SCAN, d, 0, g);
  T* cb = reinterpret_cast<T*>(w.cb);
  cums_kernel<<<g[0].grid, THREADS, 0, stream>>>(dt, A, d, w.cums);
  SSD_CHECK(last_error());
  cb_kernel<T><<<g[1].grid, THREADS, 0, stream>>>(C, B, d, cb);
  SSD_CHECK(last_error());
  contrib_kernel<T><<<g[2].grid, THREADS, 0, stream>>>(dt, xh, B, w.cums, d,
                                                       states);
  SSD_CHECK(last_error());
  states_kernel<T><<<g[3].grid, THREADS, 0, stream>>>(w.cums, d, states,
                                                      final_state);
  SSD_CHECK(last_error());
  out_kernel<T><<<g[4].grid, THREADS, 0, stream>>>(dt, xh, C, w.cums, cb,
                                                   states, d, y);
  return last_error();
}

template <typename T>
int scan_grad_impl(const float* dt, const T* xh, const T* B, const T* C,
                   const float* A, const T* states, const T* dy,
                   const T* dfinal, const Dims& d, const Work& w, T* dxh,
                   float* ddt, T* dB, T* dC, float* dA, cudaStream_t stream) {
  Launch g[9];
  launches(SCAN_GRAD, d, 0, g);
  T* cb = reinterpret_cast<T*>(w.cb);
  const size_t n1 = static_cast<size_t>(d.b) * d.s * d.nh;
  const Vecs vec{w.vec, w.vec + n1, w.vec + 2 * n1, w.vec + 3 * n1,
                 w.vec + 4 * n1};
  SSD_CHECK(prepare<T>());
  cums_kernel<<<g[0].grid, THREADS, 0, stream>>>(dt, A, d, w.cums);
  SSD_CHECK(last_error());
  cb_kernel<T><<<g[1].grid, THREADS, 0, stream>>>(C, B, d, cb);
  SSD_CHECK(last_error());
  w_kernel<T><<<g[2].grid, THREADS, 0, stream>>>(dy, C, w.cums, d, w.gs);
  SSD_CHECK(last_error());
  reverse_kernel<T><<<g[3].grid, THREADS, 0, stream>>>(states, dfinal, w.cums,
                                                       d, w.gs, w.dG);
  SSD_CHECK(last_error());
  state_grad_kernel<T><<<g[4].grid, THREADS, 0, stream>>>(
      dt, xh, B, C, dy, states, w.gs, w.cums, d, vec, w.dxs, w.dBh, w.dCh);
  SSD_CHECK(last_error());
  rows_kernel<T><<<g[5].grid, THREADS, g[5].smem, stream>>>(
      dt, xh, B, dy, w.cums, cb, d, vec, w.dCh);
  SSD_CHECK(last_error());
  cols_kernel<T><<<g[6].grid, THREADS, g[6].smem, stream>>>(
      dt, xh, C, dy, w.cums, cb, w.dxs, d, vec, dxh, w.dBh);
  SSD_CHECK(last_error());
  finish_kernel<<<g[7].grid, THREADS, 0, stream>>>(dt, A, w.cums, w.dG, d,
                                                   vec, ddt, w.da_part);
  SSD_CHECK(last_error());
  reduce_kernel<T><<<g[8].grid, THREADS, 0, stream>>>(w.dBh, w.dCh,
                                                      w.da_part, d, dB, dC,
                                                      dA);
  return last_error();
}

Dims dims(int b, int s, int nh, int hd, int ns, int lc) {
  return Dims{b, s, nh, hd, ns, lc, lc > 0 ? s / lc : 0};
}

}  // namespace

// Floats of workspace that entry (0 scan, 1 scan_grad) needs; -1 if the
// shapes are not taken.
extern "C" long long ssd_workspace_floats(int entry, int b, int s, int nh,
                                          int hd, int ns, int lc, int dtype) {
  const Dims d = dims(b, s, nh, hd, ns, lc);
  if (bad(d, dtype) || (entry != SCAN && entry != SCAN_GRAD)) return -1;
  return static_cast<long long>(carve(d, dtype, entry, nullptr).floats);
}

// dtype: 0 float32, 1 bfloat16 (xh, B, C, y, final_state, states).
extern "C" int ssd_scan_sm90(const float* dt, const void* xh, const void* B,
                             const void* C, const float* A, int b, int s,
                             int nh, int hd, int ns, int lc, int dtype,
                             float* work, long long work_floats, void* y,
                             void* final_state, void* states,
                             cudaStream_t stream) {
  const Dims d = dims(b, s, nh, hd, ns, lc);
  if (bad(d, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const Work w = carve(d, dtype, SCAN, work);
  if (static_cast<long long>(w.floats) > work_floats)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return scan_impl(dt, static_cast<const BF16*>(xh),
                     static_cast<const BF16*>(B), static_cast<const BF16*>(C),
                     A, d, w, static_cast<BF16*>(y),
                     static_cast<BF16*>(final_state),
                     static_cast<BF16*>(states), stream);
  return scan_impl(dt, static_cast<const float*>(xh),
                   static_cast<const float*>(B), static_cast<const float*>(C),
                   A, d, w, static_cast<float*>(y),
                   static_cast<float*>(final_state),
                   static_cast<float*>(states), stream);
}

// dfinal may be null (a zero cotangent for the final state).  dxh, dB, dC
// in the compute dtype, ddt (b, s, nh) and dA (nh) float32.
extern "C" int ssd_scan_grad_sm90(const float* dt, const void* xh,
                                  const void* B, const void* C,
                                  const float* A, const void* states,
                                  const void* dy, const void* dfinal, int b,
                                  int s, int nh, int hd, int ns, int lc,
                                  int dtype, float* work,
                                  long long work_floats, void* dxh,
                                  float* ddt, void* dB, void* dC, float* dA,
                                  cudaStream_t stream) {
  const Dims d = dims(b, s, nh, hd, ns, lc);
  if (bad(d, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const Work w = carve(d, dtype, SCAN_GRAD, work);
  if (static_cast<long long>(w.floats) > work_floats)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return scan_grad_impl(
        dt, static_cast<const BF16*>(xh), static_cast<const BF16*>(B),
        static_cast<const BF16*>(C), A, static_cast<const BF16*>(states),
        static_cast<const BF16*>(dy), static_cast<const BF16*>(dfinal), d, w,
        static_cast<BF16*>(dxh), ddt, static_cast<BF16*>(dB),
        static_cast<BF16*>(dC), dA, stream);
  return scan_grad_impl(
      dt, static_cast<const float*>(xh), static_cast<const float*>(B),
      static_cast<const float*>(C), A, static_cast<const float*>(states),
      static_cast<const float*>(dy), static_cast<const float*>(dfinal), d, w,
      static_cast<float*>(dxh), ddt, static_cast<float*>(dB),
      static_cast<float*>(dC), dA, stream);
}

// state (b, nh, hd, ns) and conv (b, conv_rows, width) updated in place from
// window (b, conv_rows + 1, width); xh (b, nh, hd), Bv and Cv (b, ns) in the
// compute dtype, dtv (b, nh) and A (nh) float32; y (b, nh, hd).
extern "C" int ssd_step_sm90(void* state, void* conv, const void* window,
                             const void* xh, const float* dtv, const float* A,
                             const void* Bv, const void* Cv, int b, int nh,
                             int hd, int ns, int conv_rows, int width,
                             int dtype, void* y, cudaStream_t stream) {
  if (b < 1 || nh < 1 || hd < 1 || ns < 1 || hd * ns > MAX_STATE ||
      conv_rows < 0 || width < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b * nh);
  if (dtype == 1)
    step_kernel<BF16><<<grid, THREADS, 0, stream>>>(
        static_cast<BF16*>(state), static_cast<BF16*>(conv),
        static_cast<const BF16*>(window), static_cast<const BF16*>(xh), dtv,
        A, static_cast<const BF16*>(Bv), static_cast<const BF16*>(Cv), nh, hd,
        ns, conv_rows, width, b, static_cast<BF16*>(y));
  else
    step_kernel<float><<<grid, THREADS, 0, stream>>>(
        static_cast<float*>(state), static_cast<float*>(conv),
        static_cast<const float*>(window), static_cast<const float*>(xh), dtv,
        A, static_cast<const float*>(Bv), static_cast<const float*>(Cv), nh,
        hd, ns, conv_rows, width, b, static_cast<float*>(y));
  return last_error();
}

// The launch floor of an entry: an empty kernel launched with each of the
// entry's grids, blocks and dynamic shared memory, in order.
extern "C" int ssd_floor_sm90(int entry, int b, int s, int nh, int hd, int ns,
                              int lc, int dtype, cudaStream_t stream) {
  const Dims d = dims(b, s, nh, hd, ns, lc);
  if (entry == STEP ? (b < 1 || nh < 1) : bad(d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch g[9];
  const int n = launches(entry, d, b * nh, g);
  SSD_CHECK(prepare<float>());
  for (int k = 0; k < n; ++k) {
    empty_kernel<<<g[k].grid, THREADS, g[k].smem, stream>>>(0);
    SSD_CHECK(last_error());
  }
  return 0;
}
