// MoE capacity dispatch and expert-ordered combine for Hopper, CUDA C++ for
// sm_90a.
//
// Replaces the reference's XLA program for the sort-based capacity MoE,
//   src/repro/models/layers.py:262::moe_apply,
// around its expert products (which stay matrix products in torch):
//   * route     its stable argsort by expert, each entry's position within
//               its expert, keep = pos < cap and slot = min(e*cap + pos,
//               E*cap - 1), as one dispatch group;
//   * dispatch  its scatter-add of the kept tokens into (E*cap, D) rows;
//   * combine   its gated gather-back and scatter-add into the tokens.
// The plain versions are kernels/moe/ref.py (route_ref, dispatch_ref,
// combine_ref); every entry equals its plain version bit for bit.
//
// Numbers.  combine adds a token's k terms in ascending expert order, from
// +0, each term bf16(ho[slot] * bf16(gate * keep)) and each add rounded to
// the compute dtype: the order in which the reference's scatter-add meets a
// token's entries, which are sorted by expert.  The products and sums are
// taken in fp32 with __fmul_rn / __fadd_rn (no contraction) and rounded
// with __float2bfloat16_rn, as the CPU's and torch's bf16 arithmetic does.
// A dropped entry is multiplied by 0, not skipped, so a non-finite value in
// its row reaches the output (NaN kept, ROADMAP C5).  dispatch copies each
// kept token's row; a dropped entry adds x * 0 to its slot in the
// reference, which changes the row only where x is not finite: the second
// pass (dispatch_nonfinite_kernel) writes NaN there.
//
// What bounds it on the H100: bytes.  dispatch reads each token row once and
// writes E*cap rows; combine reads the N*k rows it gathers and writes N
// rows; route reads N*k ints and writes their slots and flags.  None does
// more than a few operations a byte.
//
// Design (a simple kernel that is right; not tuned):
//   * route: one block of 1024 threads walks the N*k entries in tiles of
//     1024.  Within a warp __match_any_sync groups the lanes of one expert
//     and a lane's rank is the popcount of its lower peers; the counts of
//     each (warp, expert) go to shared memory, where a thread per expert
//     scans them over the 32 warps on top of the expert's running total.
//     That is the stable position of every entry without a sort.  The
//     dropped entries are compacted in entry order the same way (a ballot
//     per warp, a scan over the warps).  E <= 64.
//   * dispatch: a block a row of the buffer, 16-byte vector copies (or
//     zeros for an empty row); the non-finite pass walks the dropped list
//     with a grid-stride loop (its length is read on the card) and only
//     stores where a value is not finite, the same NaN from every writer.
//   * combine: a block a token.  Each thread loads the token's k (expert,
//     slot, weight) and sorts them by expert with an odd-even transposition
//     network of MAX_K rounds in registers (stable: it swaps only on >),
//     then accumulates its 16-byte vectors of the output over the k rows.
//
// C interface (loaded with ctypes): each entry returns the cudaError_t of
// its launches as an int, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROUTE_THREADS = 1024;
constexpr int ROUTE_WARPS = ROUTE_THREADS / 32;
constexpr int MAX_E = 64;
constexpr int MAX_K = 8;
constexpr int ROW_THREADS = 256;
constexpr int NONFINITE_BLOCKS = 264;   // two a streaming multiprocessor

// ---------------------------------------------------------------- route
__global__ void __launch_bounds__(ROUTE_THREADS, 1)
route_kernel(const int* __restrict__ top_e, int n, int k, int e, int cap,
             int* __restrict__ slot, bool* __restrict__ keep,
             int* __restrict__ rows, int* __restrict__ stats,
             int* __restrict__ dropped) {
  __shared__ int cnt[ROUTE_WARPS][MAX_E];   // per tile: counts, then offsets
  __shared__ int base[MAX_E];               // entries of each expert so far
  __shared__ int wdrop[ROUTE_WARPS];
  __shared__ int drop_base;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nk = n * k, ecap = e * cap;
  const unsigned below = (1u << lane) - 1u;

  for (int i = tid; i < ecap; i += ROUTE_THREADS) rows[i] = -1;
  for (int i = tid; i < nk; i += ROUTE_THREADS) dropped[i] = -1;
  if (tid < MAX_E) base[tid] = 0;
  if (tid == 0) drop_base = 0;

  for (int t0 = 0; t0 < nk; t0 += ROUTE_THREADS) {
    const int i = t0 + tid;
    const bool valid = i < nk;
    int ex = valid ? top_e[i] : -1;
    const bool ok = valid && ex >= 0 && ex < e;
    if (!ok) ex = -1;
    for (int j = lane; j < MAX_E; j += 32) cnt[w][j] = 0;
    __syncwarp();
    const unsigned peers = __match_any_sync(0xffffffffu, ex);
    if (ok && __ffs(peers) - 1 == lane) cnt[w][ex] = __popc(peers);
    __syncthreads();                        // also orders the -1 fills
    if (tid < e) {
      int run = base[tid];
      for (int ww = 0; ww < ROUTE_WARPS; ++ww) {
        const int c = cnt[ww][tid];
        cnt[ww][tid] = run;
        run += c;
      }
      base[tid] = run;
    }
    __syncthreads();
    const int pos = ok ? cnt[w][ex] + __popc(peers & below) : 0;
    const bool kept = ok && pos < cap;
    if (valid) {
      const long long s = ok ? static_cast<long long>(ex) * cap + pos : ecap;
      slot[i] = static_cast<int>(s < ecap - 1 ? s : ecap - 1);
      keep[i] = kept;
      if (kept) rows[ex * cap + pos] = i;
    }
    const unsigned lost = __ballot_sync(0xffffffffu, valid && !kept);
    if (lane == 0) wdrop[w] = __popc(lost);
    __syncthreads();
    if (tid == 0) {
      int run = drop_base;
      for (int ww = 0; ww < ROUTE_WARPS; ++ww) {
        const int c = wdrop[ww];
        wdrop[ww] = run;
        run += c;
      }
      drop_base = run;
    }
    __syncthreads();
    if (valid && !kept) dropped[wdrop[w] + __popc(lost & below)] = i;
    __syncthreads();                        // before the next tile's counts
  }
  if (tid < e) stats[tid] = base[tid];
  if (tid == 0) stats[e] = drop_base;
}

// ------------------------------------------------------------ element types
struct F32 {
  using raw = float;
  static constexpr int VEC = 4;             // elements a 16-byte vector
  __device__ static float f(raw v) { return v; }
  __device__ static raw r(float v) { return v; }
  __device__ static raw nan() { return __int_as_float(0x7fc00000); }
};

struct BF16 {
  using raw = unsigned short;
  static constexpr int VEC = 8;
  __device__ static float f(raw v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  __device__ static raw r(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static raw nan() { return 0x7fc0; }
};

template <typename T>
union Vec {
  uint4 u;
  typename T::raw el[T::VEC];
};

// -------------------------------------------------------------- dispatch
__global__ void __launch_bounds__(ROW_THREADS)
dispatch_kernel(const uint4* __restrict__ x, const int* __restrict__ rows,
                int k, int vecs, uint4* __restrict__ out) {
  const int i = rows[blockIdx.x];
  uint4* dst = out + static_cast<int64_t>(blockIdx.x) * vecs;
  if (i >= 0) {
    const uint4* src = x + static_cast<int64_t>(i / k) * vecs;
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) dst[v] = src[v];
  } else {
    for (int v = threadIdx.x; v < vecs; v += blockDim.x)
      dst[v] = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
dispatch_nonfinite_kernel(const typename T::raw* __restrict__ x,
                          const int* __restrict__ slot,
                          const int* __restrict__ n_dropped,
                          const int* __restrict__ dropped, int k, int d,
                          typename T::raw* __restrict__ out) {
  const int nd = *n_dropped;
  for (int j = blockIdx.x; j < nd; j += gridDim.x) {
    const int i = dropped[j];
    const typename T::raw* src = x + static_cast<int64_t>(i / k) * d;
    typename T::raw* dst = out + static_cast<int64_t>(slot[i]) * d;
    for (int c = threadIdx.x; c < d; c += blockDim.x)
      if (!isfinite(T::f(src[c]))) dst[c] = T::nan();
  }
}

// --------------------------------------------------------------- combine
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
combine_kernel(const uint4* __restrict__ ho, const int* __restrict__ slot,
               const bool* __restrict__ keep, const float* __restrict__ gates,
               const int* __restrict__ top_e, int k, int vecs,
               uint4* __restrict__ out) {
  const int64_t t = blockIdx.x;
  int ex[MAX_K], sl[MAX_K];
  float wt[MAX_K];
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    if (j < k) {
      const int64_t idx = t * k + j;
      ex[j] = top_e[idx];
      sl[j] = slot[idx];
      // gate * keep in fp32, rounded to the compute dtype
      wt[j] = T::f(T::r(__fmul_rn(gates[idx], keep[idx] ? 1.f : 0.f)));
    } else {
      ex[j] = 0x7fffffff;                   // padding sorts last
      sl[j] = 0;
      wt[j] = 0.f;
    }
  }
#pragma unroll
  for (int round = 0; round < MAX_K; ++round) {
#pragma unroll
    for (int p = round & 1; p + 1 < MAX_K; p += 2) {
      if (ex[p] > ex[p + 1]) {
        const int e0 = ex[p], s0 = sl[p];
        const float w0 = wt[p];
        ex[p] = ex[p + 1];
        sl[p] = sl[p + 1];
        wt[p] = wt[p + 1];
        ex[p + 1] = e0;
        sl[p + 1] = s0;
        wt[p + 1] = w0;
      }
    }
  }
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    float acc[T::VEC];
#pragma unroll
    for (int c = 0; c < T::VEC; ++c) acc[c] = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) {
      if (j < k) {
        Vec<T> h;
        h.u = ho[static_cast<int64_t>(sl[j]) * vecs + v];
#pragma unroll
        for (int c = 0; c < T::VEC; ++c) {
          const float term = T::f(T::r(__fmul_rn(T::f(h.el[c]), wt[j])));
          acc[c] = T::f(T::r(__fadd_rn(acc[c], term)));
        }
      }
    }
    Vec<T> o;
#pragma unroll
    for (int c = 0; c < T::VEC; ++c) o.el[c] = T::r(acc[c]);
    out[t * vecs + v] = o.u;
  }
}

int row_threads(int vecs) {
  const int warps = (vecs + 31) / 32;
  return warps * 32 < ROW_THREADS ? warps * 32 : ROW_THREADS;
}

}  // namespace

extern "C" int moe_route_sm90(const int* top_e, int n, int k, int e, int cap,
                              int* slot, bool* keep, int* rows, int* stats,
                              int* dropped, cudaStream_t stream) {
  if (n < 1 || k < 1 || k > MAX_K || e < 1 || e > MAX_E || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  route_kernel<<<1, ROUTE_THREADS, 0, stream>>>(top_e, n, k, e, cap, slot,
                                                keep, rows, stats, dropped);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 float32, 1 bfloat16.  x (n, d), out (e * cap, d).  may_drop 0:
// the caller knows no entry dropped (each token's k experts distinct and in
// range, cap >= n), and the non-finite pass is not launched.
extern "C" int moe_dispatch_sm90(const void* x, const int* rows,
                                 const int* slot, const int* stats,
                                 const int* dropped, int n, int k, int d,
                                 int e, int cap, int dtype, int may_drop,
                                 void* out, cudaStream_t stream) {
  const int elem = dtype == 1 ? 2 : 4;
  if (n < 1 || k < 1 || e < 1 || cap < 1 || (d * elem) % 16 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vecs = d * elem / 16;
  dispatch_kernel<<<e * cap, row_threads(vecs), 0, stream>>>(
      static_cast<const uint4*>(x), rows, k, vecs, static_cast<uint4*>(out));
  if (!may_drop) return static_cast<int>(cudaGetLastError());
  const int blocks = n * k < NONFINITE_BLOCKS ? n * k : NONFINITE_BLOCKS;
  if (dtype == 1)
    dispatch_nonfinite_kernel<BF16><<<blocks, ROW_THREADS, 0, stream>>>(
        static_cast<const BF16::raw*>(x), slot, stats + e, dropped, k, d,
        static_cast<BF16::raw*>(out));
  else
    dispatch_nonfinite_kernel<F32><<<blocks, ROW_THREADS, 0, stream>>>(
        static_cast<const F32::raw*>(x), slot, stats + e, dropped, k, d,
        static_cast<F32::raw*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ho (rows, d), gates (n, k) float32, out (n, d).
extern "C" int moe_combine_sm90(const void* ho, const int* slot,
                                const bool* keep, const float* gates,
                                const int* top_e, int n, int k, int d,
                                int dtype, void* out, cudaStream_t stream) {
  const int elem = dtype == 1 ? 2 : 4;
  if (n < 1 || k < 1 || k > MAX_K || (d * elem) % 16 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vecs = d * elem / 16;
  const uint4* h = static_cast<const uint4*>(ho);
  uint4* o = static_cast<uint4*>(out);
  if (dtype == 1)
    combine_kernel<BF16><<<n, row_threads(vecs), 0, stream>>>(
        h, slot, keep, gates, top_e, k, vecs, o);
  else
    combine_kernel<F32><<<n, row_threads(vecs), 0, stream>>>(
        h, slot, keep, gates, top_e, k, vecs, o);
  return static_cast<int>(cudaGetLastError());
}
