// MoE capacity dispatch and expert-ordered combine for Hopper, and their
// backward, CUDA C++ for sm_90a.
//
// Replaces the reference's XLA program for the sort-based capacity MoE,
//   src/repro/models/layers.py:262::moe_apply,
// around its expert products (which stay matrix products in torch), and
// the program jax.grad makes of it:
//   * route     its stable argsort by expert, each entry's position within
//               its expert, keep = pos < cap and slot = min(e*cap + pos,
//               E*cap - 1), as one dispatch group;
//   * dispatch  its scatter-add of the kept tokens into (E*cap, D) rows;
//   * combine   its gated gather-back and scatter-add into the tokens; with
//               unit gates also the dispatch's cotangent for x;
//   * combine_grad  the combine's cotangent for the experts' outputs: the
//               dispatch with a weight an entry, +0 + dout[token] * w;
//   * gate_grad the combine's cotangent for the gates: a dot product an
//               entry, keep * fp32(cdt(sum_d dout[token, d] * ho[slot, d])).
// The plain versions are kernels/moe/ref.py (route_ref, dispatch_ref,
// combine_ref, dispatch_grad_ref, combine_grad_ref, gate_grad_ref); every
// entry equals its plain version bit for bit.
//
// Numbers.  combine adds a token's k terms in ascending expert order, from
// +0, each term bf16(ho[slot] * bf16(gate * keep)) and each add rounded to
// the compute dtype: the order in which the reference's scatter-add meets a
// token's entries, which are sorted by expert.  The products and sums are
// taken in fp32 with __fmul_rn / __fadd_rn (no contraction) and rounded to
// bf16 to nearest even two at a time (cvt.rn.bf16x2.f32), as the CPU's and
// torch's bf16 arithmetic rounds each value.  A dropped entry is multiplied
// by 0, not skipped, so a non-finite value in its row reaches the output
// (NaN kept, ROADMAP C5).  dispatch copies each kept token's row; a dropped
// entry adds x * 0 to its slot in the reference, which changes the row only
// where x is not finite: the second pass writes NaN there.  combine_grad
// writes each kept row as +0 + bf16(dout * bf16(gate)) (the reference's
// scatter-add into zeros turns -0 into +0) and runs the same NaN pass on
// dout.  gate_grad sums in the order of the program XLA:CPU compiles for the
// reference's VJP (ref.xla_row_sum): each product taken in fp32 and rounded
// to the compute dtype, windows of 32 consecutive products summed in order
// from +0 with every add rounded to the compute dtype, the window sums
// summed in windows again while more than 32 remain, then in order; the
// sum times keep is added to +0 (the reference's scatter-add into zeros),
// so a dropped entry gives +0, or NaN where its dot is not finite.
//
// What bounds each entry on the H100, and what the design does about it:
//   * route: latency.  Its bytes (N*k ints in, slots, flags and rows out)
//     take well under a microsecond; the time is the chain of barriers
//     that ranks the entries stably.  At N*k <= 32 (a decode step) one
//     warp does everything in registers: __match_any_sync groups the lanes
//     of an expert, a lane's position is the popcount of its lower peers,
//     a ballot compacts the dropped entries; no __syncthreads.  Above that,
//     one thread-block cluster of up to 16 blocks of 512 threads (the size
//     the card can co-schedule, probed once) splits the entries into
//     contiguous shares in block order.  Pass 1: each block counts its
//     share's entries per expert in shared memory.  After cluster.sync()
//     each block reads the counts of every block through distributed
//     shared memory: the sum over the blocks before it, in block order, is
//     each expert's base, so the positions are the stable ones with no
//     sort and no global atomic; the dropped entries before the block are
//     sum_e max(base_e - cap, 0) plus its earlier out-of-range entries,
//     the totals give stats, and the -1 fills of rows and dropped cover
//     only places no entry writes (rows past each expert's count, dropped
//     past the total), spread over the cluster with no ordering needed.
//     Pass 2: each block walks its share in tiles of 512 (one or two at
//     the serving shapes): a match per warp, the per-(warp, expert) counts
//     scanned over the warps with shuffles on top of the running base, a
//     ballot and a scan for the dropped list; three __syncthreads a tile.
//     A second cluster barrier, arrived at after the reads and waited at
//     the end, keeps each block's shared counts alive while others read.
//   * dispatch: bytes.  It reads the kept tokens' rows and writes E*cap
//     rows, in one of two orders by one shape rule (by_token): x's bytes
//     up to ROWS_IN_L2 (16 MB), rows in order; past it, by token.  Rows in
//     order: a block of 256 threads copies 8 KB of the buffer (several
//     rows where D is small), each row gathering its token's row of x, so
//     a token row is read once a kept entry (k times); where x fits the
//     L2 (the serving prefill's 4-8 MB) those re-reads hit there, the
//     stores run through the buffer in sequence, and the copy reaches
//     89-92% of the byte bound.  At the training shape (16,384 tokens: x
//     33.5 MB at granite-moe, 67.1 MB at qwen2-moe) the re-reads come from
//     device memory (48-59% of the bound in rows' order).  By token: the
//     zero blocks first (at most 264, a warp a row) zero the rows no entry
//     fills, each expert's rows past its count, read from the routing's
//     counts; then a block takes a few tokens, loads each token row once
//     (its first loads in flight while it reads its entries' slots and
//     weights into shared memory) and stores it at the slot of every kept
//     entry (an entry is kept where rows[slot] is the entry itself):
//     83-84% of the bound, the stores scattered by token, which is why the
//     serving shapes keep the rows' order.  Each thread issues its two
//     16-byte loads before its
//     stores, which stream (st.global.cs, evict first: the buffer is
//     written once and read once).  Where the routing may have dropped an
//     entry and did, the same launch runs the non-finite pass: every block
//     checks its share of the dropped tokens' values and flags a
//     non-finite one, the blocks take tickets as they finish, and the last
//     264 wait until every store is done; only if a value was flagged do
//     they store NaN at the dropped entries' columns that are not finite,
//     the same NaN from every writer.  The routing's three counters
//     (zeroed by the route) order this and are left at 0.
//   * combine: bytes, and in bf16 the roundings.  It reads the N*k rows its
//     entries point at and writes N rows.  A block takes one token or
//     several (2 at D = 1024 bf16): one thread a token sorts its k choices
//     by expert (a stable odd-even transposition network in registers) into
//     shared memory; then each thread issues the k 16-byte loads of its
//     output vector before the ordered adds, two roundings an element
//     packed two to an instruction.  Kernels for k <= 4 and k <= 8: the
//     registers of the loads in flight decide how many threads an SM holds.
//   * combine_grad: bytes, as dispatch: the same kernel in the same
//     order, instantiated with a weight an entry (rows in order: read
//     beside the row's loads; by token: into shared memory with the
//     slots), and the same NaN pass ordered by the routing's counters.
//   * gate_grad: bytes.  It reads the N token rows of dout and the N*k rows
//     of ho its entries point at and writes N*k floats.  One warp an entry,
//     8 a block (a block holds one token's entries at top-8, so its dout
//     row is read from device memory once).  Lane l loads the whole windows
//     l, l + 32, ... (4 vectors in bf16, 8 in fp32) before its adds, so its
//     chain of roundings is XLA's; the window sums meet in shared memory.
// An empty kernel launched with an entry's geometry (moe_floor_sm90) is the
// least time a launch of that entry can take: the launch floor.
//
// C interface (loaded with ctypes): each entry returns the cudaError_t of
// its launches as an int, 0 on success.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_E = 64;
constexpr int MAX_K = 8;
constexpr int WARP_ENTRIES = 32;          // N*k up to this: the one-warp route
constexpr int ROUTE_THREADS = 512;
constexpr int ROUTE_WARPS = ROUTE_THREADS / 32;
constexpr int MAX_CLUSTER = 16;
constexpr int OUT_OF_RANGE = MAX_E;       // the route's key of an expert not in [0, E)
constexpr int COPY_THREADS = 256;
constexpr int COPY_UNROLL = 2;            // 16-byte loads a thread before its stores
constexpr int COPY_TOKENS = 32;           // tokens a dispatch block at most
constexpr int COPY_SPREAD = 128;          // token blocks at least, where N allows
constexpr int COPY_WARPS = COPY_THREADS / 32;
constexpr int ZERO_BLOCKS = 264;          // zero blocks at most: two an SM
constexpr int NONFINITE_BLOCKS = 264;     // the waiters: two a streaming multiprocessor
constexpr int NONFINITE_UNROLL = 4;
constexpr int COMBINE_THREADS = 256;
constexpr int MAX_TOKENS = 32;            // tokens a combine block
constexpr int GATE_THREADS = 256;
constexpr int GATE_WARPS = GATE_THREADS / 32;   // entries a gate_grad block
constexpr int WINDOW = 32;                // XLA:CPU's reduce-window in a row sum
constexpr int GATE_MAX_WINDOWS = 256;     // gate_grad's D up to 8192

enum Entry { ROUTE = 0, DISPATCH = 1, COMBINE = 2, COMBINE_GRAD = 3, GATE_GRAD = 4 };

// ---------------------------------------------------------------- route
// The route's key of entry i: its expert, OUT_OF_RANGE, or -1 past `end`.
__device__ __forceinline__ int route_key(const int* __restrict__ top_e, int i,
                                         int end, int e) {
  if (i >= end) return -1;
  const int ex = top_e[i];
  return ex >= 0 && ex < e ? ex : OUT_OF_RANGE;
}

__device__ __forceinline__ int slot_of(int key, int pos, int cap, int ecap) {
  if (key == OUT_OF_RANGE) return ecap - 1;
  const long long s = static_cast<long long>(key) * cap + pos;
  return static_cast<int>(s < ecap - 1 ? s : ecap - 1);
}

// Inclusive sum over the first `width` lanes (the others hold 0).
__device__ __forceinline__ int warp_scan(int v, int lane, int width) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o >= width) break;
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// N*k <= 32: one warp, everything in registers.  The -1 and 0 fills come
// first and __syncwarp orders them before the writes that overwrite them.
__global__ void __launch_bounds__(32)
route_warp_kernel(const int* __restrict__ top_e, int nk, int e, int cap,
                  int* __restrict__ slot, bool* __restrict__ keep,
                  int* __restrict__ rows, int* __restrict__ stats,
                  int* __restrict__ dropped, unsigned* __restrict__ scratch) {
  const int lane = threadIdx.x, ecap = e * cap;
  const unsigned below = (1u << lane) - 1u;
  if (lane < 3) scratch[lane] = 0u;
  for (int i = lane; i < ecap; i += 32) rows[i] = -1;
  for (int i = lane; i <= e; i += 32) stats[i] = 0;
  if (lane < nk) dropped[lane] = -1;
  const int key = route_key(top_e, lane, nk, e);
  const bool valid = key >= 0, ok = valid && key != OUT_OF_RANGE;
  const unsigned peers = __match_any_sync(FULL, key);
  const int pos = __popc(peers & below);
  const bool kept = ok && pos < cap;
  const unsigned lost = __ballot_sync(FULL, valid && !kept);
  __syncwarp();
  if (valid) {
    slot[lane] = slot_of(key, pos, cap, ecap);
    keep[lane] = kept;
    if (kept) rows[key * cap + pos] = lane;
    if (!kept) dropped[__popc(lost & below)] = lane;
  }
  if (ok && __ffs(peers) - 1 == lane) stats[key] = __popc(peers);
  if (lane == 0) stats[e] = __popc(lost);
}

// N*k > 32: one cluster; block `rank` ranks entries [rank*share, ...).
__global__ void __launch_bounds__(ROUTE_THREADS)
route_cluster_kernel(const int* __restrict__ top_e, int nk, int e, int cap,
                     int share, int* __restrict__ slot,
                     bool* __restrict__ keep, int* __restrict__ rows,
                     int* __restrict__ stats, int* __restrict__ dropped,
                     unsigned* __restrict__ scratch) {
  __shared__ int bcnt[MAX_E + 1];         // this block's entries a key (read by the cluster)
  __shared__ int cnt[ROUTE_WARPS][MAX_E]; // per tile: counts, then positions
  __shared__ int base[MAX_E];             // each expert's next position
  __shared__ int total[MAX_E];            // the cluster's entries of each expert
  __shared__ int wdrop[ROUTE_WARPS];
  __shared__ int red[3][2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nblk = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int lo = rank * share;
  const int hi = lo + share < nk ? lo + share : nk;
  const int ecap = e * cap;

  // pass 1: this block's entries of each key
  for (int j = tid; j <= MAX_E; j += ROUTE_THREADS) bcnt[j] = 0;
  __syncthreads();
  for (int t0 = lo; t0 < hi; t0 += ROUTE_THREADS) {
    const int key = route_key(top_e, t0 + tid, hi, e);
    const unsigned peers = __match_any_sync(FULL, key);
    if (key >= 0 && __ffs(peers) - 1 == lane) atomicAdd(&bcnt[key], __popc(peers));
  }
  cluster.sync();

  // every block's counts, in block order: this block's bases and the totals
  int before = 0, all = 0;
  if (tid <= e) {
    const int j = tid < e ? tid : OUT_OF_RANGE;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < nblk) {
        const int c = cluster.map_shared_rank(bcnt, r)[j];
        all += c;
        if (r < rank) before += c;
      }
    }
    if (tid < e) {
      base[tid] = before;
      total[tid] = all;
    }
  }
  // the dropped entries before this block, and all of them: an expert's
  // entries past its first cap, and every out-of-range entry
  int d_before = 0, d_all = 0;
  if (tid < e) {
    d_before = before > cap ? before - cap : 0;
    d_all = all > cap ? all - cap : 0;
  } else if (tid == e) {
    d_before = before;
    d_all = all;
  }
  if (w < 3) {                             // threads 0..95 hold keys 0..E
    d_before = __reduce_add_sync(FULL, d_before);
    d_all = __reduce_add_sync(FULL, d_all);
    if (lane == 0) {
      red[w][0] = d_before;
      red[w][1] = d_all;
    }
  }
  __syncthreads();
  // done reading the other blocks' counts; waited for at the end
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  int drun = red[0][0] + red[1][0] + red[2][0];
  const int n_dropped = red[0][1] + red[1][1] + red[2][1];

  // the fills: places no entry writes, spread over the cluster
  const int stride = nblk * ROUTE_THREADS;
  for (int idx = rank * ROUTE_THREADS + tid; idx < ecap; idx += stride) {
    const int x = idx / cap;
    if (idx - x * cap >= total[x]) rows[idx] = -1;
  }
  for (int idx = n_dropped + rank * ROUTE_THREADS + tid; idx < nk; idx += stride)
    dropped[idx] = -1;
  if (rank == 0) {
    if (tid < e) stats[tid] = total[tid];
    if (tid == 0) stats[e] = n_dropped;
    if (tid < 3) scratch[tid] = 0u;
  }

  // pass 2: positions, tile by tile, on top of each expert's base
  for (int t0 = lo; t0 < hi; t0 += ROUTE_THREADS) {
    const int i = t0 + tid;
    const int key = route_key(top_e, i, hi, e);
    const bool valid = key >= 0, ok = valid && key != OUT_OF_RANGE;
    const unsigned peers = __match_any_sync(FULL, key);
    cnt[w][lane] = 0;
    cnt[w][lane + 32] = 0;
    __syncwarp();
    if (ok && __ffs(peers) - 1 == lane) cnt[w][key] = __popc(peers);
    __syncthreads();
    for (int x = w; x < e; x += ROUTE_WARPS) {
      const int c = lane < ROUTE_WARPS ? cnt[lane][x] : 0;
      const int incl = warp_scan(c, lane, ROUTE_WARPS);
      const int b = base[x];
      if (lane < ROUTE_WARPS) cnt[lane][x] = b + incl - c;
      __syncwarp();
      if (lane == ROUTE_WARPS - 1) base[x] = b + incl;
    }
    __syncthreads();
    const int pos = ok ? cnt[w][key] + __popc(peers & below) : 0;
    const bool kept = ok && pos < cap;
    if (valid) {
      slot[i] = slot_of(key, pos, cap, ecap);
      keep[i] = kept;
      if (kept) rows[key * cap + pos] = i;
    }
    const unsigned lost = __ballot_sync(FULL, valid && !kept);
    if (lane == 0) wdrop[w] = __popc(lost);
    __syncthreads();
    const int c = lane < ROUTE_WARPS ? wdrop[lane] : 0;
    const int incl = warp_scan(c, lane, ROUTE_WARPS);
    const int off = __shfl_sync(FULL, incl - c, w);
    const int tile_lost = __shfl_sync(FULL, incl, ROUTE_WARPS - 1);
    if (valid && !kept) dropped[drun + off + __popc(lost & below)] = i;
    drun += tile_lost;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ------------------------------------------------------------ element types
struct F32 {
  using raw = float;
  static constexpr int VEC = 4;             // elements a 16-byte vector
  __device__ static float f(raw v) { return v; }
  __device__ static raw r(float v) { return v; }
  __device__ static bool finite(raw v) { return isfinite(v); }
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
  __device__ static bool finite(raw v) { return (v & 0x7f80) != 0x7f80; }
  __device__ static raw nan() { return 0x7fc0; }
};

template <typename T>
union Vec {
  uint4 u;
  typename T::raw el[T::VEC];
};

// ------------------------------------------------------------ the roundings
__device__ __forceinline__ float lo_f(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
// two floats rounded to bf16, nearest even, in one instruction
__device__ __forceinline__ unsigned pack_rn(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

template <typename T>
struct Terms;

template <>
struct Terms<F32> {
  // acc += ho * w, each product and add in fp32
  __device__ static void add(float (&acc)[8], uint4 h, float w) {
    const float hv[4] = {__uint_as_float(h.x), __uint_as_float(h.y),
                         __uint_as_float(h.z), __uint_as_float(h.w)};
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(hv[c], w));
  }
  __device__ static uint4 out(const float (&acc)[8]) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                      __float_as_uint(acc[2]), __float_as_uint(acc[3]));
  }
};

template <>
struct Terms<BF16> {
  // acc = bf16(acc + bf16(ho * w)), two elements at a time
  __device__ static void add(float (&acc)[8], uint4 h, float w) {
    const unsigned hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const unsigned t = pack_rn(__fmul_rn(lo_f(hv[p]), w), __fmul_rn(hi_f(hv[p]), w));
      const unsigned s = pack_rn(__fadd_rn(acc[2 * p], lo_f(t)),
                                 __fadd_rn(acc[2 * p + 1], hi_f(t)));
      acc[2 * p] = lo_f(s);
      acc[2 * p + 1] = hi_f(s);
    }
  }
  __device__ static uint4 out(const float (&acc)[8]) {
    return make_uint4(pack_rn(acc[0], acc[1]), pack_rn(acc[2], acc[3]),
                      pack_rn(acc[4], acc[5]), pack_rn(acc[6], acc[7]));
  }
};

// -------------------------------------------------------------- dispatch
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The (dropped entry, 16-byte vector) pairs f = first + tid, first + step,
// ...: f / vecs indexes the dropped list, f % vecs the vector.  `visit`
// gets the entry and the vector's values, NONFINITE_UNROLL loads in flight.
template <typename T, typename Visit>
__device__ __forceinline__ void walk_dropped(const uint4* __restrict__ x,
                                             const int* __restrict__ dropped,
                                             int nd, int k, int vecs,
                                             int64_t first, int64_t step,
                                             Visit visit) {
  const int64_t span = static_cast<int64_t>(nd) * vecs;
  for (int64_t f0 = first + threadIdx.x; f0 < span; f0 += step * NONFINITE_UNROLL) {
    int ent[NONFINITE_UNROLL], v[NONFINITE_UNROLL];
#pragma unroll
    for (int u = 0; u < NONFINITE_UNROLL; ++u) {
      const int64_t f = f0 + u * step;
      ent[u] = -1;
      v[u] = 0;
      if (f < span) {
        const int64_t j = f / vecs;
        ent[u] = dropped[j];
        v[u] = static_cast<int>(f - j * vecs);
      }
    }
    Vec<T> h[NONFINITE_UNROLL];
#pragma unroll
    for (int u = 0; u < NONFINITE_UNROLL; ++u)
      if (ent[u] >= 0) h[u].u = x[static_cast<int64_t>(ent[u] / k) * vecs + v[u]];
#pragma unroll
    for (int u = 0; u < NONFINITE_UNROLL; ++u)
      if (ent[u] >= 0) visit(ent[u], v[u], h[u]);
  }
}

template <typename T>
__device__ __forceinline__ bool any_nonfinite(const Vec<T>& h) {
  bool bad = false;
#pragma unroll
  for (int c = 0; c < T::VEC; ++c) bad |= !T::finite(h.el[c]);
  return bad;
}

// x's bytes up to which the dispatch visits the buffer's rows in order:
// the rows' gathers of x then hit the L2.  Past it the dispatch goes by
// token (each token row read once).  The one shape rule between the two
// orders: rows in order are 5-7% faster at the serving prefill's x (4-8
// MB), the two tie at 16.8 MB (fp32), and by token takes 18-38% less time
// at 25 MB and 29-41% less at the training shape's 33.5-67 MB.
constexpr long long ROWS_IN_L2 = 16ll << 20;

// Rows in order: block b copies rows [b*rpb, ...) of the buffer, COPY_UNROLL
// vectors a thread, every load before any store.
template <typename T, bool WEIGHTED>
__device__ __forceinline__ void copy_rows(const uint4* __restrict__ x,
                                          const int* __restrict__ rows,
                                          const float* __restrict__ gates,
                                          int k, int ecap, int vecs, int rpb,
                                          uint4* __restrict__ out) {
  const int r0 = blockIdx.x * rpb;
  const int nr = rpb < ecap - r0 ? rpb : ecap - r0;
  const int span = nr * vecs;
  for (int f0 = 0; f0 < span; f0 += COPY_THREADS * COPY_UNROLL) {
    int tok[COPY_UNROLL], v[COPY_UNROLL];   // tok -1: a row of zeros, -2: none
    int64_t dst[COPY_UNROLL];
    float wt[COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      const int f = f0 + u * COPY_THREADS + threadIdx.x;
      tok[u] = -2;
      v[u] = 0;
      dst[u] = 0;
      wt[u] = 0.f;
      if (f < span) {
        const int rr = f / vecs;
        const int i = rows[r0 + rr];
        v[u] = f - rr * vecs;
        tok[u] = i >= 0 ? i / k : -1;
        dst[u] = static_cast<int64_t>(r0 + rr) * vecs + v[u];
        if (WEIGHTED && i >= 0) wt[u] = T::f(T::r(gates[i]));  // gate * keep(1)
      }
    }
    uint4 val[COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      val[u] = make_uint4(0u, 0u, 0u, 0u);
      if (tok[u] >= 0) val[u] = x[static_cast<int64_t>(tok[u]) * vecs + v[u]];
    }
    if constexpr (WEIGHTED) {
#pragma unroll
      for (int u = 0; u < COPY_UNROLL; ++u) {
        if (tok[u] < 0) continue;
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        Terms<T>::add(acc, val[u], wt[u]);  // +0 + cdt(x * w)
        val[u] = Terms<T>::out(acc);
      }
    }
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u)
      if (tok[u] != -2) __stcs(out + dst[u], val[u]);
  }
}

// By token, the zero blocks [0, zblocks): the rows no entry fills, expert
// x's rows past its count [x*cap + min(stats[x], cap), (x+1)*cap), taken in
// order as one list, a warp a row, the zero blocks' warps striding over it.
__device__ __forceinline__ void zero_rows(const int* __restrict__ stats,
                                          int e, int cap, int vecs,
                                          int zblocks,
                                          uint4* __restrict__ out) {
  __shared__ int s_base[MAX_E + 1];             // zero rows before expert x
  __shared__ int s_first[MAX_E];                // expert x's first zero row
  const int warp = static_cast<int>(threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (warp == 0) {                              // experts lane and lane + 32
    int c[2], z[2], incl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      c[h] = j < e ? (stats[j] < cap ? stats[j] : cap) : cap;
      z[h] = cap - c[h];                        // 0 past the experts
      incl[h] = warp_scan(z[h], lane, 32);
    }
    const int first_half = __shfl_sync(FULL, incl[0], 31);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      if (j < e) {
        s_first[j] = j * cap + c[h];
        s_base[j] = (h ? first_half : 0) + incl[h] - z[h];
      }
    }
    if (lane == 31) s_base[e] = first_half + incl[1];
  }
  __syncthreads();
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int q = blockIdx.x * COPY_WARPS + warp; q < s_base[e];
       q += zblocks * COPY_WARPS) {
    int lo = 0, hi = e - 1;                     // the last expert with base <= q
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_base[mid] <= q) lo = mid; else hi = mid - 1;
    }
    const int64_t r = s_first[lo] + (q - s_base[lo]);
    for (int v = lane; v < vecs; v += 32) __stcs(out + r * vecs + v, zero);
  }
}

// By token, a token block (blockIdx.x - zblocks) takes tpb tokens: its first
// COPY_UNROLL vectors are loaded while the block reads its entries' slots
// (an entry is kept where rows[slot] is the entry itself) and weights into
// shared memory; then each thread stores each vector it loaded at the slot
// of every kept entry of its token, COPY_UNROLL vectors at a time: each
// token row is read once.
template <typename T, bool WEIGHTED>
__device__ __forceinline__ void copy_tokens(const uint4* __restrict__ x,
                                            const int* __restrict__ rows,
                                            const int* __restrict__ slot,
                                            const float* __restrict__ gates,
                                            int n, int k, int vecs, int tpb,
                                            int zblocks,
                                            uint4* __restrict__ out) {
  __shared__ int s_slot[COPY_TOKENS * MAX_K];   // -1: the entry dropped
  __shared__ float s_wt[COPY_TOKENS * MAX_K];
  const int t0 = (static_cast<int>(blockIdx.x) - zblocks) * tpb;
  const int nt = tpb < n - t0 ? tpb : n - t0;
  const int span = nt * vecs;
  int tt[COPY_UNROLL], v[COPY_UNROLL];          // tt -1: no vector
  uint4 val[COPY_UNROLL];
  auto load = [&](int f0) {
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      const int f = f0 + u * COPY_THREADS + threadIdx.x;
      tt[u] = -1;
      v[u] = 0;
      if (f < span) {
        tt[u] = f / vecs;
        v[u] = f - tt[u] * vecs;
        val[u] = x[static_cast<int64_t>(t0 + tt[u]) * vecs + v[u]];
      }
    }
  };
  load(0);
  for (int j = threadIdx.x; j < nt * k; j += COPY_THREADS) {
    const int i = t0 * k + j;
    const int s = slot[i];
    const bool kept = rows[s] == i;
    s_slot[j] = kept ? s : -1;
    if (WEIGHTED) s_wt[j] = kept ? T::f(T::r(gates[i])) : 0.f;  // gate * keep(1)
  }
  __syncthreads();
  for (int f0 = 0; f0 < span; f0 += COPY_THREADS * COPY_UNROLL) {
    if (f0 > 0) load(f0);
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      if (tt[u] < 0) continue;
#pragma unroll
      for (int j = 0; j < MAX_K; ++j) {
        if (j >= k) break;
        const int s = s_slot[tt[u] * k + j];
        if (s < 0) continue;
        uint4 o = val[u];
        if constexpr (WEIGHTED) {
          float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          Terms<T>::add(acc, val[u], s_wt[tt[u] * k + j]);  // +0 + cdt(x * w)
          o = Terms<T>::out(acc);
        }
        __stcs(out + static_cast<int64_t>(s) * vecs + v[u], o);
      }
    }
  }
}

// The dispatch: the buffer's rows in order (BY_TOKEN false: copy_rows) or
// by token (zero_rows, then copy_tokens), every store streaming
// (st.global.cs: evict first, the buffer is written once and read once by
// the expert products).  Where the routing may have dropped an entry and
// did (stats[e] > 0), every block then checks its share of the dropped
// entries' values and flags a non-finite one (scratch[2]); the blocks take
// tickets as they finish (scratch[0]), and the last `waiters` wait until
// every block's stores are done.  Only if a value was flagged do they
// store NaN at the dropped entries' non-finite columns, each store after
// the copy of its row; the last of them to finish (scratch[1]) sets the
// counters back to 0 for the next dispatch of this routing.  WEIGHTED
// (combine_grad): each kept row is +0 + x[token] * cdt(gates[entry]).
// per_block: rows (in order) or tokens (by token) a block.
template <typename T, bool WEIGHTED, bool BY_TOKEN>
__global__ void __launch_bounds__(COPY_THREADS)
dispatch_kernel(const uint4* __restrict__ x, const int* __restrict__ rows,
                const int* __restrict__ slot, const int* __restrict__ stats,
                const int* __restrict__ dropped,
                const float* __restrict__ gates, int n, int k, int e,
                int cap, int vecs, int per_block, int zblocks, int may_drop,
                unsigned* __restrict__ scratch, uint4* __restrict__ out) {
  __shared__ int s_ticket, s_flagged;
  const int nd = may_drop ? stats[e] : 0;
  if constexpr (!BY_TOKEN)
    copy_rows<T, WEIGHTED>(x, rows, gates, k, e * cap, vecs, per_block, out);
  else if (static_cast<int>(blockIdx.x) < zblocks)
    zero_rows(stats, e, cap, vecs, zblocks, out);
  else
    copy_tokens<T, WEIGHTED>(x, rows, slot, gates, n, k, vecs, per_block,
                             zblocks, out);
  if (nd == 0) return;

  const int blocks = static_cast<int>(gridDim.x);
  const int waiters = blocks < NONFINITE_BLOCKS ? blocks : NONFINITE_BLOCKS;
  bool bad = false;
  walk_dropped<T>(x, dropped, nd, k, vecs,
                  static_cast<int64_t>(blockIdx.x) * COPY_THREADS,
                  static_cast<int64_t>(blocks) * COPY_THREADS,
                  [&](int, int, const Vec<T>& h) { bad |= any_nonfinite<T>(h); });
  bad = __syncthreads_or(bad);              // also: the block's copy issued
  if (threadIdx.x == 0) {
    if (bad) atomicOr(scratch + 2, 1u);
    __threadfence();                        // the copy visible to the card
    s_ticket = static_cast<int>(atomicAdd(scratch, 1u));
  }
  __syncthreads();
  const int w = s_ticket - (blocks - waiters);
  if (w < 0) return;
  if (threadIdx.x == 0) {
    while (load_acquire(scratch) < static_cast<unsigned>(blocks)) __nanosleep(64);
    __threadfence();
    s_flagged = static_cast<int>(load_acquire(scratch + 2));
  }
  __syncthreads();
  if (s_flagged)
    walk_dropped<T>(x, dropped, nd, k, vecs,
                    static_cast<int64_t>(w) * COPY_THREADS,
                    static_cast<int64_t>(waiters) * COPY_THREADS,
                    [&](int i, int v, const Vec<T>& h) {
                      if (!any_nonfinite<T>(h)) return;
                      typename T::raw* dst = reinterpret_cast<typename T::raw*>(
                          out + static_cast<int64_t>(slot[i]) * vecs + v);
#pragma unroll
                      for (int c = 0; c < T::VEC; ++c)
                        if (!T::finite(h.el[c])) dst[c] = T::nan();
                    });
  __syncthreads();
  if (threadIdx.x == 0 &&
      atomicAdd(scratch + 1, 1u) == static_cast<unsigned>(waiters - 1)) {
    scratch[0] = 0u;                        // every waiter is past its wait
    scratch[1] = 0u;
    scratch[2] = 0u;
  }
}

// --------------------------------------------------------------- combine
// Block b combines tokens [b*tpb, ...); k <= KM choices a token (KM 4 or 8:
// the registers of the k loads in flight decide how many threads an SM
// holds).
template <typename T, int KM>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const uint4* __restrict__ ho, const int* __restrict__ slot,
               const bool* __restrict__ keep, const float* __restrict__ gates,
               const int* __restrict__ top_e, int n, int k, int vecs, int tpb,
               uint4* __restrict__ out) {
  __shared__ int s_slot[MAX_TOKENS][KM];
  __shared__ float s_wt[MAX_TOKENS][KM];
  const int t0 = blockIdx.x * tpb;
  const int nt = tpb < n - t0 ? tpb : n - t0;
  if (threadIdx.x < nt) {
    const int64_t t = t0 + threadIdx.x;
    int ex[KM], sl[KM];
    float wt[KM];
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      if (j < k) {
        const int64_t idx = t * k + j;
        ex[j] = top_e[idx];
        sl[j] = slot[idx];
        // gate * keep in fp32, rounded to the compute dtype
        wt[j] = T::f(T::r(__fmul_rn(gates[idx], keep[idx] ? 1.f : 0.f)));
      } else {
        ex[j] = 0x7fffffff;                 // padding sorts last
        sl[j] = 0;
        wt[j] = 0.f;
      }
    }
#pragma unroll
    for (int round = 0; round < KM; ++round) {
#pragma unroll
      for (int p = round & 1; p + 1 < KM; p += 2) {
        if (ex[p] > ex[p + 1]) {            // stable: swaps only on >
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
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      s_slot[threadIdx.x][j] = sl[j];
      s_wt[threadIdx.x][j] = wt[j];
    }
  }
  __syncthreads();
  for (int f = threadIdx.x; f < nt * vecs; f += COMBINE_THREADS) {
    const int tt = f / vecs, v = f - tt * vecs;
    uint4 h[KM];
#pragma unroll
    for (int j = 0; j < KM; ++j)
      if (j < k) h[j] = ho[static_cast<int64_t>(s_slot[tt][j]) * vecs + v];
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KM; ++j)
      if (j < k) Terms<T>::add(acc, h[j], s_wt[tt][j]);
    out[static_cast<int64_t>(t0 + tt) * vecs + v] = Terms<T>::out(acc);
  }
}

// ------------------------------------------------------------- gate_grad
// acc + cdt(x * y), rounded to the compute dtype: one term of a window
template <typename T>
__device__ __forceinline__ float window_add(float acc, float x, float y) {
  return T::f(T::r(__fadd_rn(acc, T::f(T::r(__fmul_rn(x, y))))));
}

// Warp w of block b takes entry i = b*GATE_WARPS + w (token i / k, row
// slot[i]), in XLA:CPU's order for the row sum (ref.xla_row_sum).  Lane l
// takes windows l, l + 32, ... of WINDOW elements (D a multiple of WINDOW:
// no padding), loads each window's vectors of dout and ho, and sums its
// products in order from +0, each product and each add rounded to the
// compute dtype, into the warp's shared row.  While more than WINDOW sums
// remain, lane u sums window u of them (padded with pad / 2 zeros in front,
// which add nothing) and the warp writes them back; lane 0 sums what is
// left in order and writes +0 + sum * keep.
template <typename T>
__global__ void __launch_bounds__(GATE_THREADS)
gate_grad_kernel(const uint4* __restrict__ dout, const uint4* __restrict__ ho,
                 const int* __restrict__ slot, const bool* __restrict__ keep,
                 int nk, int k, int d, float* __restrict__ out) {
  constexpr int VPW = WINDOW / T::VEC;     // vectors a window
  __shared__ float s_sum[GATE_WARPS][GATE_MAX_WINDOWS];
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int i = blockIdx.x * GATE_WARPS + warp;
  const int lane = threadIdx.x & 31;
  if (i >= nk) return;                      // the whole warp
  const int windows = d / WINDOW;
  const uint4* a = dout + static_cast<int64_t>(i / k) * (windows * VPW);
  const uint4* b = ho + static_cast<int64_t>(slot[i]) * (windows * VPW);
  float* sum = s_sum[warp];
  for (int w = lane; w < windows; w += 32) {
    uint4 ha[VPW], hb[VPW];
#pragma unroll
    for (int u = 0; u < VPW; ++u) {
      ha[u] = a[w * VPW + u];
      hb[u] = b[w * VPW + u];
    }
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < VPW; ++u) {
      const typename T::raw* x = reinterpret_cast<const typename T::raw*>(&ha[u]);
      const typename T::raw* y = reinterpret_cast<const typename T::raw*>(&hb[u]);
#pragma unroll
      for (int c = 0; c < T::VEC; ++c) acc = window_add<T>(acc, T::f(x[c]), T::f(y[c]));
    }
    sum[w] = acc;
  }
  __syncwarp();
  int n = windows;
  while (n > WINDOW) {
    const int pad = (WINDOW - n % WINDOW) % WINDOW;
    const int m = (n + pad) / WINDOW;       // <= 32: GATE_MAX_WINDOWS <= 1024
    float acc = 0.f;
    if (lane < m) {
      for (int j = 0; j < WINDOW; ++j) {
        const int at = lane * WINDOW - pad / 2 + j;
        if (at >= 0 && at < n) acc = T::f(T::r(__fadd_rn(acc, sum[at])));
      }
    }
    __syncwarp();
    if (lane < m) sum[lane] = acc;
    __syncwarp();
    n = m;
  }
  if (lane == 0) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = T::f(T::r(__fadd_rn(acc, sum[j])));
    out[i] = __fadd_rn(0.f, __fmul_rn(acc, keep[i] ? 1.f : 0.f));
  }
}

// The launch floor's kernel (a parameter, as every entry has some).
__global__ void empty_kernel(int) {}

// ---------------------------------------------------------------- launch
struct Geometry {
  int blocks, threads, cluster;             // cluster 0: an ordinary launch
  int per_block;                            // route: entries; dispatch,
                                            // combine_grad and combine:
                                            // tokens; gate_grad: entries
};

// The largest cluster of route blocks the card co-schedules (16, 8, ...),
// probed once: any size gives the same result.
int route_cluster_max() {
  static const int value = [] {
    cudaFuncSetAttribute(route_cluster_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaFuncSetAttribute(empty_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    for (int c = MAX_CLUSTER; c > 1; c /= 2) {
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = c;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(c);
      cfg.blockDim = dim3(ROUTE_THREADS);
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      int clusters = 0;
      if (cudaOccupancyMaxActiveClusters(&clusters, route_cluster_kernel,
                                         &cfg) == cudaSuccess &&
          clusters > 0)
        return c;
      cudaGetLastError();
    }
    return 1;
  }();
  return value;
}

int elem_bytes(int dtype) { return dtype == 1 ? 2 : 4; }

int div_up(int a, int b) { return (a + b - 1) / b; }

// The dispatch by token (x past ROWS_IN_L2), else its rows in order.
bool by_token(int n, int d, int dtype) {
  return static_cast<long long>(n) * d * elem_bytes(dtype) > ROWS_IN_L2;
}

// The tokens a token block takes: COPY_UNROLL vectors a thread, at most
// COPY_TOKENS, and few enough that N makes COPY_SPREAD blocks or more.
int token_block(int n, int vecs) {
  int tpb = COPY_THREADS * COPY_UNROLL / vecs;
  if (tpb > COPY_TOKENS) tpb = COPY_TOKENS;
  if (tpb > n / COPY_SPREAD) tpb = n / COPY_SPREAD;
  return tpb < 1 ? 1 : tpb;
}

// The dispatch's zero blocks: a warp a row of the buffer, at most
// ZERO_BLOCKS (the rows no entry fills are fewer).
int zero_blocks(int e, int cap) {
  const int b = div_up(e * cap, COPY_WARPS);
  return b < ZERO_BLOCKS ? b : ZERO_BLOCKS;
}

Geometry geometry(int entry, int n, int k, int d, int e, int cap, int dtype) {
  const int nk = n * k;
  const int vecs = d * elem_bytes(dtype) / 16;
  if (entry == ROUTE) {
    if (nk <= WARP_ENTRIES) return {1, 32, 0, nk};
    const int cmax = route_cluster_max();
    const int c = div_up(nk, ROUTE_THREADS) < cmax ? div_up(nk, ROUTE_THREADS)
                                                   : cmax;
    return {c, ROUTE_THREADS, c, div_up(nk, c)};
  }
  if (entry == DISPATCH || entry == COMBINE_GRAD) {
    if (!by_token(n, d, dtype)) {
      const int rpb = vecs < COPY_THREADS * COPY_UNROLL
                          ? COPY_THREADS * COPY_UNROLL / vecs : 1;
      return {div_up(e * cap, rpb), COPY_THREADS, 0, rpb};
    }
    return {zero_blocks(e, cap) + div_up(n, token_block(n, vecs)),
            COPY_THREADS, 0, token_block(n, vecs)};
  }
  if (entry == GATE_GRAD) return {div_up(nk, GATE_WARPS), GATE_THREADS, 0, GATE_WARPS};
  int tpb = COMBINE_THREADS / vecs;
  tpb = tpb < 1 ? 1 : (tpb > MAX_TOKENS ? MAX_TOKENS : tpb);
  return {div_up(n, tpb), COMBINE_THREADS, 0, tpb};
}

template <typename... P, typename... A>
int launch(void (*kernel)(P...), Geometry g, cudaStream_t stream, A... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = g.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.blocks);
  cfg.blockDim = dim3(g.threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = g.cluster > 0 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

bool bad_route(int n, int k, int e, int cap) {
  return n < 1 || k < 1 || k > MAX_K || e < 1 || e > MAX_E || cap < 1;
}

bool bad_rows(int d, int dtype) {
  return d < 1 || (dtype != 0 && dtype != 1) || (d * elem_bytes(dtype)) % 16;
}

bool bad_entry(int entry, int n, int k, int d, int e, int cap, int dtype) {
  return entry < ROUTE || entry > GATE_GRAD || bad_route(n, k, e, cap) ||
         bad_rows(d, dtype);
}

// The dispatch's launch (WEIGHTED: combine_grad's), its order by_token's.
template <bool WEIGHTED>
int launch_dispatch(const void* x, const int* rows, const int* slot,
                    const int* stats, const int* dropped, const float* gates,
                    int n, int k, int d, int e, int cap, int dtype,
                    int may_drop, unsigned* scratch, void* out,
                    cudaStream_t stream) {
  const int vecs = d * elem_bytes(dtype) / 16;
  const Geometry g = geometry(WEIGHTED ? COMBINE_GRAD : DISPATCH, n, k, d, e,
                              cap, dtype);
  const bool tok = by_token(n, d, dtype);
  const int zb = tok ? zero_blocks(e, cap) : 0;
  auto go = [&](auto kernel) {
    return launch(kernel, g, stream, static_cast<const uint4*>(x), rows, slot,
                  stats, dropped, gates, n, k, e, cap, vecs, g.per_block, zb,
                  may_drop, scratch, static_cast<uint4*>(out));
  };
  if (dtype == 1)
    return tok ? go(dispatch_kernel<BF16, WEIGHTED, true>)
               : go(dispatch_kernel<BF16, WEIGHTED, false>);
  return tok ? go(dispatch_kernel<F32, WEIGHTED, true>)
             : go(dispatch_kernel<F32, WEIGHTED, false>);
}

}  // namespace

extern "C" int moe_route_sm90(const int* top_e, int n, int k, int e, int cap,
                              int* slot, bool* keep, int* rows, int* stats,
                              int* dropped, unsigned* scratch,
                              cudaStream_t stream) {
  if (bad_route(n, k, e, cap)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(ROUTE, n, k, 8, e, cap, 1);
  if (g.cluster == 0)
    return launch(route_warp_kernel, g, stream, top_e, n * k, e, cap, slot,
                  keep, rows, stats, dropped, scratch);
  return launch(route_cluster_kernel, g, stream, top_e, n * k, e, cap,
                g.per_block, slot, keep, rows, stats, dropped, scratch);
}

// dtype: 0 float32, 1 bfloat16.  x (n, d), out (e * cap, d).  may_drop 0:
// the caller knows no entry dropped (each token's k experts distinct and in
// range, cap >= n), and the non-finite tail is not run.  scratch: the
// routing's two counters, 0 on entry and on exit.
extern "C" int moe_dispatch_sm90(const void* x, const int* rows,
                                 const int* slot, const int* stats,
                                 const int* dropped, int n, int k, int d,
                                 int e, int cap, int dtype, int may_drop,
                                 unsigned* scratch, void* out,
                                 cudaStream_t stream) {
  if (bad_entry(DISPATCH, n, k, d, e, cap, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dispatch<false>(x, rows, slot, stats, dropped, nullptr, n, k,
                                d, e, cap, dtype, may_drop, scratch, out,
                                stream);
}

// The combine's cotangent for ho: dout (n, d), gates (n, k) float32, out
// (e * cap, d); the routing's arrays and counters as for the dispatch.
extern "C" int moe_combine_grad_sm90(const void* dout, const int* rows,
                                     const int* slot, const int* stats,
                                     const int* dropped, const float* gates,
                                     int n, int k, int d, int e, int cap,
                                     int dtype, int may_drop,
                                     unsigned* scratch, void* out,
                                     cudaStream_t stream) {
  if (bad_entry(COMBINE_GRAD, n, k, d, e, cap, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dispatch<true>(dout, rows, slot, stats, dropped, gates, n, k,
                               d, e, cap, dtype, may_drop, scratch, out,
                               stream);
}

// ho (rows, d), gates (n, k) float32, out (n, d).
extern "C" int moe_combine_sm90(const void* ho, const int* slot,
                                const bool* keep, const float* gates,
                                const int* top_e, int n, int k, int d,
                                int dtype, void* out, cudaStream_t stream) {
  if (bad_entry(COMBINE, n, k, d, 1, 1, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vecs = d * elem_bytes(dtype) / 16;
  const Geometry g = geometry(COMBINE, n, k, d, 1, 1, dtype);
  const uint4* h = static_cast<const uint4*>(ho);
  uint4* o = static_cast<uint4*>(out);
  if (dtype == 1 && k <= 4)
    return launch(combine_kernel<BF16, 4>, g, stream, h, slot, keep, gates,
                  top_e, n, k, vecs, g.per_block, o);
  if (dtype == 1)
    return launch(combine_kernel<BF16, 8>, g, stream, h, slot, keep, gates,
                  top_e, n, k, vecs, g.per_block, o);
  if (k <= 4)
    return launch(combine_kernel<F32, 4>, g, stream, h, slot, keep, gates,
                  top_e, n, k, vecs, g.per_block, o);
  return launch(combine_kernel<F32, 8>, g, stream, h, slot, keep, gates,
                top_e, n, k, vecs, g.per_block, o);
}

// The combine's cotangent for the gates: dout (n, d), ho (rows, d), out
// (n, k) float32; d a multiple of WINDOW, at most WINDOW * GATE_MAX_WINDOWS.
extern "C" int moe_gate_grad_sm90(const void* dout, const void* ho,
                                  const int* slot, const bool* keep, int n,
                                  int k, int d, int dtype, float* out,
                                  cudaStream_t stream) {
  if (bad_entry(GATE_GRAD, n, k, d, 1, 1, dtype) || d % WINDOW ||
      d > WINDOW * GATE_MAX_WINDOWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(GATE_GRAD, n, k, d, 1, 1, dtype);
  const uint4* a = static_cast<const uint4*>(dout);
  const uint4* b = static_cast<const uint4*>(ho);
  if (dtype == 1)
    return launch(gate_grad_kernel<BF16>, g, stream, a, b, slot, keep, n * k,
                  k, d, out);
  return launch(gate_grad_kernel<F32>, g, stream, a, b, slot, keep, n * k, k,
                d, out);
}

// entry 0 route, 1 dispatch, 2 combine, 3 combine_grad, 4 gate_grad:
// out[0..3] = blocks, threads, cluster size (0: an ordinary launch) and
// entries / tokens / tokens / tokens / entries a block (dispatch and
// combine_grad: a token block's; the zero blocks come first).
extern "C" int moe_geometry_sm90(int entry, int n, int k, int d, int e,
                                 int cap, int dtype, int* out) {
  if (bad_entry(entry, n, k, d, e, cap, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(entry, n, k, d, e, cap, dtype);
  out[0] = g.blocks;
  out[1] = g.threads;
  out[2] = g.cluster;
  out[3] = g.per_block;
  return static_cast<int>(cudaGetLastError());
}

// The launch floor: an empty kernel launched as the entry launches.
extern "C" int moe_floor_sm90(int entry, int n, int k, int d, int e, int cap,
                              int dtype, cudaStream_t stream) {
  if (bad_entry(entry, n, k, d, e, cap, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(empty_kernel, geometry(entry, n, k, d, e, cap, dtype), stream,
                0);
}
