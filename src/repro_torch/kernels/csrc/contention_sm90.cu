// The contention fixpoint of a bucket of plans, redesigned for Hopper:
// max-min fair fluid transfers priced against a float64 replay of each
// plan's DAG, with every transfer's state in registers and one reduction
// a filling round.  CUDA C++ for sm_90a; the card path of
// kernels/contention/contention.py.
//
// Replaces the JAX package's jitted whole-bucket fixpoint
//   src/repro/sim/batch.py::_contended_durations (:489), a vmap over plans
//   of CONTENTION_ITERS rounds, each a lax.scan replay of the augmented DAG
//   and the fluid solve
//   src/repro/sim/network.py::fluid_finishes_jax (:512), 3T + 4 event
//   steps, each re-solving the rates with
//   src/repro/sim/network.py::_maxmin_rates_jax (:473), num_links rounds
//   of masked progressive filling.
// It replaced the first port of the same function (a block-wide kernel
// with per-transfer arrays in shared memory, called "the first port"
// below), which was deleted once this one matched it bit for bit.
//
// It computes what contention/ref.py::contended_durations_ref computes, bit
// for bit, and writes the same per-plan counts as the first port with the
// same meaning (rounds, events, filling rounds, replay steps), plus the
// events whose min rode on their last filling round's reduction.  Every
// float64 operation is __dadd_rn / __dsub_rn / __dmul_rn / __ddiv_rn in the
// reference's order (nothing contracts into an FMA) with the reference's
// thresholds (remaining <= EPS capacity + EPS, starts <= t + EPS, used >=
// capacity - EPS); every reduction is a min, an OR or a sum of 0/1
// weights, exact in any order.
//
// What bounds it on the H100: two chains of dependent steps a plan, as in
// the first port: the replay walks n_pad steps a round, and the fluid solve
// runs its events one after another, each one or more filling rounds.
// The first port spent about 1.3 us a round against a 0.35-0.50 us
// barrier-and-min: five passes over per-transfer arrays in shared memory,
// 2 L warp reductions, and a second barrier an event for the event's min.
// Design:
//   * One plan a block.  The DAG's records stay in shared memory as in
//     the first port (finish times with a zero cell at n_pad, step records,
//     the slots' delays, the transfers' durations for those delays); the
//     replay walk is the first port's, warp 0 over the order.
//   * Transfer state in registers: thread tid owns transfers tid + k nt,
//     k < K (a template parameter), and holds each one's start, remaining
//     bytes, rate, finish and its links and flags in registers.  The starts
//     are read from the finish column once a round, the durations written
//     back once a round; no per-event pass touches shared memory.
//   * One reduction a filling round.  Each thread keeps its unfrozen flows'
//     per-link counts packed in 64 bits (8 bits a link where a warp's sum
//     stays below 256, i.e. K <= 2; else 16) and updates them as flows
//     start and freeze, so a round's counts are one or two redux.sync adds
//     a warp.  Beside them the reduction carries the min of the event's
//     candidates: a transfer still to start offers its start, an active
//     one t + remaining / max(rate, tiny) as soon as it freezes (its rate
//     is final from then on).  The flows a thread freezes in one round
//     share one rate (every unfrozen flow gets the same incs from 0,
//     rounded the same way) and the candidate is monotone in remaining,
//     so their least candidate is the one of their least remaining bytes,
//     exactly: one division a thread a round, not one a flow.  When the
//     counts show no unfrozen flow, every rate is final and the min is the
//     event's time: no second reduction.  Only an event whose filling loop
//     ended on the guard or on its round limit pays one more (min-only)
//     round.
//   * inc from one division a lane: lane l of each group of the plan's
//     links (rounded up to a power of two) holds link l's used capacity and
//     divides its headroom by its count, and a butterfly of shuffles over
//     the group takes the min, so every lane holds it (a min of correctly rounded quotients
//     is exact in any order); the first port ran the L divisions one after
//     another on every thread, about 770 cycles a filling round.  The
//     saturated links and "did a flow freeze" are two votes.
//   * A float64 min through integer redux.sync: the double's order-keeping
//     64-bit key, the min of the high words, then of the low words among
//     the lanes that hold it; NaN, which the key would lose, by a vote, so
//     the min is NaN when any candidate is (as dmin keeps it).
//   * One warp per plan up to 32 transfers: no __syncthreads in the event
//     loop, one warp-wide reduction a round.  Above it, a block of
//     threads_for(T_pad) threads: the warps' sums meet in shared memory
//     behind one barrier and every warp reduces them again with redux.sync
//     (whose cost does not grow with the lanes that hold a value, so the
//     block stage costs the same at 2 warps and at 16).
//   * Stops as in the first port: the filling loop once nothing is
//     unfrozen, the event loop once t_ev is not finite, the rounds once the
//     plan's durations froze.  tests/contention_emulation.py emulates this
//     loop (ownership, packed counts, the merged round) against the plain
//     version bit for bit.
//
// C interface (loaded with ctypes): contention_sm90_durations_f64 returns
// the cudaError_t of the shared-memory attribute call or of the launch as
// an int, 0 on success, and writes (B, T_pad) durations and (B, COUNTS)
// int32 counts, on contention_sm90_threads(T_pad) threads a block.
// contention_sm90_split_f64 is the
// same launch with the split variant (the template flag SPLIT), which also
// writes (B, PHASES) int64 clock64() cycles of thread 0 per phase, for
// timing only.  contention_sm90_smem_bytes gives the bytes a launch takes;
// contention_sm90_chain_probe times one replay step and one combined
// count-and-min reduction.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "contention_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_K = 16;                   // transfers a thread may own
// The block, a function of T_pad alone: one warp up to 32 transfers (at
// T_pad 64, two warps of one transfer a thread beat one warp of two on the
// H100, PERF.md §6); then a thread a transfer up to BLOCK_THREADS; then
// BLOCK_THREADS with K = 2 (at T_pad 1024, 512 threads beat 256 and 128,
// and 1024 was slowest); past 2 BLOCK_THREADS transfers WIDE_THREADS with
// K = 8 or 16, from the register counts alone (ptxas: 170 and 248 a
// thread, so at most 256 threads a block; no T_pad above 1024 was timed).
constexpr int BLOCK_THREADS = 512;
constexpr int WIDE_THREADS = 256;
constexpr int MAX_T_PAD = WIDE_THREADS * MAX_K;
constexpr int COUNTS = 5;                   // rounds, events, fills, steps, merged
constexpr int WORDS = 4;                    // 32-bit words of a reduction's counts

// A transfer's links and flags, in one register: the uplink in bits 0-3,
// the downlink in bits 4-7, the flags above.
constexpr unsigned F_MASK = 1u << 8, F_LIVE = 1u << 9, F_FINISHED = 1u << 10,
                   F_ACTIVE = 1u << 11, F_UNFROZEN = 1u << 12, F_LINKS = 0xffu;

// The threads of a block whose threads own K transfers each.
__host__ __device__ constexpr int block_threads(int k) {
  return k <= 2 ? BLOCK_THREADS : WIDE_THREADS;
}

__host__ __device__ inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__host__ __device__ inline int threads_for(int t_pad) {
  if (t_pad <= 32) return 32;
  if (t_pad > 2 * BLOCK_THREADS) return WIDE_THREADS;
  const int t = (t_pad + 31) / 32 * 32;
  return t < BLOCK_THREADS ? t : BLOCK_THREADS;
}

__host__ __device__ inline int64_t round8(int64_t x) { return (x + 7) & ~7LL; }

// Byte offsets of the shared layout: doubles first, then 32-bit words.
struct Layout {
  int64_t finish, time, pd, dur, red_min, red_cnt, task, slot, tid, bytes;
};

__host__ __device__ inline Layout layout(int n_pad, int p_pad, int t_pad) {
  const int64_t slots = static_cast<int64_t>(n_pad) * p_pad;
  Layout l;
  int64_t at = 0;
  l.finish = at;  at += 8LL * (n_pad + 1);
  l.time = at;    at += 8LL * n_pad;
  l.pd = at;      at += 8 * slots;
  l.dur = at;     at += 8LL * t_pad;
  l.red_min = at; at += 8LL * 2 * MAX_WARPS;
  l.red_cnt = at; at += 4LL * 2 * MAX_WARPS * WORDS;
  l.task = at;    at += 4LL * n_pad;
  l.slot = at;    at += 4 * slots;
  l.tid = at;     at += 4 * slots;
  l.bytes = round8(at);
  return l;
}

// A thread's per-link counts of its unfrozen flows, FB bits a link: with
// FB = 8 `lo` holds all eight links, with FB = 16 links 0-3 and `hi` 4-7.
struct Packed {
  unsigned long long lo = 0, hi = 0;
};

// What one flow adds to its links' counts (twice to one link if up = dn).
template <int FB>
__device__ __forceinline__ Packed contrib(unsigned f) {
  const unsigned u = f & 15u, d = (f >> 4) & 15u;
  Packed c;
  if constexpr (FB == 8) {
    c.lo = (1ull << (8 * u)) + (1ull << (8 * d));
  } else {
    c.lo = (u < 4 ? 1ull << (16 * u) : 0ull) + (d < 4 ? 1ull << (16 * d) : 0ull);
    c.hi = (u >= 4 ? 1ull << (16 * (u - 4)) : 0ull) + (d >= 4 ? 1ull << (16 * (d - 4)) : 0ull);
  }
  return c;
}

// The double's bits as a key whose unsigned order is the double's order.
__device__ __forceinline__ unsigned long long dkey(double x) {
  const unsigned long long u = static_cast<unsigned long long>(__double_as_longlong(x));
  return (u >> 63) ? ~u : u | 0x8000000000000000ull;
}
__device__ __forceinline__ double dunkey(unsigned long long k) {
  return __longlong_as_double(
      static_cast<long long>((k >> 63) ? k & 0x7fffffffffffffffull : ~k));
}

// Min over the warp, NaN if any lane holds NaN (as dmin keeps it); every
// lane gets it.  Two redux.sync mins (the keys' high words, then the low
// words of the lanes holding the least high word) and a vote.
__device__ __forceinline__ double warp_min(double x) {
  const bool nan = x != x;
  const unsigned long long k = nan ? ~0ull : dkey(x);
  const unsigned hi = static_cast<unsigned>(k >> 32);
  const unsigned mh = __reduce_min_sync(FULL, hi);
  const unsigned ml = __reduce_min_sync(FULL, hi == mh ? static_cast<unsigned>(k) : FULL);
  if (__any_sync(FULL, nan)) return __longlong_as_double(0x7ff8000000000000ll);
  return dunkey((static_cast<unsigned long long>(mh) << 32) | ml);
}

// The counts of link l from 16-bit fields, two links a word.
__device__ __forceinline__ unsigned field16(const unsigned (&x)[WORDS], int l) {
  return (x[l >> 1] >> (16 * (l & 1))) & 0xffffu;
}

// One reduction of a filling round: the per-link sums of every thread's
// packed counts (into cnt) and the min of every thread's candidate (the
// return value), on every thread.  WARP: the warp alone; else the warps'
// results meet in shared memory behind one barrier (double-buffered by
// `parity`, so one call's writes never meet the last call's reads) and
// every warp reduces them again.
template <int FB, bool WARP>
__device__ __forceinline__ double reduce_round(const Packed& acc, double cand, int num_links,
                                               unsigned (&cnt)[MAX_LINKS], double* red_min,
                                               unsigned* red_cnt, int& parity, int lane,
                                               int warp, int nwarps) {
  // words of the thread's counts that hold a link of this plan
  const int words = FB == 8 ? (num_links + 3) >> 2 : (num_links + 1) >> 1;
  const unsigned v[WORDS] = {static_cast<unsigned>(acc.lo), static_cast<unsigned>(acc.lo >> 32),
                             static_cast<unsigned>(acc.hi), static_cast<unsigned>(acc.hi >> 32)};
  unsigned w[WORDS];
#pragma unroll
  for (int j = 0; j < WORDS; ++j)
    w[j] = (j < words && (FB == 16 || j < 2)) ? __reduce_add_sync(FULL, v[j]) : 0u;
  double m = warp_min(cand);
  unsigned x[WORDS];   // 16-bit fields, two links a word
  if constexpr (!WARP) {
    unsigned* bc = red_cnt + (parity * MAX_WARPS + warp) * WORDS;
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < WORDS; ++j) bc[j] = w[j];
      red_min[parity * MAX_WARPS + warp] = m;
    }
    __syncthreads();
    const bool mine = lane < nwarps;
    const unsigned* rc = red_cnt + (parity * MAX_WARPS + (mine ? lane : 0)) * WORDS;
    m = warp_min(mine ? red_min[parity * MAX_WARPS + lane] : INFINITY);
    if constexpr (FB == 8) {
      // each warp's 8-bit fields widened to 16 bits: links 4j, 4j + 2 and
      // 4j + 1, 4j + 3 of word j
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const unsigned y = mine && j < words ? rc[j] : 0u;
        x[2 * j] = j < words ? __reduce_add_sync(FULL, y & 0x00ff00ffu) : 0u;
        x[2 * j + 1] = j < words ? __reduce_add_sync(FULL, (y >> 8) & 0x00ff00ffu) : 0u;
      }
    } else {
#pragma unroll
      for (int j = 0; j < WORDS; ++j)
        x[j] = j < words ? __reduce_add_sync(FULL, mine ? rc[j] : 0u) : 0u;
    }
    parity ^= 1;
  }
#pragma unroll
  for (int l = 0; l < MAX_LINKS; ++l) {
    if constexpr (WARP && FB == 8) {
      cnt[l] = (w[l >> 2] >> (8 * (l & 3))) & 0xffu;
    } else if constexpr (WARP) {
      cnt[l] = field16(w, l);
    } else if constexpr (FB == 16) {
      cnt[l] = field16(x, l);
    } else {
      const int j = l >> 2, p = l & 3;
      cnt[l] = (x[2 * j + (p & 1)] >> (16 * (p >> 1))) & 0xffffu;
    }
  }
  return m;
}

template <bool WARP>
__device__ __forceinline__ void sync_plan() {
  if constexpr (WARP) __syncwarp();
  else __syncthreads();
}

template <int K, bool WARP, bool SPLIT>
__global__ void __launch_bounds__(WARP ? 32 : block_threads(K), 1)
contention_sm90_kernel(const int* __restrict__ order, const int* __restrict__ pred,
                       const bool* __restrict__ pmask, const int* __restrict__ ptid,
                       const double* __restrict__ times, const int* __restrict__ src,
                       const double* __restrict__ size, const int* __restrict__ up,
                       const int* __restrict__ dn, const bool* __restrict__ tmask,
                       const double* __restrict__ capacity, double* __restrict__ out,
                       int* __restrict__ counts, long long* __restrict__ split, int n_pad,
                       int p_pad, int t_pad, int num_links, int iters) {
  constexpr int FB = 64 * K <= 255 ? 8 : 16;   // bits of a link's count in a warp's sum
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(n_pad, p_pad, t_pad);
  double* finish = reinterpret_cast<double*>(smem + lay.finish);
  double* time_s = reinterpret_cast<double*>(smem + lay.time);
  double* pd = reinterpret_cast<double*>(smem + lay.pd);
  double* dur = reinterpret_cast<double*>(smem + lay.dur);
  double* red_min = reinterpret_cast<double*>(smem + lay.red_min);
  unsigned* red_cnt = reinterpret_cast<unsigned*>(smem + lay.red_cnt);
  int* task = reinterpret_cast<int*>(smem + lay.task);
  int* slot = reinterpret_cast<int*>(smem + lay.slot);
  int* stid = reinterpret_cast<int*>(smem + lay.tid);

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int64_t nslots = static_cast<int64_t>(n_pad) * p_pad;
  order += static_cast<int64_t>(b) * n_pad;
  pred += b * nslots;
  pmask += b * nslots;
  ptid += b * nslots;
  times += static_cast<int64_t>(b) * n_pad;
  src += static_cast<int64_t>(b) * t_pad;
  size += static_cast<int64_t>(b) * t_pad;
  up += static_cast<int64_t>(b) * t_pad;
  dn += static_cast<int64_t>(b) * t_pad;
  tmask += static_cast<int64_t>(b) * t_pad;
  const double cap = capacity[b];

  // Stage the plan: the order's steps as records, the transfers' durations
  // in shared memory and their links in registers.
  for (int i = tid; i < n_pad; i += nt) {
    const int j = order[i];
    task[i] = j;
    time_s[i] = times[j];
  }
  for (int64_t x = tid; x < nslots; x += nt) {
    const int64_t at = static_cast<int64_t>(order[x / p_pad]) * p_pad + x % p_pad;
    const bool m = pmask[at];
    slot[x] = m ? pred[at] : n_pad;
    stid[x] = m ? ptid[at] : -1;
  }
  unsigned info[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = tid + k * nt;
    info[k] = 0;
    if (i < t_pad) {
      const bool m = tmask[i];
      info[k] = (static_cast<unsigned>(up[i]) & 15u) | (static_cast<unsigned>(dn[i]) & 15u) << 4 |
                (m ? F_MASK : 0u);
      dur[i] = m ? __ddiv_rn(size[i], cap) : 0.0;
    }
  }
  if (tid == 0) finish[n_pad] = 0.0;
  __syncthreads();

  const double thresh = __dadd_rn(__dmul_rn(EPS, cap), EPS);
  const double cap_eps = __dsub_rn(cap, EPS);
  const int width = p_pad >= 32 ? 32 : (p_pad <= 1 ? 1 : 1 << (32 - __clz(p_pad - 1)));
  // inc's butterfly spans the plan's links rounded up to a power of two,
  // and lane l of each such group of lanes keeps link l's used capacity,
  // so every lane ends with the same inc
  const int link_width = pow2_at_least(num_links);
  const int link = lane & (link_width - 1);
  int parity = 0;
  int rounds = 0, events = 0, fills = 0, steps = 0, merged = 0;
  double starts[K], rem[K], rate[K], fin[K];
  unsigned cnt[MAX_LINKS];
  Split<SPLIT> clk;
  clk.start();

  for (int r = 0; r < iters; ++r) {
    ++rounds;
    // this round's delays and a fresh finish column
    for (int64_t x = tid; x < nslots; x += nt) {
      const int t = stid[x];
      pd[x] = t >= 0 ? dur[t] : 0.0;
    }
    for (int i = tid; i < n_pad; i += nt) finish[i] = 0.0;
    sync_plan<WARP>();

    // replay: warp 0 walks, its lanes over each step's slots
    if (warp == 0) {
      for (int i = 0; i < n_pad; ++i) {
        double v = 0.0;
        const int64_t row = static_cast<int64_t>(i) * p_pad;
        for (int k = lane; k < p_pad; k += 32)
          v = dmax(v, __dadd_rn(finish[slot[row + k]], pd[row + k]));
        for (int off = width >> 1; off; off >>= 1)
          v = dmax(v, __shfl_xor_sync(FULL, v, off));
        if (lane == 0) finish[task[i]] = __dadd_rn(v, time_s[i]);
        __syncwarp();
      }
    }
    steps += n_pad;
    sync_plan<WARP>();
    clk.stamp(P_REPLAY);

    // the fluid solve at the transfers' starts
    double t0 = INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = tid + k * nt;
      unsigned f = info[k] & (F_LINKS | F_MASK);
      starts[k] = 0.0;
      fin[k] = 0.0;
      rem[k] = 0.0;
      rate[k] = 0.0;
      if (i < t_pad) {
        const double s = finish[src[i]];
        starts[k] = s;
        if (f & F_MASK) {
          const double z = size[i];
          if (z > EPS) {
            f |= F_LIVE;
            rem[k] = z;
          } else {
            f |= F_FINISHED;
          }
          t0 = dmin(t0, s);
          fin[k] = s;
        } else {
          f |= F_FINISHED;
        }
      } else {
        f |= F_FINISHED;
      }
      info[k] = f;
    }
    double t = reduce_round<FB, WARP>(Packed{}, t0, num_links, cnt, red_min, red_cnt, parity,
                                      lane, warp, nwarps);

    for (int ev = 0; ev < 3 * t_pad + 4; ++ev) {
      const double t_eps = __dadd_rn(t, EPS);
      Packed acc;
      double cand = INFINITY;   // the thread's least candidate for the event's time
#pragma unroll
      for (int k = 0; k < K; ++k) {
        unsigned f = info[k] & ~(F_ACTIVE | F_UNFROZEN);
        if ((f & F_LIVE) && !(f & F_FINISHED)) {
          if (starts[k] <= t_eps) {
            f |= F_ACTIVE | F_UNFROZEN;
            const Packed c = contrib<FB>(f);
            acc.lo += c.lo;
            acc.hi += c.hi;
          } else if (starts[k] > t_eps) {
            cand = dmin(cand, starts[k]);
          }
        }
        info[k] = f;
      }
      clk.stamp(P_ACTIVITY);

      double used = 0.0;       // this lane's link's used capacity
      double rate_now = 0.0;   // every unfrozen flow's rate: the same sum of incs
      double t_ev;
      bool last = false;       // the filling loop has ended: a min-only round
      for (int fill = 0;;) {
        t_ev = reduce_round<FB, WARP>(acc, cand, num_links, cnt, red_min, red_cnt, parity, lane,
                                      warp, nwarps);
        if (last) {
          clk.stamp(P_EVENT);
          break;
        }
        clk.stamp(P_COUNT);
        ++fills;
        bool any = false;
        unsigned n_mine = 0;   // the flows on this lane's link
#pragma unroll
        for (int l = 0; l < MAX_LINKS; ++l) {
          any = any || (l < num_links && cnt[l] > 0);
          n_mine = l == link ? cnt[l] : n_mine;
        }
        if (!any) {              // nothing unfrozen: every rate is final, t_ev the event's
          ++merged;
          break;
        }
        // inc: each lane divides for its own link, a butterfly takes the min
        const bool mine = link < num_links && n_mine > 0;
        double inc = mine ? __ddiv_rn(__dsub_rn(cap, used), static_cast<double>(n_mine))
                          : INFINITY;
        for (int off = link_width >> 1; off; off >>= 1)
          inc = dmin(inc, __shfl_xor_sync(FULL, inc, off));
        inc = isfinite(inc) ? inc : 0.0;
        inc = dmax(inc, 0.0);
        if (link < num_links)
          used = __dadd_rn(used, __dmul_rn(inc, static_cast<double>(n_mine)));
        const bool full = link < num_links && used >= cap_eps;
        // lanes 0 to link_width - 1 hold links 0 to link_width - 1
        const unsigned sat = __ballot_sync(FULL, full) & ((1u << link_width) - 1u);
        const bool froze = __any_sync(FULL, full && n_mine > 0);
        clk.stamp(P_INC);
        rate_now = __dadd_rn(rate_now, inc);
        double least = INFINITY;   // the least remaining bytes of the flows freezing now
        bool some = false;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const unsigned f = info[k];
          if ((f & F_UNFROZEN) &&
              (!froze || ((sat >> (f & 15u)) & 1u) || ((sat >> ((f >> 4) & 15u)) & 1u))) {
            info[k] = f & ~F_UNFROZEN;
            const Packed c = contrib<FB>(f);
            acc.lo -= c.lo;
            acc.hi -= c.hi;
            rate[k] = rate_now;
            least = dmin(least, rem[k]);
            some = true;
          }
        }
        // they share one rate, and t + remaining / rate is monotone in
        // remaining: their least finish, exactly, from one division
        if (some) cand = dmin(cand, __dadd_rn(t, __ddiv_rn(least, dmax(rate_now, TINY))));
        clk.stamp(P_RATE);
        ++fill;
        // the guard froze every flow, or the loop ran its rounds: the rates
        // are final and one more round takes the min
        last = !froze || fill == num_links;
      }
      ++events;
      if (!isfinite(t_ev)) break;        // nothing left: every later step is a no-op
      const double t_new = dmax(t_ev, t);
      const double dt = __dsub_rn(t_new, t);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const unsigned f = info[k];
        if (f & F_ACTIVE) {
          rem[k] = __dsub_rn(rem[k], __dmul_rn(rate[k], dt));
          if (rem[k] <= thresh) {
            fin[k] = t_new;
            info[k] = f | F_FINISHED;
          }
        }
      }
      t = t_new;
      clk.stamp(P_REMAIN);
    }

    // new durations, and the plan's freeze
    bool close = true;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = tid + k * nt;
      if (i < t_pad && (info[k] & F_MASK)) {
        const double d = dur[i];
        const double nw = __dsub_rn(fin[k], starts[k]);
        close = close && fabs(__dsub_rn(nw, d)) <= __dadd_rn(1e-9, __dmul_rn(1e-3, fabs(d)));
        dur[i] = nw;
      }
    }
    bool frozen;
    if constexpr (WARP) {
      __syncwarp();
      frozen = __all_sync(FULL, close);
    } else {
      frozen = __syncthreads_and(close);
    }
    clk.stamp(P_REMAIN);
    if (frozen) break;
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = tid + k * nt;
    if (i < t_pad) out[static_cast<int64_t>(b) * t_pad + i] = dur[i];
  }
  if (tid == 0) {
    int* c = counts + static_cast<int64_t>(b) * COUNTS;
    c[0] = rounds;
    c[1] = events;
    c[2] = fills;
    c[3] = steps;
    c[4] = merged;
  }
  clk.write(split, b);
}

// The two links of the new chain, each repeated `steps` times:
//   mode 0 — one dependent replay step through shared memory, as
//     the first port timed it (the walk is unchanged);
//   mode 1 — one combined count-and-min reduction of reduce_round at the
//     kernel's FB and path (a warp alone, or the block behind a barrier),
//     each round's candidate the last round's min plus one.
// `out[0]` keeps the result, so nothing is optimised away.
template <int FB, bool WARP>
__global__ void __launch_bounds__(MAX_THREADS)
sm90_probe_kernel(double* out, int steps, int mode, int width) {
  __shared__ double column[64 + 1];
  __shared__ double red_min[2 * MAX_WARPS];
  __shared__ unsigned red_cnt[2 * MAX_WARPS * WORDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  if (mode == 0) {
    if (warp != 0) return;
    volatile double* fin = column;
    for (int x = lane; x < 65; x += 32) fin[x] = 0.0;
    __syncwarp();
    int p = 0;
    for (int s = 0; s < steps; ++s) {
      double v = lane == 0 ? __dadd_rn(fin[p], 0.25) : 0.0;
      for (int off = width >> 1; off; off >>= 1) v = dmax(v, __shfl_xor_sync(FULL, v, off));
      const int j = (p + 1) & 63;
      if (lane == 0) fin[j] = __dadd_rn(dmax(v, 0.0), 1.0);
      __syncwarp();
      p = j;
    }
    if (lane == 0) out[0] = fin[p];
  } else {
    Packed acc;
    acc.lo = contrib<FB>(0x10u).lo;   // one flow on links 0 and 1
    double a = static_cast<double>(tid);
    unsigned cnt[MAX_LINKS];
    int parity = 0;
    for (int s = 0; s < steps; ++s) {
      a = reduce_round<FB, WARP>(acc, a, 4, cnt, red_min, red_cnt, parity, lane, warp, nwarps);
      a = __dadd_rn(a, cnt[0] > 0 ? 1.0 : 2.0);
    }
    if (tid == 0) out[0] = a;
  }
}

template <int K, bool WARP, bool SPLIT>
int launch_k(const int* order, const int* pred, const bool* pmask, const int* ptid,
             const double* times, const int* src, const double* size, const int* up,
             const int* dn, const bool* tmask, const double* capacity, double* out, int* counts,
             long long* split, int batch, int n_pad, int p_pad, int t_pad, int num_links,
             int iters, int threads, size_t bytes, cudaStream_t stream) {
  static unsigned long long configured = 0;   // devices whose shared-memory limit is raised
  const cudaError_t err =
      allow_smem(contention_sm90_kernel<K, WARP, SPLIT>, SMEM_LIMIT, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  contention_sm90_kernel<K, WARP, SPLIT><<<batch, threads, bytes, stream>>>(
      order, pred, pmask, ptid, times, src, size, up, dn, tmask, capacity, out, counts, split,
      n_pad, p_pad, t_pad, num_links, iters);
  return static_cast<int>(cudaGetLastError());
}

template <bool SPLIT>
int launch_fixpoint(const int* order, const int* pred, const bool* pmask, const int* ptid,
                    const double* times, const int* src, const double* size, const int* up,
                    const int* dn, const bool* tmask, const double* capacity, double* out,
                    int* counts, long long* split, int batch, int n_pad, int p_pad, int t_pad,
                    int num_links, int iters, cudaStream_t stream) {
  if (batch <= 0 || n_pad <= 0 || p_pad <= 0 || t_pad <= 0 || t_pad > MAX_T_PAD ||
      num_links <= 0 || num_links > MAX_LINKS || iters < 0)
    return cudaErrorInvalidValue;
  const int64_t bytes = layout(n_pad, p_pad, t_pad).bytes;
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  const int threads = threads_for(t_pad);
  // K: 1 up to BLOCK_THREADS transfers, 2 up to twice that, then 8 or 16
  const int k = pow2_at_least((t_pad + threads - 1) / threads);
#define CONTENTION_SM90_ARGS                                                                  \
  order, pred, pmask, ptid, times, src, size, up, dn, tmask, capacity, out, counts, split,     \
      batch, n_pad, p_pad, t_pad, num_links, iters, threads, static_cast<size_t>(bytes), stream
  if (threads == 32) return launch_k<1, true, SPLIT>(CONTENTION_SM90_ARGS);
  switch (k) {
    case 1: return launch_k<1, false, SPLIT>(CONTENTION_SM90_ARGS);
    case 2: return launch_k<2, false, SPLIT>(CONTENTION_SM90_ARGS);
    case 8: return launch_k<8, false, SPLIT>(CONTENTION_SM90_ARGS);
    default: return launch_k<16, false, SPLIT>(CONTENTION_SM90_ARGS);
  }
#undef CONTENTION_SM90_ARGS
}

}  // namespace

extern "C" long long contention_sm90_smem_bytes(int n_pad, int p_pad, int t_pad) {
  return layout(n_pad, p_pad, t_pad).bytes;
}

extern "C" int contention_sm90_threads(int t_pad) { return threads_for(t_pad); }

extern "C" int contention_sm90_durations_f64(const int* order, const int* pred,
                                             const bool* pmask, const int* ptid,
                                             const double* times, const int* src,
                                             const double* size, const int* up, const int* dn,
                                             const bool* tmask, const double* capacity,
                                             double* out, int* counts, int batch, int n_pad,
                                             int p_pad, int t_pad, int num_links, int iters,
                                             cudaStream_t stream) {
  return launch_fixpoint<false>(order, pred, pmask, ptid, times, src, size, up, dn, tmask,
                                capacity, out, counts, nullptr, batch, n_pad, p_pad, t_pad,
                                num_links, iters, stream);
}

extern "C" int contention_sm90_split_f64(const int* order, const int* pred, const bool* pmask,
                                         const int* ptid, const double* times, const int* src,
                                         const double* size, const int* up, const int* dn,
                                         const bool* tmask, const double* capacity,
                                         double* out, int* counts, long long* split, int batch,
                                         int n_pad, int p_pad, int t_pad, int num_links,
                                         int iters, cudaStream_t stream) {
  return launch_fixpoint<true>(order, pred, pmask, ptid, times, src, size, up, dn, tmask,
                               capacity, out, counts, split, batch, n_pad, p_pad, t_pad,
                               num_links, iters, stream);
}

// At the block the kernel launches for `t_pad` transfers: its threads
// (32, the warp path) and its K, which fixes the counts' field width (8
// bits up to K = 2, else 16).
extern "C" int contention_sm90_chain_probe(double* out, int steps, int mode, int t_pad,
                                           cudaStream_t stream) {
  if (steps <= 0 || (mode != 0 && mode != 1) || t_pad <= 0 || t_pad > MAX_T_PAD)
    return cudaErrorInvalidValue;
  const int threads = threads_for(t_pad);
  const bool wide = 64 * pow2_at_least((t_pad + threads - 1) / threads) > 255;
  if (threads == 32)   // K = 1
    sm90_probe_kernel<8, true><<<1, threads, 0, stream>>>(out, steps, mode, 4);
  else if (wide)
    sm90_probe_kernel<16, false><<<1, threads, 0, stream>>>(out, steps, mode, 4);
  else
    sm90_probe_kernel<8, false><<<1, threads, 0, stream>>>(out, steps, mode, 4);
  return static_cast<int>(cudaGetLastError());
}
