// The contention fixpoint of a bucket of plans: max-min fair fluid
// transfers priced against a float64 replay of each plan's DAG.  CUDA C++
// for sm_90a; the card path of kernels/contention/contention.py.
//
// Replaces the JAX package's jitted whole-bucket fixpoint
//   src/repro/sim/batch.py::_contended_durations (:489), a vmap over plans
// of CONTENTION_ITERS rounds, each a lax.scan replay of the augmented DAG
// and the fluid solve
//   src/repro/sim/network.py::fluid_finishes_jax (:512), 3T + 4 event
//   steps, each re-solving the rates with
//   src/repro/sim/network.py::_maxmin_rates_jax (:473), num_links rounds
//   of masked progressive filling.
//
// It computes what contention/ref.py::contended_durations_ref computes, bit
// for bit.  Every reduction of the fixpoint is a min (inc, t_done, t_next),
// an OR (froze, close) or a sum of 0/1 weights (the flows on a link), all
// exact in any order; every other operation is one IEEE float64 operation
// rounded once, written with __dadd_rn / __dsub_rn / __dmul_rn / __ddiv_rn
// so that nvcc contracts nothing into an FMA.  The threshold tests are
// written as the reference writes them (remaining <= EPS capacity + EPS,
// starts <= t + EPS, used >= capacity - EPS): one ulp there flips an event.
//
// What bounds it on the H100: neither bytes (a plan's inputs are a few
// tens of KB, read once) nor operations (a few per transfer and event), but
// two chains of dependent steps a plan: the replay walks n_pad steps a
// round, each waiting on the finish times of its predecessors, and the
// fluid solve runs its events one after another, each a few block-wide
// reductions (the flows on each link per filling round, the next event's
// time).  chip_smoke.py times both links of these chains with
// contention_chain_probe and reports the chain floor from the per-plan
// counts the kernel writes.
//
// Design:
//   * One block per plan.  The plan's state lives in dynamic shared memory
//     (contention_smem_bytes): the DAG's finish times with a zero cell at
//     n_pad, the steps of the topological order as records (task, time, the
//     P_pad pred slots with their transfers and this round's delays; a
//     masked slot points at the zero cell with delay +0.0, which adds an
//     exact +0.0 to a max from 0), and per transfer its start, size,
//     remaining bytes, finish, rate, duration, producer, links and flags.
//     Above 48 KB the kernel's shared-memory limit is raised; a layout over
//     227 KB is refused by the wrapper, naming the shape.
//   * Threads run over the transfers, each owning tid, tid + blockDim, ...
//     (blockDim = T_pad rounded up to a warp, at most 512).
//   * Replay: warp 0 walks the order; its lanes run over a step's slots and
//     a butterfly of shuffles takes their max.  The rest of the block waits
//     at the barrier.
//   * Progressive filling: each thread counts its unfrozen flows per link,
//     a warp sums them (redux.sync), the warps' sums meet in shared memory
//     behind one barrier, and every thread then holds the same n_l and keeps
//     its own copy of the links' used capacity in registers, so inc, the
//     saturated links and "did any flow freeze" (a saturated link with a
//     flow on it) need no further barrier.
//   * Events: t_done and t_next are one block-wide min of two values (warp
//     shuffles, then the warps' partials behind one barrier).
//   * Stops that change no value of the fixed-count reference: the fill
//     loop ends once no flow is unfrozen (a further round adds 0 to every
//     rate and used capacity), the event loop once t_ev is infinite (every
//     later step sees the same state and does nothing), and a plan whose
//     durations froze skips its remaining rounds (the reference keeps its
//     durations).  tests/test_torch_contention.py emulates the loop with
//     these stops against the plain version, bit for bit.
//   * Not done: several plans a block for small T, a level-parallel replay,
//     a lighter reduction for the events (ROADMAP B3).
//
// C interface (loaded with ctypes): contention_durations_f64 returns the
// cudaError_t of the shared-memory attribute call or of the launch as an
// int, 0 on success, and writes (B, T_pad) durations and (B, 4) int32
// counts (rounds, events, filling rounds, replay steps); contention_smem_bytes
// the bytes a launch takes; contention_threads the block size;
// contention_chain_probe times the two chain links.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_LINKS = 8;
constexpr int SMEM_LIMIT = 232448;          // 227 KB, the most a block may take
constexpr int COUNTS = 4;                   // rounds, events, fills, replay steps
constexpr double EPS = 1e-12;               // network.py's _EPS
constexpr double TINY = 2.2250738585072014e-308;   // finfo(float64).tiny
constexpr unsigned FULL = 0xffffffffu;

// Transfer flags.
constexpr unsigned char F_MASK = 1, F_LIVE = 2, F_FINISHED = 4, F_ACTIVE = 8,
                        F_UNFROZEN = 16;

__host__ __device__ inline int threads_for(int t_pad) {
  const int t = (t_pad + 31) / 32 * 32;
  return t < MAX_THREADS ? t : MAX_THREADS;
}

__host__ __device__ inline int64_t round8(int64_t x) { return (x + 7) & ~7LL; }

// Byte offsets of the shared layout: doubles first, then ints, then flags.
struct Layout {
  int64_t finish, time, pd, starts, size, remaining, fin, rate, dur, red_dbl;
  int64_t task, slot, tid, src, up, dn, red_int, flags, bytes;
};

__host__ __device__ inline Layout layout(int n_pad, int p_pad, int t_pad) {
  const int64_t slots = static_cast<int64_t>(n_pad) * p_pad;
  Layout l;
  int64_t at = 0;
  l.finish = at;    at += 8LL * (n_pad + 1);
  l.time = at;      at += 8LL * n_pad;
  l.pd = at;        at += 8 * slots;
  l.starts = at;    at += 8LL * t_pad;
  l.size = at;      at += 8LL * t_pad;
  l.remaining = at; at += 8LL * t_pad;
  l.fin = at;       at += 8LL * t_pad;
  l.rate = at;      at += 8LL * t_pad;
  l.dur = at;       at += 8LL * t_pad;
  l.red_dbl = at;   at += 8LL * 2 * MAX_WARPS * 2;
  l.task = at;      at += 4LL * n_pad;
  l.slot = at;      at += 4 * slots;
  l.tid = at;       at += 4 * slots;
  l.src = at;       at += 4LL * t_pad;
  l.up = at;        at += 4LL * t_pad;
  l.dn = at;        at += 4LL * t_pad;
  l.red_int = at;   at += 4LL * 2 * MAX_WARPS * MAX_LINKS;
  l.flags = at;     at += t_pad;
  l.bytes = round8(at);
  return l;
}

// max / min that keep NaN, as torch.maximum / amax and jnp.max do; exact on
// every other pair.
__device__ __forceinline__ double dmax(double a, double b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ double dmin(double a, double b) {
  return (a < b || a != a) ? a : b;
}

// Block-wide min of two values; every thread gets both.  `red` is a
// [2][MAX_WARPS][2] double buffer: the writes of one call and the reads of
// the call before it are split by the barrier of the call in between.
__device__ __forceinline__ void block_min2(double& a, double& b, double* red,
                                           int& parity, int lane, int warp,
                                           int nwarps) {
  for (int off = 16; off; off >>= 1) {
    a = dmin(a, __shfl_xor_sync(FULL, a, off));
    b = dmin(b, __shfl_xor_sync(FULL, b, off));
  }
  double* buf = red + parity * MAX_WARPS * 2;
  if (lane == 0) {
    buf[2 * warp] = a;
    buf[2 * warp + 1] = b;
  }
  __syncthreads();
  a = lane < nwarps ? buf[2 * lane] : INFINITY;
  b = lane < nwarps ? buf[2 * lane + 1] : INFINITY;
  for (int off = 16; off; off >>= 1) {
    a = dmin(a, __shfl_xor_sync(FULL, a, off));
    b = dmin(b, __shfl_xor_sync(FULL, b, off));
  }
  parity ^= 1;
}

__global__ void __launch_bounds__(MAX_THREADS)
contention_kernel(const int* __restrict__ order, const int* __restrict__ pred,
                  const bool* __restrict__ pmask, const int* __restrict__ ptid,
                  const double* __restrict__ times, const int* __restrict__ src,
                  const double* __restrict__ size, const int* __restrict__ up,
                  const int* __restrict__ dn, const bool* __restrict__ tmask,
                  const double* __restrict__ capacity, double* __restrict__ out,
                  int* __restrict__ counts, int n_pad, int p_pad, int t_pad,
                  int num_links, int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(n_pad, p_pad, t_pad);
  double* finish = reinterpret_cast<double*>(smem + lay.finish);
  double* time_s = reinterpret_cast<double*>(smem + lay.time);
  double* pd = reinterpret_cast<double*>(smem + lay.pd);
  double* starts = reinterpret_cast<double*>(smem + lay.starts);
  double* size_s = reinterpret_cast<double*>(smem + lay.size);
  double* remaining = reinterpret_cast<double*>(smem + lay.remaining);
  double* fin = reinterpret_cast<double*>(smem + lay.fin);
  double* rate = reinterpret_cast<double*>(smem + lay.rate);
  double* dur = reinterpret_cast<double*>(smem + lay.dur);
  double* red_dbl = reinterpret_cast<double*>(smem + lay.red_dbl);
  int* task = reinterpret_cast<int*>(smem + lay.task);
  int* slot = reinterpret_cast<int*>(smem + lay.slot);
  int* stid = reinterpret_cast<int*>(smem + lay.tid);
  int* src_s = reinterpret_cast<int*>(smem + lay.src);
  int* up_s = reinterpret_cast<int*>(smem + lay.up);
  int* dn_s = reinterpret_cast<int*>(smem + lay.dn);
  unsigned* red_int = reinterpret_cast<unsigned*>(smem + lay.red_int);
  unsigned char* flags = smem + lay.flags;

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

  // Stage the plan: the order's steps as records, and the transfers.
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
  for (int i = tid; i < t_pad; i += nt) {
    const bool m = tmask[i];
    src_s[i] = src[i];
    size_s[i] = size[i];
    up_s[i] = up[i];
    dn_s[i] = dn[i];
    dur[i] = m ? __ddiv_rn(size[i], cap) : 0.0;
    flags[i] = m ? F_MASK : 0;
  }
  if (tid == 0) finish[n_pad] = 0.0;
  __syncthreads();

  const double thresh = __dadd_rn(__dmul_rn(EPS, cap), EPS);
  const double cap_eps = __dsub_rn(cap, EPS);
  const int width = p_pad >= 32 ? 32 : (p_pad <= 1 ? 1 : 1 << (32 - __clz(p_pad - 1)));
  int par_dbl = 0, par_int = 0;
  int rounds = 0, events = 0, fills = 0, steps = 0;

  for (int r = 0; r < iters; ++r) {
    ++rounds;
    // this round's delays and a fresh finish column
    for (int64_t x = tid; x < nslots; x += nt) {
      const int t = stid[x];
      pd[x] = t >= 0 ? dur[t] : 0.0;
    }
    for (int i = tid; i < n_pad; i += nt) finish[i] = 0.0;
    __syncthreads();

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
    __syncthreads();

    // the fluid solve at the transfers' starts
    double t = INFINITY, unused = INFINITY;
    for (int i = tid; i < t_pad; i += nt) {
      const double s = finish[src_s[i]];
      starts[i] = s;
      unsigned char f = flags[i] & F_MASK;
      if (f) {
        if (size_s[i] > EPS) f |= F_LIVE;
        else f |= F_FINISHED;
        t = dmin(t, s);
      } else {
        f |= F_FINISHED;
      }
      flags[i] = f;
      fin[i] = f & F_MASK ? s : 0.0;
      remaining[i] = f & F_LIVE ? size_s[i] : 0.0;
    }
    block_min2(t, unused, red_dbl, par_dbl, lane, warp, nwarps);

    for (int ev = 0; ev < 3 * t_pad + 4; ++ev) {
      const double t_eps = __dadd_rn(t, EPS);
      for (int i = tid; i < t_pad; i += nt) {
        unsigned char f = flags[i] & (F_MASK | F_LIVE | F_FINISHED);
        if ((f & F_LIVE) && !(f & F_FINISHED) && starts[i] <= t_eps) f |= F_ACTIVE | F_UNFROZEN;
        flags[i] = f;
        rate[i] = 0.0;
      }
      double used[MAX_LINKS];
#pragma unroll
      for (int l = 0; l < MAX_LINKS; ++l) used[l] = 0.0;
      for (int fill = 0; fill < num_links; ++fill) {
        unsigned cnt[MAX_LINKS];
#pragma unroll
        for (int l = 0; l < MAX_LINKS; ++l) cnt[l] = 0;
        for (int i = tid; i < t_pad; i += nt) {
          if (flags[i] & F_UNFROZEN) {
            const int u = up_s[i], d = dn_s[i];
#pragma unroll
            for (int l = 0; l < MAX_LINKS; ++l) cnt[l] += (u == l) + (d == l);
          }
        }
        unsigned* buf = red_int + par_int * MAX_WARPS * MAX_LINKS;
#pragma unroll
        for (int l = 0; l < MAX_LINKS; ++l) {
          if (l < num_links) {
            const unsigned c = __reduce_add_sync(FULL, cnt[l]);
            if (lane == 0) buf[warp * MAX_LINKS + l] = c;
          }
        }
        __syncthreads();
        ++fills;
        double nl[MAX_LINKS];
        bool any = false;
#pragma unroll
        for (int l = 0; l < MAX_LINKS; ++l) {
          nl[l] = 0.0;
          if (l < num_links) {
            const unsigned c = __reduce_add_sync(
                FULL, lane < nwarps ? buf[lane * MAX_LINKS + l] : 0u);
            nl[l] = static_cast<double>(c);
            any = any || c > 0;
          }
        }
        par_int ^= 1;
        if (!any) break;                 // nothing unfrozen: the round is a no-op
        double inc = INFINITY;
#pragma unroll
        for (int l = 0; l < MAX_LINKS; ++l)
          if (l < num_links && nl[l] > 0.0)
            inc = dmin(inc, __ddiv_rn(__dsub_rn(cap, used[l]), nl[l]));
        inc = isfinite(inc) ? inc : 0.0;
        inc = dmax(inc, 0.0);
        unsigned sat = 0;
        bool froze = false;
#pragma unroll
        for (int l = 0; l < MAX_LINKS; ++l) {
          if (l < num_links) {
            used[l] = __dadd_rn(used[l], __dmul_rn(inc, nl[l]));
            if (used[l] >= cap_eps) {
              sat |= 1u << l;
              froze = froze || nl[l] > 0.0;
            }
          }
        }
        for (int i = tid; i < t_pad; i += nt) {
          unsigned char f = flags[i];
          if (f & F_UNFROZEN) {
            rate[i] = __dadd_rn(rate[i], inc);
            if (!froze || ((sat >> up_s[i]) & 1u) || ((sat >> dn_s[i]) & 1u))
              f &= ~F_UNFROZEN;
            flags[i] = f;
          }
        }
        if (!froze) break;               // the guard froze every flow
      }

      double t_done = INFINITY, t_next = INFINITY;
      for (int i = tid; i < t_pad; i += nt) {
        const unsigned char f = flags[i];
        if (f & F_ACTIVE)
          t_done = dmin(t_done, __dadd_rn(t, __ddiv_rn(remaining[i], dmax(rate[i], TINY))));
        if ((f & F_LIVE) && !(f & F_FINISHED) && starts[i] > t_eps)
          t_next = dmin(t_next, starts[i]);
      }
      block_min2(t_done, t_next, red_dbl, par_dbl, lane, warp, nwarps);
      ++events;
      const double t_ev = dmin(t_done, t_next);
      if (!isfinite(t_ev)) break;        // nothing left: every later step is a no-op
      const double t_new = dmax(t_ev, t);
      const double dt = __dsub_rn(t_new, t);
      for (int i = tid; i < t_pad; i += nt) {
        unsigned char f = flags[i];
        if (f & F_ACTIVE) {
          const double rem = __dsub_rn(remaining[i], __dmul_rn(rate[i], dt));
          remaining[i] = rem;
          if (rem <= thresh) {
            fin[i] = t_new;
            flags[i] = f | F_FINISHED;
          }
        }
      }
      t = t_new;
    }

    // new durations, and the plan's freeze
    bool close = true;
    for (int i = tid; i < t_pad; i += nt) {
      if (flags[i] & F_MASK) {
        const double d = dur[i];
        const double nw = __dsub_rn(fin[i], starts[i]);
        close = close && fabs(__dsub_rn(nw, d)) <= __dadd_rn(1e-9, __dmul_rn(1e-3, fabs(d)));
        dur[i] = nw;
      }
    }
    if (__syncthreads_and(close)) break;
  }

  for (int i = tid; i < t_pad; i += nt) out[static_cast<int64_t>(b) * t_pad + i] = dur[i];
  if (tid == 0) {
    int* c = counts + static_cast<int64_t>(b) * COUNTS;
    c[0] = rounds;
    c[1] = events;
    c[2] = fills;
    c[3] = steps;
  }
}

// The two links of the chain floor, each repeated `steps` times:
//   mode 0 — one dependent replay step through shared memory, as warp 0
//     walks a one-slot step: a load of the last finish time, an add, a
//     butterfly max over `width` lanes, an add of the time, a store by lane
//     0 and a __syncwarp;
//   mode 1 — one block-wide barrier-and-min of a block of `threads`
//     threads, as block_min2 takes the next event's time.
// `out[0]` keeps the result, so nothing is optimised away.
__global__ void __launch_bounds__(MAX_THREADS)
chain_probe_kernel(double* out, int steps, int mode, int width) {
  __shared__ double column[64 + 1];
  __shared__ double red[2 * MAX_WARPS * 2];
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
    double a = static_cast<double>(tid), b = 0.0;
    int parity = 0;
    for (int s = 0; s < steps; ++s) {
      block_min2(a, b, red, parity, lane, warp, nwarps);
      a = __dadd_rn(a, 1.0);
    }
    if (tid == 0) out[0] = a;
  }
}

unsigned long long g_configured = 0;   // devices whose shared-memory limit is raised

}  // namespace

extern "C" long long contention_smem_bytes(int n_pad, int p_pad, int t_pad) {
  return layout(n_pad, p_pad, t_pad).bytes;
}

extern "C" int contention_threads(int t_pad) { return threads_for(t_pad); }

extern "C" int contention_durations_f64(const int* order, const int* pred, const bool* pmask,
                                        const int* ptid, const double* times, const int* src,
                                        const double* size, const int* up, const int* dn,
                                        const bool* tmask, const double* capacity, double* out,
                                        int* counts, int batch, int n_pad, int p_pad,
                                        int t_pad, int num_links, int iters,
                                        cudaStream_t stream) {
  if (batch <= 0 || n_pad <= 0 || p_pad <= 0 || t_pad <= 0 || num_links <= 0 ||
      num_links > MAX_LINKS || iters < 0)
    return cudaErrorInvalidValue;
  const int64_t bytes = layout(n_pad, p_pad, t_pad).bytes;
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(contention_kernel, SMEM_LIMIT, g_configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  contention_kernel<<<batch, threads_for(t_pad), static_cast<size_t>(bytes), stream>>>(
      order, pred, pmask, ptid, times, src, size, up, dn, tmask, capacity, out, counts,
      n_pad, p_pad, t_pad, num_links, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int contention_chain_probe(double* out, int steps, int mode, int threads,
                                      cudaStream_t stream) {
  if (steps <= 0 || (mode != 0 && mode != 1) || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0)
    return cudaErrorInvalidValue;
  chain_probe_kernel<<<1, threads, 0, stream>>>(out, steps, mode, 4);
  return static_cast<int>(cudaGetLastError());
}
