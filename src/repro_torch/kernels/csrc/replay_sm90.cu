// Makespan replay of a bucket of padded plan DAGs, redesigned for Hopper:
// finish times in shared memory, the inputs staged off the chain.  CUDA C++
// for sm_90a; the card path of kernels/replay/replay.py.
//
// Replaces the JAX package's jitted replay
//   src/repro/sim/batch.py::_bucket_makespans (:455), a vmap over plans and
//   seeds of the lax.scan src/repro/sim/batch.py::_one_makespan (:275),
//
// It computes what replay/ref.py::bucket_makespans_ref computes, bit for
// bit, on any order whose entries index the plan: for every plan b and seed
// s it walks order[b, :] and sets, for task j = order[b, i],
//   start = max(max(0, max_k finish[pred[b, j, k]] + delay[b, j, k]), floor[b, j])
//   finish[j] = start + times[b, s, j]
// from a finish column of zeros, and writes out[b, s] = max_j finish[j].
// Every sum is one fp32 add rounded once (__fadd_rn: no FMA, no fast-math)
// and every max is exact and keeps NaN (max_nan, sm90_common.cuh), as the
// reference's jnp.max and the plain version's amax do.
//
// What bounds it on the H100: each lane is one chain of dependent steps (a
// step needs its predecessors' finish times), so its latency, not bytes nor
// operations.  The first port (one thread a lane, deleted since) paid
// k + 2 L2 round trips a step (order, pred row, delays and floor through
// the same pointers as the finish scratch, which its stores could alias).
// Here a step waits on one shared-memory round trip: the finish[p] reads of
// its slots, issued together.  chip_smoke.py measures that floor (one
// dependent add + max step through shared memory, replay_sm90_chain_probe).
//
// Design:
//   * One block per (plan, L seeds).  The finish scratch is (n_pad + 1, L)
//     floats in dynamic shared memory, a step's finish[p] of the L lanes in
//     L consecutive banks; row n_pad is a zero cell that is never written.
//     L is the largest power of two <= 32 whose scratch and staging ring fit
//     227 KB (replay.py::lanes_per_block mirrors smem_words below): 32 up to
//     1026 tasks at P_pad 4, 8 at the §6.1 grid's 4011-5011 tasks, 4 at
//     8192; one lane holds 48,815.
//   * Warp 0 walks: lane l is seed s0 + l.  Warps 1-8 stage: a ring of two
//     stages of up to STEPS steps each, a __syncthreads handshake per stage.
//     While the walker runs stage c, the stagers fill stage c + 1 with what
//     no finish time decides, one 48-byte record a step: the byte offset of
//     task j's row, max(0, floor[j]) (exact: the max is associative, and 0
//     is the reference's initial value), its first INLINE real pred slots
//     (row offsets and delays; a missing slot points at the zero cell with
//     delay +0.0, which adds an exact +0.0 to that max), and the range of
//     its further slots, packed in CSR form; and the L lanes' times[s, j].
//     The slots of a row are filled from the left, -1 after the last (the
//     caller checks it: replay.py::check_indices); a stager reads a row's
//     first HEAD slots and bisects the rest for its first -1, so the §6.1
//     joins' 100-500 slots cost a few reads to count.  A stage ends early
//     where its further slots would pass 2 STEPS + P_pad words, so a row of
//     any fan-in fits one stage.
//   * The walker keeps the next step's record and time in registers, loaded
//     before the current step's store, so a step of up to INLINE slots is
//     one short chain: the finish[p] loads, issued together, adds, three
//     levels of max (the last with max(0, floor)), the add of the time, the
//     store.  Slots past INLINE (the joins) are read from the stage in a
//     loop behind a branch the other steps skip.  Two steps an iteration
//     keep the prefetched records in place, with no register copies on the
//     chain.
//   * The walk stops before a trailing run of steps that provably changes no
//     bit: every step from there on visits one task j* that is not visited
//     before, has no real slot, and a floor and every lane's time of +0.0.
//     Such a step writes +0.0 over the +0.0 the column starts with.  This is
//     how sim/batch.py pads a plan shorter than its bucket (spare order
//     slots point at the first phantom task), so each item walks its own
//     length; any other input walks the whole order.
//   * The makespan is the max over the lane's whole column after the walk,
//     taken by all the block's threads.
//   * Not done: the level-parallel design (the tasks of one topological
//     level in parallel), one launch over all buckets (ROADMAP B3).
//
// C interface (loaded with ctypes): replay_sm90_makespans_f32 returns the
// cudaError_t of the shared-memory attribute call or of the launch as an
// int, 0 on success; replay_sm90_smem_bytes the bytes a launch takes;
// replay_sm90_chain_probe times the chain floor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int STEPS = 256;                  // steps a stage holds, one per stager
constexpr int THREADS = 32 + STEPS;         // warp 0 walks, warps 1-8 stage
constexpr int INLINE = 4;                   // slots a step's record holds
constexpr int RECORD = 12;                  // words of a step's record
constexpr int HEAD = 8;                     // slots a stager reads to count a row
constexpr int MISC = 32;                    // words of flags and scan totals
constexpr int SMEM_LIMIT = 232448;          // 227 KB, the most a block may take

__host__ __device__ inline int round4(int64_t x) { return static_cast<int>((x + 3) & ~3LL); }

// A stage's capacity for slots past INLINE.
__host__ __device__ inline int stage_slot_words(int p_pad) {
  return 2 * STEPS + round4(p_pad);
}

// Words of one stage: the records (RECORD STEPS), the tasks and the step
// count (STEPS + 4), the lanes' times (L rows of STEPS + 1: a stager's
// writes and the walker's reads both fall in distinct banks), the further
// slots and their delays (the capacity + 4 each); a multiple of 4 words.
__host__ __device__ inline int stage_words(int lanes, int p_pad) {
  return round4((RECORD + 1) * STEPS + 4 + (STEPS + 1) * lanes +
                2 * (stage_slot_words(p_pad) + 4));
}

// The finish scratch with its zero cell and the flags, then two stages.
__host__ __device__ inline int64_t ring_offset(int n_pad, int lanes) {
  return round4(static_cast<int64_t>(n_pad + 1) * lanes + MISC);
}

__host__ __device__ inline int64_t smem_words(int n_pad, int p_pad, int lanes) {
  return ring_offset(n_pad, lanes) + 2LL * stage_words(lanes, p_pad);
}

struct Stage {
  int* rec;       // [STEPS][RECORD]  bytes of j's row, first further slot,
                  //   end of them, max(0, floor) bits; INLINE slots' row
                  //   bytes; their delay bits
  int* task;      // [STEPS]          j of each step
  int* count;     // [1]              steps in the stage; 0 ends the walk
  float* time;    // [L][STEPS + 1]   times[s0 + l, j]
  int* slot;      // [words + 4]      further slots' row bytes
  float* delay;   // [words + 4]      their delays
};

__device__ __forceinline__ Stage stage_at(float* base, int lanes, int words) {
  Stage st;
  st.rec = reinterpret_cast<int*>(base);
  st.task = st.rec + RECORD * STEPS;
  st.count = st.task + STEPS;
  st.time = base + (RECORD + 1) * STEPS + 4;
  st.slot = reinterpret_cast<int*>(st.time + (STEPS + 1) * lanes);
  st.delay = reinterpret_cast<float*>(st.slot + words + 4);
  return st;
}

// A barrier among the stagers alone (warps 1-8), so the walker runs on.
__device__ __forceinline__ void stagers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(STEPS) : "memory");
}

// The stagers fill `st` with the steps from i0 on (at most STEPS, fewer
// where their further slots pass `words`, none at or past `walk`).  Returns
// the first step of the next stage.  Called by the STEPS stager threads.
__device__ int stage_steps(const Stage& st, int i0, int walk, const int* order,
                           const int* pred, const float* delay, const float* floors,
                           const float* times, int n_pad, int p_pad, int s, int s0,
                           int lanes, int words, int* scan) {
  const int t = threadIdx.x - 32;
  const int i = i0 + t;
  const bool valid = i < walk;
  const int row_bytes = 4 * lanes;           // a task's row of the scratch
  const int zero = n_pad * row_bytes;        // the zero cell's row
  int j = 0, cnt = 0;
  if (valid) {
    j = order[i];
    const int* row = pred + static_cast<int64_t>(j) * p_pad;
    const float* drow = delay + static_cast<int64_t>(j) * p_pad;
    int head[HEAD];
    float dl[INLINE];
#pragma unroll
    for (int k = 0; k < HEAD; ++k) head[k] = k < p_pad ? row[k] : -1;
#pragma unroll
    for (int k = 0; k < INLINE; ++k) dl[k] = k < p_pad ? drow[k] : 0.0f;
    const float fl = floors[j];
    float tv[32];     // every load in flight before the first store
#pragma unroll
    for (int l = 0; l < 32; ++l)
      tv[l] = l < lanes && s0 + l < s
                  ? times[static_cast<int64_t>(s0 + l) * n_pad + j] : 0.0f;
#pragma unroll
    for (int l = 0; l < 32; ++l)
      if (l < lanes) st.time[l * (STEPS + 1) + t] = tv[l];
    bool run = true;
#pragma unroll
    for (int k = 0; k < HEAD; ++k) {
      run = run && head[k] >= 0;
      cnt += run;
    }
    if (cnt == HEAD && p_pad > HEAD) {   // bisect for the row's first -1
      int lo = HEAD, hi = p_pad;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row[mid] >= 0) lo = mid + 1;
        else hi = mid;
      }
      cnt = lo;
    }
    int4* r = reinterpret_cast<int4*>(st.rec + RECORD * t);
    r[1] = make_int4(cnt > 0 ? head[0] * row_bytes : zero,
                     cnt > 1 ? head[1] * row_bytes : zero,
                     cnt > 2 ? head[2] * row_bytes : zero,
                     cnt > 3 ? head[3] * row_bytes : zero);
    r[2] = make_int4(__float_as_int(cnt > 0 ? dl[0] : 0.0f),
                     __float_as_int(cnt > 1 ? dl[1] : 0.0f),
                     __float_as_int(cnt > 2 ? dl[2] : 0.0f),
                     __float_as_int(cnt > 3 ? dl[3] : 0.0f));
    st.rec[RECORD * t] = j * row_bytes;
    st.rec[RECORD * t + 3] = __float_as_int(max_nan(0.0f, fl));
    st.task[t] = j;
  }
  // Inclusive scan of the further slots' counts over the stagers, then the
  // steps whose further slots fit: a prefix, since the sums only grow.
  const int more = cnt > INLINE ? cnt - INLINE : 0;
  const int warp = t >> 5, lane = t & 31;
  int incl = more;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) scan[warp] = incl;
  stagers_sync();
  for (int w = 0; w < warp; ++w) incl += scan[w];
  const bool keep = valid && incl <= words;
  const unsigned kept = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) scan[STEPS / 32 + warp] = __popc(kept);
  stagers_sync();
  int taken = 0;
#pragma unroll
  for (int w = 0; w < STEPS / 32; ++w) taken += scan[STEPS / 32 + w];
  if (keep) {
    st.rec[RECORD * t + 1] = incl - more;
    st.rec[RECORD * t + 2] = incl;
  }
  if (t == 0) *st.count = taken;
  stagers_sync();   // records seen by every stager; scan free again
  // The further slots, word by word over all the stagers: word w belongs to
  // the last step u whose first further slot is <= w (a step without any
  // never is that step).
  const int end = taken > 0 ? st.rec[RECORD * (taken - 1) + 2] : 0;
  for (int w = t; w < end; w += STEPS) {
    int lo = 0, hi = taken - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (st.rec[RECORD * mid + 1] <= w) lo = mid;
      else hi = mid - 1;
    }
    const int64_t at = static_cast<int64_t>(st.task[lo]) * p_pad + INLINE +
                       (w - st.rec[RECORD * lo + 1]);
    st.slot[w] = pred[at] * row_bytes;
    st.delay[w] = delay[at];
  }
  return i0 + taken;
}

// One step of the walk on a lane's column `col` (bytes from the lane's
// first word): the record's INLINE slots, issued together, then any further
// slots, then the max with max(0, floor) and the add of the time.
__device__ __forceinline__ void walk_step(const Stage& st, char* col, int4 a, int4 p,
                                          int4 d, float tm) {
  const float f0 = __fadd_rn(*reinterpret_cast<const float*>(col + p.x), __int_as_float(d.x));
  const float f1 = __fadd_rn(*reinterpret_cast<const float*>(col + p.y), __int_as_float(d.y));
  const float f2 = __fadd_rn(*reinterpret_cast<const float*>(col + p.z), __int_as_float(d.z));
  const float f3 = __fadd_rn(*reinterpret_cast<const float*>(col + p.w), __int_as_float(d.w));
  float start = max_nan(max_nan(f0, f1), max_nan(f2, f3));
  if (a.y < a.z) {
#pragma unroll 8
    for (int o = a.y; o < a.z; ++o)
      start = max_nan(start, __fadd_rn(*reinterpret_cast<const float*>(col + st.slot[o]),
                                       st.delay[o]));
  }
  *reinterpret_cast<float*>(col + a.x) = __fadd_rn(max_nan(start, __int_as_float(a.w)), tm);
}

// The walker's lane `lane` runs the `n` steps of `st` on its finish column
// `col`, two steps an iteration: the next step's record and time are loaded
// before the current step's store (off the chain), into the registers the
// step after it frees, so no register is copied on the chain.
__device__ __forceinline__ void walk_steps(const Stage& st, int n, char* col, int lane) {
  const float* tl = st.time + lane * (STEPS + 1);
  const int4* rec = reinterpret_cast<const int4*>(st.rec);
  int4 a0 = rec[0], p0 = rec[1], d0 = rec[2];
  float t0 = tl[0];
  int t = 0;
  for (; t + 1 < n; t += 2) {
    const int4 a1 = rec[3 * t + 3], p1 = rec[3 * t + 4], d1 = rec[3 * t + 5];
    const float t1 = tl[t + 1];
    walk_step(st, col, a0, p0, d0, t0);
    const int u = t + 2 < n ? t + 2 : t + 1;
    a0 = rec[3 * u];
    p0 = rec[3 * u + 1];
    d0 = rec[3 * u + 2];
    t0 = tl[u];
    walk_step(st, col, a1, p1, d1, t1);
  }
  if (t < n) walk_step(st, col, a0, p0, d0, t0);
}

__global__ void __launch_bounds__(THREADS, 1)
replay_sm90_kernel(const int* __restrict__ order, const int* __restrict__ pred,
                   const float* __restrict__ delay, const float* __restrict__ floors,
                   const float* __restrict__ times, float* __restrict__ out, int n_pad,
                   int p_pad, int s, int lanes, int seed_blocks) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x / seed_blocks;
  const int s0 = (blockIdx.x % seed_blocks) * lanes;
  order += b * n_pad;
  pred += b * n_pad * static_cast<int64_t>(p_pad);
  delay += b * n_pad * static_cast<int64_t>(p_pad);
  floors += b * n_pad;
  times += b * s * static_cast<int64_t>(n_pad);

  const int words = stage_slot_words(p_pad);
  float* fin = smem;                                   // [n_pad + 1][lanes]
  int* misc = reinterpret_cast<int*>(fin + (n_pad + 1) * lanes);
  float* ring = smem + ring_offset(n_pad, lanes);
  const int stage_size = stage_words(lanes, p_pad);

  // The column starts at zeros.  The walk's length: the order without its
  // trailing run of one task j* that no earlier step visits, with no real
  // slot, a floor of +0.0 and every lane's time +0.0 (bit patterns).
  for (int x = tid; x < (n_pad + 1) * lanes; x += THREADS) fin[x] = 0.0f;
  if (tid == 0) {
    misc[0] = -1;       // the last step whose task is not j*
    misc[1] = n_pad;    // the first step whose task is j*
  }
  __syncthreads();
  const int jstar = order[n_pad - 1];
  int last_other = -1, first_star = n_pad;
  for (int i = tid; i < n_pad; i += THREADS) {
    if (order[i] != jstar) last_other = i;
    else if (first_star == n_pad) first_star = i;
  }
  if (last_other >= 0) atomicMax(&misc[0], last_other);
  if (first_star < n_pad) atomicMin(&misc[1], first_star);
  bool idle = true;
  if (tid < lanes && s0 + tid < s)
    idle = __float_as_uint(times[static_cast<int64_t>(s0 + tid) * n_pad + jstar]) == 0u;
  if (tid == 0)
    idle = idle && pred[static_cast<int64_t>(jstar) * p_pad] < 0 &&
           __float_as_uint(floors[jstar]) == 0u;
  const bool skip = __syncthreads_and(idle) != 0;
  const int walk = (skip && misc[1] > misc[0]) ? misc[0] + 1 : n_pad;

  int next = 0;
  if (tid >= 32)
    next = stage_steps(stage_at(ring, lanes, words), 0, walk, order, pred, delay, floors,
                       times, n_pad, p_pad, s, s0, lanes, words, misc + 2);
  __syncthreads();
  for (int c = 0;; c ^= 1) {
    const Stage cur = stage_at(ring + c * stage_size, lanes, words);
    const int n = *cur.count;
    if (n == 0) break;
    if (tid < 32) {
      if (tid < lanes) walk_steps(cur, n, reinterpret_cast<char*>(fin + tid), tid);
    } else {
      next = stage_steps(stage_at(ring + (c ^ 1) * stage_size, lanes, words), next, walk,
                         order, pred, delay, floors, times, n_pad, p_pad, s, s0, lanes,
                         words, misc + 2);
    }
    __syncthreads();
  }

  // max over each lane's column: thread tid sees lane tid % lanes only, as
  // THREADS is a multiple of lanes; then one thread a lane over the partials.
  float best = -INFINITY;
  for (int x = tid; x < n_pad * lanes; x += THREADS) best = max_nan(best, fin[x]);
  ring[tid] = best;
  __syncthreads();
  if (tid < lanes && s0 + tid < s) {
    float r = ring[tid];
    for (int x = tid + lanes; x < THREADS; x += lanes) r = max_nan(r, ring[x]);
    out[b * s + s0 + tid] = r;
  }
}

// The chain floor: one warp walks `steps` dependent steps through shared
// memory, each one load of the previous step's finish time, an add, a max
// with a floor, an add and a store, as walk_steps does for a one-slot step.
// The column is volatile so the compiler cannot carry a stored finish time
// to the next step in a register; `out[0]` keeps the result.
__global__ void __launch_bounds__(32, 1)
chain_probe_kernel(float* out, int steps, float delay, float floor, float time) {
  __shared__ float column[64 * 32];
  volatile float* fin = column;
  const int lane = threadIdx.x;
  for (int x = lane; x < 64 * 32; x += 32) fin[x] = 0.0f;
  __syncwarp();
  int p = 0;
  for (int t = 0; t < steps; ++t) {
    const int j = (p + 1) & 63;
    float start = max_nan(0.0f, __fadd_rn(fin[p * 32 + lane], delay));
    start = max_nan(start, floor);
    fin[j * 32 + lane] = __fadd_rn(start, time);
    p = j;
  }
  __syncwarp();
  if (lane == 0) out[0] = fin[p * 32];
}

unsigned long long g_configured = 0;   // devices whose shared-memory limit is raised

}  // namespace

extern "C" long long replay_sm90_smem_bytes(int n_pad, int p_pad, int lanes) {
  return 4 * smem_words(n_pad, p_pad, lanes);
}

extern "C" int replay_sm90_makespans_f32(const int* order, const int* pred,
                                         const float* delay, const float* floors,
                                         const float* times, float* out, int batch,
                                         int n_pad, int p_pad, int s, int lanes,
                                         cudaStream_t stream) {
  if (batch <= 0 || n_pad <= 0 || p_pad <= 0 || s <= 0 || lanes <= 0 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0)
    return cudaErrorInvalidValue;
  const int64_t bytes = 4 * smem_words(n_pad, p_pad, lanes);
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  const int seed_blocks = (s + lanes - 1) / lanes;
  const int64_t blocks = static_cast<int64_t>(batch) * seed_blocks;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  cudaError_t err = allow_smem(replay_sm90_kernel, SMEM_LIMIT, g_configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  replay_sm90_kernel<<<static_cast<unsigned>(blocks), THREADS, static_cast<size_t>(bytes),
                       stream>>>(order, pred, delay, floors, times, out, n_pad, p_pad, s,
                                 lanes, seed_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int replay_sm90_chain_probe(float* out, int steps, cudaStream_t stream) {
  if (steps <= 0) return cudaErrorInvalidValue;
  chain_probe_kernel<<<1, 32, 0, stream>>>(out, steps, 0.25f, 0.0f, 1.0f);
  return static_cast<int>(cudaGetLastError());
}
