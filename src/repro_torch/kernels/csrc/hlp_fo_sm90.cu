// The first-order HLP solve redesigned for Hopper: Adam on logits against
// the tau-annealed soft longest path, every step of one problem in one
// block.  CUDA C++ for sm_90a; the card path of kernels/hlp_fo/hlp_fo.py.
//
// Replaces the JAX package's two jitted solvers
//   src/repro/core/hlp_jax.py::_solve (:122), the hybrid solve: x = sigmoid(z)
//     over n tasks, Q = 2, no edge costs;
//   src/repro/core/hlp_jax.py::_solve_choice (:172), the choice-grid solve:
//     x = softmax(z) over an (n, C) grid of (type, width) choices, with
//     use_comm adding each pred edge's expected crossing delay
//     pred_comm * (1 - X[pred] . X), X = x @ type_mask^T.
// Every float operation names its rounding (__fadd_rn / __fmul_rn /
// __fdiv_rn / __fmaf_rn, full-precision sqrtf; the hybrid solve's expf /
// logf, the choice solve's XLA:CPU exp / log from xla_math.cuh) and every
// sum has a fixed order, so runs repeat bit for bit.
//   * The hybrid solve computes what the first design, hlp_fo.cu (deleted;
//     its loop lives on as the gather design of tests/hlp_fo_emulation.py),
//     computed, bit for bit: no FMA, sums in the block tree, and a reverse
//     scan that drops the gradient through each max (it cancels in exact
//     arithmetic).  Its plain version (hlp_fo/ref.py) takes the gradient
//     from autograd, so the two agree to rounding.
//   * The choice solve runs in the order of the program XLA:CPU compiles
//     for the reference's gradient, as its plain version does
//     (hlp_fo/ref.py::choice_grad): each multiply-add XLA contracts is one
//     __fmaf_rn (task times, marginals, crossings, soft starts, pool loads,
//     the chain rule), each sum over tasks runs in XLA's windows of 32
//     (window_sum), the cotangent through each max is kept, and a task's
//     successors add their slot cotangents in descending topological order
//     (the wrapper passes a pred_edge whose successor lists run that way).
//     Its exp and log are XLA:CPU's own (xla_math.cuh), its Adam moments
//     one multiply-add each and x's cotangent takes the marginals' share
//     first, as XLA's program for the solve does.  Where that program sums
//     otherwise at some shapes, so does the kernel (ROADMAP C6): the pool
//     loads as a tiled GEMV (pool_load), the marginals in Eigen's lanes of
//     4 at C = 4 / 8 / 12, the task times as rounded products at
//     VECTOR_CHOICES, the area sums over n <= WINDOW tasks as a
//     multiply-add chain (area_chain), the marginals' cotangent's first
//     type unfused at 3 <= P < 8, and without the delays gx / S from the
//     other contraction at VECTOR_CHOICES.  On an ill-conditioned
//     instance every rounding counts: it is the plain version bit for bit,
//     and so the reference's best x (the emulation in
//     tests/hlp_fo_emulation.py holds the two to each other on the CPU).
//
// What bounds it on the H100: a chain of dependent level steps, each ended
// by a barrier; its inputs are a few hundred KB, read from L2 after the
// first step.  The first design walked the levels three times a step (soft
// forward, reverse, exact forward) and paid one expf and two divisions per
// edge in its reverse gather.  This design walks them twice:
//   * The exact pass of step i and the soft forward of step i + 1 read the
//     same x, task times and edge delays, so one walk computes each task's
//     hard finish (its own array) and its soft f, max and sum; one block
//     reduction then carries the max hard finish, the pool loads and the
//     max soft finish, and the soft sum of exponentials follows in a
//     second.  The best-iterate check and its copy of x come before the
//     reverse pass.  Only the last step keeps a walk of its own (hard only).
//   * The soft forward keeps each pred slot's exp((pf - m) / tau) in an edge
//     buffer w of one entry an edge, at the edge's place e in the successor
//     CSR (pred_edge maps each slot there).  In the reverse walk a task sets
//     its coefficient c and turns its own slots' weights into the adjoints
//     gp = c w / tau, in place; its predecessors, a level down, sum the
//     stored gp over their successor lists, w[e0 .. e1) in CSR order.  No
//     expf, no division and no index load is left in the fan-out loop, and
//     no atomics: every sum has a fixed order, so runs repeat bit for bit.
//   * Off the level chain, in passes over all tasks at once: the chain rule
//     into the logits, the Adam step and the new x, each task's time on it
//     (left in f for the next walk) and, with use_comm, the type-marginal
//     cotangent from the stored gp (in the first design's order), the marginals of
//     the new x and each slot's crossing delay (left in w).
//   * A task of up to PR pred slots keeps them in registers, so their
//     divisions and expf overlap; a longer row goes PR slots at a time.
//   * Adam's z, mu and nu stay in global memory: the first design's reverse
//     split (clock64, potri nb=20) gave their loads and stores under 10%
//     of its reverse pass, and the pass here is off the chain.  So do the
//     choice solve's softmax exps e = exp(z - max): the softmax that makes
//     x keeps them for the next step's chain rule, which needs e and their
//     sum, and would otherwise take C expf a task again.
//   * A block of one warp (the campaign's solves) ends each level with
//     __syncwarp instead of __syncthreads.
//   * Two layouts, chosen by size alone: the per-task arrays and the edge
//     buffer in shared memory, or, past 227 KB, in a global scratch buffer
//     the caller passes (L1-cached; only the level offsets, the type mask
//     and the reductions' scratch stay in shared memory).  So every problem
//     the first design took, this kernel takes too.
//
// C interface (loaded with ctypes): hlp_fo_sm90_hybrid_f32 and
// hlp_fo_sm90_choice_f32 return the cudaError_t of the shared-memory
// attribute call or of the launch as an int, 0 on success, and, given a
// `cycles` array, thread 0's clock cycles in each phase of the step;
// hlp_fo_sm90_smem_bytes the bytes a launch takes; hlp_fo_sm90_chain_probe
// times the chain floor; hlp_fo_sm90_transcendental_f32 gives the choice
// solve's exp or log (xla_math.cuh) of an array, not a solve: it is held
// to the plain version's twins bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"
#include "xla_math.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float TINY = 1e-30f;
constexpr int MAX_C = 16;          // choices a task may have
constexpr int MAX_Q = 8;           // resource types
constexpr int MAX_V = MAX_C + 2;   // values one block reduction carries
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int SMEM_LIMIT = 232448; // 227 KB, the most a block may take
constexpr int PR = 4;              // pred slots a task holds in registers
// XLA:CPU's program for the reference's choice solve sums differently at
// some shapes (hlp_fo/ref.py, ROADMAP C6): over more than WINDOW tasks in
// reduce-windows, at VECTOR_CHOICES choices two tasks to a 16-lane register
constexpr int WINDOW = 32;
constexpr int VECTOR_CHOICES = 8;

// Adam's constants as the reference's Python floats round to float32.
constexpr float LR = 0.25f;
constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float EPS = 1e-8f;
constexpr float ONE_B1 = static_cast<float>(1.0 - 0.9);
constexpr float ONE_B2 = static_cast<float>(1.0 - 0.999);

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// The solve's transcendentals: the choice entry takes XLA:CPU's own
// (xla_math.cuh), the reference's bit for bit; the hybrid entry the card's.
template <bool CHOICE>
__device__ __forceinline__ float exp_(float v) { return CHOICE ? xla_math::xla_exp_f32(v) : expf(v); }
template <bool CHOICE>
__device__ __forceinline__ float log_(float v) { return CHOICE ? xla_math::xla_log_f32(v) : logf(v); }

struct Problem {
  const int* level_ptr;   // (L + 1)
  const int* level_task;  // (n) tasks sorted by level
  const int* pred;        // (n, P) -1 after the last real slot
  const int* succ_ptr;    // (n + 1)
  const int* succ_task;   // (E)
  const int* succ_slot;   // (E) the edge's slot in its successor's pred row
  const int* pred_edge;   // (n, P) each real slot's place in the successor CSR
  const float* pc;        // hybrid: (n) CPU times
  const float* pg;        // hybrid: (n) GPU times
  const float* p_choice;  // choice: (n, C) times
  const float* area;      // choice: (n, C) areas
  const float* type_mask; // choice: (Q, C)
  const float* inv_counts;// choice: (Q)
  const float* pred_comm; // choice with use_comm: (n, P)
  const float* sched;     // (iters, 3): anneal factor, 1 - b1^(i+1), 1 - b2^(i+1)
  const float* z0;        // (n C) starting logits (C = 1 for the hybrid solve)
  float* z;               // (n C) Adam state
  float* mu;
  float* nu;
  float* ez;              // choice: (n C) exp(z - row max) of the current
                          // logits, kept from their softmax for the next
                          // step's chain rule
  float* best_x;          // (n C) out
  float* best_val;        // (1) out
  float* scratch;         // null: the shared layout; else the per-task arrays
  long long* cycles;      // (4) out, or null: thread 0's clock cycles in the
                          // fused forward, the loss, the reverse walk and
                          // the Adam pass, summed over the steps
  int n, P, E, levels, C, Q, iters, m, k;
};

// The per-task arrays in floats: x, the soft and hard finishes, each
// task's soft start and S + 1e-30, the edge buffer (E) and X (use_comm).
__host__ __device__ inline int64_t task_floats(int n, int C, int Q, int E, bool comm) {
  const int64_t tasks = static_cast<int64_t>(n);
  return tasks * C + 4 * tasks + E + (comm ? tasks * Q : 0);
}

// Dynamic shared memory in floats: the per-task arrays in the shared
// layout, then type_mask, inv_counts, the level offsets (as ints) and the
// reductions' scratch.
__host__ __device__ inline int64_t smem_floats(int n, int levels, int C, int Q, int E,
                                               bool comm, bool shared) {
  return (shared ? task_floats(n, C, Q, E, comm) : 0) + Q * C + Q + (levels + 1) +
         MAX_WARPS * MAX_V;
}

// A solve's arrays: all in shared memory, or the per-task ones (x to X)
// in the caller's scratch.
struct Smem {
  float* x;
  float* f;     // task time; soft finish; exp((f - M) / tau); the adjoint g_f
  float* fh;    // hard finish
  float* sv;    // the soft start before its max with 0 (the tie rule)
  float* st;    // S + 1e-30
  float* w;     // (E): use_comm delay; slot finish; exp((pf - m) / tau); gp
  float* X;
  float* tm;
  float* inv;
  int* lp;
  float* red;
};

template <bool SHARED>
__device__ Smem carve(float* base, const Problem& p, bool comm) {
  const int64_t n = p.n, nc = n * p.C;
  Smem s;
  float* cur = SHARED ? base : p.scratch;
  s.x = cur;   cur += nc;
  s.f = cur;   cur += n;
  s.fh = cur;  cur += n;
  s.sv = cur;  cur += n;
  s.st = cur;  cur += n;
  s.w = cur;   cur += p.E;
  s.X = cur;   cur += comm ? n * p.Q : 0;
  if (!SHARED) cur = base;
  s.tm = cur;  cur += p.Q * p.C;
  s.inv = cur; cur += p.Q;
  s.lp = reinterpret_cast<int*>(cur); cur += p.levels + 1;
  s.red = cur;
  return s;
}

// A level's barrier: the warp's own when the block is one warp.
__device__ __forceinline__ void level_sync(bool one_warp) {
  if (one_warp) __syncwarp();
  else __syncthreads();
}

// Every thread gets the block's max of v[i] for each bit i of `maxes` and
// the sum of the other v[i], i < nv, in the first design's tree: a butterfly
// within each warp (every lane gets the same value; each add is
// commutative), then the warps' partials in order.  One warp needs no
// scratch: its butterfly is the result.  Either way the shared-memory
// writes made before the call are visible to every thread after it.
__device__ void block_reduce(float (&v)[MAX_V], int nv, unsigned maxes, float* scratch,
                             bool one_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < MAX_V; ++i) {
    if (i < nv) {
      const bool mx = (maxes >> i) & 1u;
      float x = v[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, x, o);
        x = mx ? max_nan(x, y) : add(x, y);
      }
      v[i] = x;
    }
  }
  if (one_warp) {
    __syncwarp();
    return;
  }
  __syncthreads();  // the previous reduction's readers are done
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < MAX_V; ++i)
      if (i < nv) scratch[warp * MAX_V + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MAX_V; ++i) {
    if (i < nv) {
      const bool mx = (maxes >> i) & 1u;
      float x = scratch[i];
      for (int w = 1; w < nw; ++w)
        x = mx ? max_nan(x, scratch[w * MAX_V + i]) : add(x, scratch[w * MAX_V + i]);
      v[i] = x;
    }
  }
}

// The sums over the tasks j < n of val(j, c), c < K, in XLA:CPU's order
// (hlp_fo/ref.py::window_sum): windows of 32 task ids (the ids padded to a
// multiple of 32, the padding split between the two ends), each summed in
// order from 0, then the windows' sums in order from 0.  Each thread sums
// (window, c) pairs; thread c then adds its windows up, a chunk at a time
// through the reductions' scratch.  Every thread gets the K sums in out;
// the shared-memory writes made before the call are visible to it.
template <class F>
__device__ void window_sum(const Problem& p, const Smem& s, int K, F val, float* out,
                           bool one_warp) {
  const int nwin = (p.n + 31) >> 5;
  const int lo = ((nwin << 5) - p.n) >> 1;
  const int per = (MAX_WARPS * MAX_V) / K;   // windows a chunk
  float acc = 0.0f;
  for (int w0 = 0; w0 < nwin; w0 += per) {
    const int nw = min(per, nwin - w0);
    level_sync(one_warp);   // the scratch's last readers are done
    for (int t = threadIdx.x; t < nw * K; t += blockDim.x) {
      const int w = w0 + t / K, c = t % K;
      const int a = max((w << 5) - lo, 0), b = min((w << 5) - lo + 32, p.n);
      float sum = 0.0f;
#pragma unroll 8
      for (int j = a; j < b; ++j) sum = add(sum, val(j, c));
      s.red[t] = sum;
    }
    level_sync(one_warp);
    if (threadIdx.x < K)
      for (int i = 0; i < nw; ++i) acc = add(acc, s.red[i * K + threadIdx.x]);
  }
  level_sync(one_warp);
  if (threadIdx.x < K) s.red[threadIdx.x] = acc;
  level_sync(one_warp);
  for (int c = 0; c < K; ++c) out[c] = s.red[c];
}

// The per-choice area sums over n <= WINDOW tasks, as XLA:CPU's program
// takes them without a reduce-window: thread c a multiply-add chain from 0
// over the tasks in order.  Every thread gets the C sums in out.
__device__ void area_chain(const Problem& p, const Smem& s, float* out, bool one_warp) {
  level_sync(one_warp);   // the scratch's last readers are done
  if (threadIdx.x < p.C) {
    float acc = 0.0f;
    for (int j = 0; j < p.n; ++j) {
      const int64_t i = static_cast<int64_t>(j) * p.C + threadIdx.x;
      acc = fma_rn(__ldg(p.area + i), s.x[i], acc);
    }
    s.red[threadIdx.x] = acc;
  }
  level_sync(one_warp);
  for (int c = 0; c < p.C; ++c) out[c] = s.red[c];
}

template <bool CHOICE>
__device__ __forceinline__ float task_time(const Problem& p, const Smem& s, int j) {
  if (!CHOICE) {
    const float x = s.x[j];
    return add(mul(__ldg(p.pc + j), x), mul(__ldg(p.pg + j), sub(1.0f, x)));
  }
  const float* pr = p.p_choice + static_cast<int64_t>(j) * p.C;
  const float* xr = s.x + static_cast<int64_t>(j) * p.C;
  if (p.C == VECTOR_CHOICES) {   // rounded products, added in order from 0
    float t = 0.0f;
    for (int c = 0; c < p.C; ++c) t = add(t, mul(__ldg(pr + c), xr[c]));
    return t;
  }
  float t = mul(__ldg(pr), xr[0]);
  for (int c = 1; c < p.C; ++c) t = fma_rn(__ldg(pr + c), xr[c], t);
  return t;
}

// The expected crossing delay of task j's pred slot kk from pred q.
__device__ __forceinline__ float edge_delay(const Problem& p, const Smem& s, int j, int kk,
                                            int q) {
  const float* a = s.X + static_cast<int64_t>(q) * p.Q;
  const float* b = s.X + static_cast<int64_t>(j) * p.Q;
  float dot = mul(a[0], b[0]);
  for (int t = 1; t < p.Q; ++t) dot = fma_rn(a[t], b[t], dot);
  return mul(__ldg(p.pred_comm + static_cast<int64_t>(j) * p.P + kk), sub(1.0f, dot));
}

// X = x @ type_mask^T for every task, in the order of XLA:CPU's small
// matrix product (hlp_fo/ref.py::_gemm_xla): at C = 4, 8 and 12 lane i < 4
// a multiply-add chain over c = i, i + 4, ..., then (l0 + l1) + (l2 + l3);
// else one multiply-add chain.
__device__ void marginals(const Problem& p, const Smem& s) {
  const bool lanes = p.C == 4 || p.C == 8 || p.C == 12;
  for (int j = threadIdx.x; j < p.n; j += blockDim.x) {
    const float* xr = s.x + static_cast<int64_t>(j) * p.C;
    for (int q = 0; q < p.Q; ++q) {
      const float* tr = s.tm + q * p.C;
      float acc;
      if (lanes) {
        float l[4];
        for (int i = 0; i < 4; ++i) l[i] = mul(xr[i], tr[i]);
        for (int c = 4; c < p.C; ++c) l[c & 3] = fma_rn(xr[c], tr[c], l[c & 3]);
        acc = add(add(l[0], l[1]), add(l[2], l[3]));
      } else {
        acc = mul(xr[0], tr[0]);
        for (int c = 1; c < p.C; ++c) acc = fma_rn(xr[c], tr[c], acc);
      }
      s.X[static_cast<int64_t>(j) * p.Q + q] = acc;
    }
  }
}

// A task's indices from global memory: its id, its first PR pred ids and
// their edges, whether it has more, and, for the reverse walk, its
// successor range.  The loads that do not depend on one another are issued
// together, before any value is used.
struct Task {
  int j;
  int q[PR];
  int pe[PR];          // the first PR slots' edges (w's entries)
  int q_more;          // pred slot PR (-1: the task has at most PR slots)
  int e0, e1;          // reverse: the successor CSR's range
};

template <bool REVERSE>
__device__ __forceinline__ Task load_task(const Problem& p, int i) {
  Task a;
  a.j = __ldg(p.level_task + i);
  const int64_t row = static_cast<int64_t>(a.j) * p.P;
#pragma unroll
  for (int kk = 0; kk < PR; ++kk) {
    a.q[kk] = -1;
    a.pe[kk] = 0;
    if (kk < p.P) {
      a.q[kk] = __ldg(p.pred + row + kk);
      a.pe[kk] = __ldg(p.pred_edge + row + kk);
    }
  }
  a.q_more = -1;
  if (p.P > PR) a.q_more = __ldg(p.pred + row + PR);
  if (REVERSE) {
    a.e0 = __ldg(p.succ_ptr + a.j);
    a.e1 = __ldg(p.succ_ptr + a.j + 1);
  }
  return a;
}

// One task of the fused walk: its hard finish and, with `soft`, its soft
// finish, soft start, S + 1e-30 and each pred slot's weight in w.  A task
// of up to PR slots keeps them in registers, so their divisions and expf
// overlap; the sums still run in slot order.  In the choice solve a slot
// whose finish is the max stores its weight (exp(0) = 1) negated, so the
// reverse walk knows where the max's own cotangent goes; and the soft start
// is one multiply-add.
template <bool CHOICE, bool COMM>
__device__ __forceinline__ void forward_task(const Problem& p, const Smem& s, const Task& a,
                                             float tau, bool soft) {
  const int j = a.j;
  const float t = s.f[j];
  float hard = 0.0f, m = NEG, sum = 0.0f, start = 0.0f, sv = 0.0f;
  if (a.q[0] >= 0) {
    if (a.q_more < 0) {
      float pf[PR];
#pragma unroll
      for (int kk = 0; kk < PR; ++kk) {
        const int q = a.q[kk];
        pf[kk] = 0.0f;
        if (q >= 0) {
          const float d = COMM ? s.w[a.pe[kk]] : 0.0f;
          hard = max_nan(hard, COMM ? add(s.fh[q], d) : s.fh[q]);
          pf[kk] = COMM ? add(s.f[q], d) : s.f[q];
          m = max_nan(m, pf[kk]);
        }
      }
      if (soft) {
        float e[PR];
#pragma unroll
        for (int kk = 0; kk < PR; ++kk)
          e[kk] = a.q[kk] >= 0 ? exp_<CHOICE>(dvd(sub(pf[kk], m), tau)) : 0.0f;
#pragma unroll
        for (int kk = 0; kk < PR; ++kk)
          if (a.q[kk] >= 0) {
            s.w[a.pe[kk]] = CHOICE && pf[kk] == m ? -e[kk] : e[kk];
            sum = add(sum, e[kk]);
          }
      }
    } else {   // more slots, PR at a time: the slot finishes into w, then the weights
      const int* row = p.pred + static_cast<int64_t>(j) * p.P;
      const int* erow = p.pred_edge + static_cast<int64_t>(j) * p.P;
      int np = 0;                // the real slots: the row is filled from the left
      for (int k0 = 0; np == k0 && k0 < p.P; k0 += PR) {
        int q[PR], pe[PR];
#pragma unroll
        for (int u = 0; u < PR; ++u) {
          q[u] = -1;
          pe[u] = 0;
          if (k0 + u < p.P) {
            q[u] = __ldg(row + k0 + u);
            pe[u] = __ldg(erow + k0 + u);
          }
        }
#pragma unroll
        for (int u = 0; u < PR; ++u)
          if (q[u] >= 0) {
            const float d = COMM ? s.w[pe[u]] : 0.0f;
            hard = max_nan(hard, COMM ? add(s.fh[q[u]], d) : s.fh[q[u]]);
            const float pf = COMM ? add(s.f[q[u]], d) : s.f[q[u]];
            m = max_nan(m, pf);
            s.w[pe[u]] = pf;
            ++np;
          }
      }
      if (soft) {
        for (int k0 = 0; k0 < np; k0 += PR) {
          int pe[PR];
          float e[PR];
          bool hit[PR];
#pragma unroll
          for (int u = 0; u < PR; ++u) pe[u] = k0 + u < np ? __ldg(erow + k0 + u) : 0;
#pragma unroll
          for (int u = 0; u < PR; ++u) {
            const float pf = k0 + u < np ? s.w[pe[u]] : 0.0f;
            hit[u] = CHOICE && pf == m;
            e[u] = k0 + u < np ? exp_<CHOICE>(dvd(sub(pf, m), tau)) : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < PR; ++u)
            if (k0 + u < np) {
              s.w[pe[u]] = hit[u] ? -e[u] : e[u];
              sum = add(sum, e[u]);
            }
        }
      }
    }
    if (soft) {
      sv = CHOICE ? fma_rn(tau, log_<true>(add(sum, TINY)), m) : add(m, mul(tau, logf(add(sum, TINY))));
      start = max_nan(sv, 0.0f);
    }
  }
  s.fh[j] = add(hard, t);
  if (soft) {
    s.f[j] = add(start, t);
    s.sv[j] = sv;
    s.st[j] = add(sum, TINY);
  }
}

// One walk over the levels on the current x: every task's hard finish
// and, with `soft`, its soft finish, its soft start and S + 1e-30 at tau,
// and each pred slot's weight exp((pf - m) / tau) in w.
template <bool CHOICE, bool COMM>
__device__ void fused_forward(const Problem& p, const Smem& s, float tau, bool soft,
                              bool one_warp) {
  for (int l = 0; l < p.levels; ++l) {
    for (int i = s.lp[l] + threadIdx.x; i < s.lp[l + 1]; i += blockDim.x) {
      forward_task<CHOICE, COMM>(p, s, load_task<false>(p, i), tau, soft);
    }
    level_sync(one_warp);
  }
}

// Pool q's load from the per-choice area sums v[1..C]:
// (type_mask @ sums)[q] * inv_counts[q], the dot as XLA:CPU's tiled
// matrix-vector product (hlp_fo/ref.py::_gemv_xla): the first C - C % 8
// columns in 8 lanes, each a multiply-add chain from 0 over the tiles, the
// lanes folded in halves; the rest one multiply-add chain, added last.
__device__ __forceinline__ float pool_load(const Problem& p, const Smem& s,
                                           const float (&v)[MAX_V], int q) {
  const float* tr = s.tm + q * p.C;
  const int full = p.C - p.C % 8;
  float acc;
  if (full) {
    float l[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < full; ++c) l[c & 7] = fma_rn(tr[c], v[1 + c], l[c & 7]);
    for (int h = 4; h > 0; h >>= 1)
      for (int i = 0; i < h; ++i) l[i] = add(l[i], l[i + h]);
    float tail = 0.0f;
    for (int c = full; c < p.C; ++c) tail = fma_rn(tr[c], v[1 + c], tail);
    acc = add(l[0], tail);
  } else {
    acc = mul(tr[0], v[1]);
    for (int c = 1; c < p.C; ++c) acc = fma_rn(tr[c], v[1 + c], acc);
  }
  return mul(acc, s.inv[q]);
}

// The loss's cotangents at one step, the same on every thread.
struct Grad {
  float tau, cfin;         // tau; hybrid: the final soft max's coefficient
  float dc, dg;            // hybrid: d loss / d (pc.x), d loss / d (pg.(1 - x))
  float gsf, gmfin;        // choice: d loss / d (the final soft max's sum), / d M
  float gpc[MAX_C];        // choice: d loss / d (per-choice area sum)
};

// The choice loss's cotangents in XLA's order from the max soft finish M
// and the per-choice area sums: f becomes exp((f - M) / tau), negated at
// the tasks whose finish is M (where d loss / d M goes).
__device__ Grad choice_loss_grad(const Problem& p, const Smem& s, float tau, float M,
                                 const float (&sums)[MAX_V], bool one_warp) {
  for (int j = threadIdx.x; j < p.n; j += blockDim.x) {
    const float f = s.f[j];
    const float e = exp_<true>(dvd(sub(f, M), tau));
    s.f[j] = f == M ? -e : e;
  }
  float sf[2];   // the soft max's sum and the count of tasks at M
  window_sum(p, s, 2, [&](int j, int c) {
    const float e = s.f[j];
    return c == 0 ? fabsf(e) : (e < 0.0f ? 1.0f : 0.0f);
  }, sf, one_warp);
  float terms[1 + MAX_Q];
  const int nt = 1 + p.Q;
  terms[0] = fma_rn(tau, log_<true>(add(sf[0], TINY)), M);
  for (int q = 0; q < p.Q; ++q) terms[1 + q] = pool_load(p, s, sums, q);
  float mx = terms[0];
  for (int i = 1; i < nt; ++i) mx = max_nan(mx, terms[i]);
  float e[1 + MAX_Q];
  float st = 0.0f;
  for (int i = 0; i < nt; ++i) {
    e[i] = exp_<true>(dvd(sub(terms[i], mx), tau));
    st = add(st, e[i]);
  }
  const float r = dvd(tau, st);
  float gsum = 0.0f;
  int at_mx = 0;
  for (int i = 0; i < nt; ++i) {
    e[i] = dvd(mul(r, e[i]), tau);   // each term's cotangent from the log-sum
    gsum = add(gsum, e[i]);
    at_mx += terms[i] == mx;
  }
  const float gmx = dvd(sub(1.0f, gsum), static_cast<float>(at_mx));
  for (int i = 0; i < nt; ++i) e[i] = add(e[i], terms[i] == mx ? gmx : 0.0f);
  Grad g;
  g.tau = tau;
  g.cfin = g.dc = g.dg = 0.0f;
  g.gsf = dvd(mul(tau, e[0]), add(sf[0], TINY));
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    float acc = 0.0f;
    if (c < p.C) {
      acc = mul(mul(e[1], s.inv[0]), s.tm[c]);
      for (int q = 1; q < p.Q; ++q) acc = fma_rn(mul(e[1 + q], s.inv[q]), s.tm[q * p.C + c], acc);
    }
    g.gpc[c] = acc;
  }
  float sg[1];
  window_sum(p, s, 1, [&](int j, int) { return dvd(mul(g.gsf, fabsf(s.f[j])), tau); }, sg,
             one_warp);
  g.gmfin = dvd(sub(e[0], sg[0]), sf[1]);
  return g;
}

// The hybrid loss's cotangents from the max soft finish M and the pool
// loads in `sums`: the second reduction (the soft max's sum), whose terms
// stay in f.
__device__ Grad hybrid_loss_grad(const Problem& p, const Smem& s, float tau, float M,
                                 const float (&sums)[MAX_V], bool one_warp) {
  float v[MAX_V];
  v[0] = 0.0f;
  for (int j = threadIdx.x; j < p.n; j += blockDim.x) {
    const float e = expf(dvd(sub(s.f[j], M), tau));
    s.f[j] = e;
    v[0] = add(v[0], e);
  }
  block_reduce(v, 1, 0u, s.red, one_warp);
  const float sum_f = v[0];
  // the smooth max of [cp, loads...]
  const float terms[3] = {add(M, mul(tau, logf(add(sum_f, TINY)))),
                          dvd(sums[1], static_cast<float>(p.m)),
                          dvd(sums[2], static_cast<float>(p.k))};
  float mx = terms[0];
  for (int i = 1; i < 3; ++i) mx = max_nan(mx, terms[i]);
  float e[3];
  float st = 0.0f;
  for (int i = 0; i < 3; ++i) {
    e[i] = expf(dvd(sub(terms[i], mx), tau));
    st = add(st, e[i]);
  }
  const float w = dvd(tau, st);       // (1 tau) / sum: the log's cotangent
  Grad g;
  g.tau = tau;
  g.cfin = dvd(mul(dvd(mul(w, e[0]), tau), tau), add(sum_f, TINY));
  g.dc = dvd(dvd(mul(w, e[1]), tau), static_cast<float>(p.m));
  g.dg = dvd(dvd(mul(w, e[2]), tau), static_cast<float>(p.k));
  g.gsf = g.gmfin = 0.0f;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) g.gpc[c] = 0.0f;
  return g;
}

// A task's adjoint g_f from `gf` (the final soft max's share) and the
// slot cotangents its successors stored, w[e0 .. e1): the loads first, then
// the adds in CSR order.
__device__ __forceinline__ float successors_sum(const Smem& s, const Task& a, float gf) {
  int e = a.e0;
  for (; e + 4 <= a.e1; e += 4) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = s.w[e + u];
#pragma unroll
    for (int u = 0; u < 4; ++u) gf = add(gf, v[u]);
  }
  for (; e < a.e1; ++e) gf = add(gf, s.w[e]);
  return gf;
}

// One task of the hybrid solve's reverse walk: its adjoint g_f from the gp
// its successors stored (successors_sum), then its coefficient c and its
// own slots' gp = c w / tau in place (PR at a time, so the divisions
// overlap).  Leaves g_f in f.
__device__ __forceinline__ void reverse_task(const Problem& p, const Smem& s, const Task& a,
                                             const Grad& g) {
  const float tau = g.tau;
  const int j = a.j;
  const float gf = successors_sum(s, a, dvd(mul(g.cfin, s.f[j]), tau));
  if (a.q[0] >= 0) {
    const float soft = s.sv[j];
    // jnp.maximum(soft, 0) sends half of the cotangent each way at a tie
    const float gs = soft > 0.0f ? gf : (soft == 0.0f ? mul(0.5f, gf) : 0.0f);
    const float cj = dvd(mul(gs, tau), s.st[j]);
    if (a.q_more < 0) {
#pragma unroll
      for (int kk = 0; kk < PR; ++kk)
        if (a.q[kk] >= 0) s.w[a.pe[kk]] = dvd(mul(cj, s.w[a.pe[kk]]), tau);
    } else {   // more slots: PR divisions at a time
      const int* row = p.pred + static_cast<int64_t>(j) * p.P;
      const int* erow = p.pred_edge + static_cast<int64_t>(j) * p.P;
      for (int k0 = 0, full = 1; full && k0 < p.P; k0 += PR) {
        int q[PR], pe[PR];
        float v[PR];
#pragma unroll
        for (int u = 0; u < PR; ++u) {
          q[u] = -1;
          pe[u] = 0;
          if (k0 + u < p.P) {
            q[u] = __ldg(row + k0 + u);
            pe[u] = __ldg(erow + k0 + u);
          }
        }
#pragma unroll
        for (int u = 0; u < PR; ++u) v[u] = q[u] >= 0 ? dvd(mul(cj, s.w[pe[u]]), tau) : 0.0f;
#pragma unroll
        for (int u = 0; u < PR; ++u)
          if (q[u] >= 0) s.w[pe[u]] = v[u];
        full = q[PR - 1] >= 0;
      }
    }
  }
  s.f[j] = gf;
}

// One task of the choice solve's reverse walk, in XLA's order: its adjoint
// g_f (the final soft max's share, gsf exp((f - M) / tau) / tau, plus gmfin
// where its finish is M, then its successors' stored slot cotangents, whose
// lists the wrapper ordered by descending topological place); then its soft
// start's share gs of g_f, gS = tau gs / S, and in place of each of its own
// slots' weight w that slot's cotangent gm [w hit the max] + gS w / tau,
// where gm = (gs - the sum of the gS w / tau) / (the slots at the max) is the
// cotangent through the max.  A task of more than PR slots takes two passes
// over them, PR at a time: the sum and the count, then the cotangents.
// Leaves 0 + g_f, the task time's cotangent, in f.
__device__ __forceinline__ void reverse_task_choice(const Problem& p, const Smem& s,
                                                    const Task& a, const Grad& g) {
  const float tau = g.tau;
  const int j = a.j;
  const float ef = s.f[j];
  const float gf = successors_sum(
      s, a, add(dvd(mul(g.gsf, fabsf(ef)), tau), ef < 0.0f ? g.gmfin : 0.0f));
  if (a.q[0] >= 0) {
    const float soft = s.sv[j];
    // jnp.maximum(soft, 0) sends half of the cotangent each way at a tie
    const float gs = mul(gf, soft > 0.0f ? 1.0f : (soft == 0.0f ? 0.5f : 0.0f));
    const float gS = dvd(mul(tau, gs), s.st[j]);
    float sum = 0.0f;
    int hits = 0;
    if (a.q_more < 0) {
      float ge[PR];
      bool hit[PR];
#pragma unroll
      for (int kk = 0; kk < PR; ++kk) {
        const float w = a.q[kk] >= 0 ? s.w[a.pe[kk]] : 0.0f;
        hit[kk] = w < 0.0f;
        ge[kk] = dvd(mul(gS, fabsf(w)), tau);
      }
#pragma unroll
      for (int kk = 0; kk < PR; ++kk)
        if (a.q[kk] >= 0) {
          sum = add(sum, ge[kk]);
          hits += hit[kk];
        }
      const float gm = dvd(sub(gs, sum), static_cast<float>(hits));
#pragma unroll
      for (int kk = 0; kk < PR; ++kk)
        if (a.q[kk] >= 0) s.w[a.pe[kk]] = add(0.0f, fma_rn(gm, hit[kk] ? 1.0f : 0.0f, ge[kk]));
    } else {
      const int* row = p.pred + static_cast<int64_t>(j) * p.P;
      const int* erow = p.pred_edge + static_cast<int64_t>(j) * p.P;
      for (int pass = 0; pass < 2; ++pass) {
        const float gm = pass ? dvd(sub(gs, sum), static_cast<float>(hits)) : 0.0f;
        for (int k0 = 0, full = 1; full && k0 < p.P; k0 += PR) {
          int q[PR], pe[PR];
#pragma unroll
          for (int u = 0; u < PR; ++u) {
            q[u] = -1;
            pe[u] = 0;
            if (k0 + u < p.P) {
              q[u] = __ldg(row + k0 + u);
              pe[u] = __ldg(erow + k0 + u);
            }
          }
          float w[PR];
#pragma unroll
          for (int u = 0; u < PR; ++u) w[u] = q[u] >= 0 ? s.w[pe[u]] : 0.0f;
#pragma unroll
          for (int u = 0; u < PR; ++u)
            if (q[u] >= 0) {
              const float ge = dvd(mul(gS, fabsf(w[u])), tau);
              if (pass == 0) {
                sum = add(sum, ge);
                hits += w[u] < 0.0f;
              } else {
                s.w[pe[u]] = add(0.0f, fma_rn(gm, w[u] < 0.0f ? 1.0f : 0.0f, ge));
              }
            }
          full = q[PR - 1] >= 0;
        }
      }
    }
  }
  s.f[j] = add(0.0f, gf);
}

// The reverse walk, level by level from the last.
template <bool CHOICE>
__device__ void reverse_walk(const Problem& p, const Smem& s, const Grad& g, bool one_warp) {
  for (int l = p.levels - 1; l >= 0; --l) {
    for (int i = s.lp[l] + threadIdx.x; i < s.lp[l + 1]; i += blockDim.x) {
      if (CHOICE)
        reverse_task_choice(p, s, load_task<true>(p, i), g);
      else
        reverse_task(p, s, load_task<true>(p, i), g);
    }
    level_sync(one_warp);
  }
}

// One Adam step on entry i; returns the new logit.  The choice entry takes
// each moment as one multiply-add, b mu + ((1 - b) g), as XLA's program for
// the reference contracts it.
template <bool CHOICE>
__device__ __forceinline__ float adam(float* z, float* mu, float* nu, int64_t i, float gz,
                                      float bc1, float bc2) {
  const float m1 = CHOICE ? fma_rn(mu[i], B1, mul(gz, ONE_B1)) : add(mul(B1, mu[i]), mul(ONE_B1, gz));
  const float v1 = CHOICE ? fma_rn(nu[i], B2, mul(mul(gz, ONE_B2), gz))
                          : add(mul(B2, nu[i]), mul(mul(ONE_B2, gz), gz));
  mu[i] = m1;
  nu[i] = v1;
  const float zn = sub(z[i], dvd(mul(LR, dvd(m1, bc1)), add(sqrtf(dvd(v1, bc2)), EPS)));
  z[i] = zn;
  return zn;
}

__device__ __forceinline__ float sigmoid(float z) {
  return dvd(1.0f, add(1.0f, expf(-z)));
}

// softmax of a row of c logits into out, its exps e = exp(z - max) into
// e_out (the next chain rule's, which sums them again in the same order)
__device__ __forceinline__ void softmax_row(const float* z, float* out, float* e_out,
                                            int c) {
  float mx = z[0];
  for (int i = 1; i < c; ++i) mx = max_nan(mx, z[i]);
  float e[MAX_C];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_C; ++i)
    if (i < c) {
      e[i] = xla_math::xla_exp_f32(sub(z[i], mx));
      e_out[i] = e[i];
      sum = add(sum, e[i]);
    }
#pragma unroll
  for (int i = 0; i < MAX_C; ++i)
    if (i < c) out[i] = dvd(e[i], sum);
}

// The chain rule from each task's g_f (and, with use_comm, the type
// marginals' cotangent from the stored slot cotangents) into its logits,
// in XLA's order in the choice solve, its Adam step and its new x: every
// task at once, off the level chain.
template <bool CHOICE, bool COMM>
__device__ void adam_pass(const Problem& p, const Smem& s, const Grad& g, float bc1,
                          float bc2) {
  for (int j = threadIdx.x; j < p.n; j += blockDim.x) {
    const float gf = s.f[j];
    if (!CHOICE) {
      const float x = s.x[j];
      const float pcj = __ldg(p.pc + j), pgj = __ldg(p.pg + j);
      float gx = sub(mul(gf, pcj), mul(gf, pgj));
      gx = add(gx, mul(g.dc, pcj));
      gx = sub(gx, mul(g.dg, pgj));
      const float xn = sigmoid(adam<false>(p.z, p.mu, p.nu, j, mul(gx, mul(x, sub(1.0f, x))), bc1, bc2));
      s.x[j] = xn;
      s.f[j] = add(mul(pcj, xn), mul(pgj, sub(1.0f, xn)));   // the next walk's task time
      continue;
    }
    // with use_comm, the marginals' cotangent: the task's own slots'
    // crossings as a dot in multiply-adds, then its successors' in
    // ascending successor id (the id-ordered CSR); each slot's cotangent
    // lies in w at its pred_edge place
    float gX[MAX_Q];
#pragma unroll
    for (int q = 0; q < MAX_Q; ++q) gX[q] = -0.0f;   // no slot: X[n - 1] (-0)
    if (COMM) {
      const int* row = p.pred + static_cast<int64_t>(j) * p.P;
      for (int kk = 0; kk < p.P; ++kk) {
        const int q = __ldg(row + kk);
        if (q < 0) break;
        const int64_t slot = static_cast<int64_t>(j) * p.P + kk;
        const float gc = -mul(__ldg(p.pred_comm + slot), s.w[__ldg(p.pred_edge + slot)]);
        for (int t = 0; t < p.Q; ++t) {   // at 3 <= P < 8 type 0 unfused, as XLA's
          const float xv = s.X[static_cast<int64_t>(q) * p.Q + t];
          gX[t] = kk == 0 ? mul(xv, gc)
                  : (t == 0 && p.P >= 3 && p.P < 8) ? add(gX[t], mul(xv, gc))
                                                    : fma_rn(xv, gc, gX[t]);
        }
      }
      const int e1 = __ldg(p.succ_ptr + j + 1);
      for (int e = __ldg(p.succ_ptr + j); e < e1; ++e) {
        const int sj = __ldg(p.succ_task + e);
        const int64_t slot = static_cast<int64_t>(sj) * p.P + __ldg(p.succ_slot + e);
        const float gc = -mul(__ldg(p.pred_comm + slot), s.w[__ldg(p.pred_edge + slot)]);
        for (int q = 0; q < p.Q; ++q)
          gX[q] = add(gX[q], mul(gc, s.X[static_cast<int64_t>(sj) * p.Q + q]));
      }
    }
    // the softmax of the current logits: e = exp(z - max), kept from it,
    // and S their sum
    const int64_t base = static_cast<int64_t>(j) * p.C;
    float e[MAX_C], zn[MAX_C], gx[MAX_C], gxs[MAX_C];
    float S = 0.0f;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < p.C) {
        e[c] = p.ez[base + c];
        S = add(S, e[c]);
      }
    // x's cotangent: the times', the area sums' and the marginals'; with
    // use_comm XLA's program for the solve adds the marginals' share first,
    // p gf + (area gpc + that), two multiply-adds
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < p.C) {
        const float ar = __ldg(p.area + base + c), pc = __ldg(p.p_choice + base + c);
        if (COMM) {
          float dot = mul(gX[0], s.tm[c]);
          for (int q = 1; q < p.Q; ++q) dot = fma_rn(gX[q], s.tm[q * p.C + c], dot);
          gx[c] = fma_rn(pc, gf, fma_rn(ar, g.gpc[c], dot));
          gxs[c] = gx[c];
        } else {   // at VECTOR_CHOICES, gx / S contracts the other product
          gx[c] = fma_rn(ar, g.gpc[c], mul(pc, gf));
          gxs[c] = p.C == VECTOR_CHOICES ? fma_rn(pc, gf, mul(ar, g.gpc[c])) : gx[c];
        }
      }
    // through the softmax: (gx / S - sum_c gx e / S^2) e
    const float inv_s2 = dvd(1.0f, mul(S, S));
    float t = 0.0f;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < p.C) t = fma_rn(mul(gx[c], inv_s2), e[c], t);
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < p.C)
        zn[c] = adam<true>(p.z, p.mu, p.nu, base + c, mul(sub(dvd(gxs[c], S), t), e[c]), bc1, bc2);
    softmax_row(zn, s.x + base, p.ez + base, p.C);
    s.f[j] = task_time<true>(p, s, j);
  }
}

// With use_comm: the type marginals X of the current x, then each pred
// slot's expected crossing delay into w, where the next walk reads it.
__device__ void comm_delays(const Problem& p, const Smem& s, bool one_warp) {
  marginals(p, s);
  level_sync(one_warp);
  for (int j = threadIdx.x; j < p.n; j += blockDim.x) {
    const int* row = p.pred + static_cast<int64_t>(j) * p.P;
    for (int kk = 0; kk < p.P; ++kk) {
      const int q = __ldg(row + kk);
      if (q < 0) break;
      s.w[__ldg(p.pred_edge + static_cast<int64_t>(j) * p.P + kk)] = edge_delay(p, s, j, kk, q);
    }
  }
  level_sync(one_warp);
}

// One block a solve: the second bound lets ptxas use up to 128 registers
// (left to itself it holds the hybrid kernel to 40 and spills).
template <bool CHOICE, bool COMM, bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS, 1)
hlp_fo_sm90_kernel(Problem p) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve<SHARED>(smem, p, COMM);
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool one_warp = nt == 32;
  const int64_t entries = static_cast<int64_t>(p.n) * p.C;
  for (int i = tid; i <= p.levels; i += nt) s.lp[i] = __ldg(p.level_ptr + i);
  if (CHOICE) {
    for (int i = tid; i < p.Q * p.C; i += nt) s.tm[i] = __ldg(p.type_mask + i);
    for (int i = tid; i < p.Q; i += nt) s.inv[i] = __ldg(p.inv_counts + i);
  }
  for (int64_t i = tid; i < entries; i += nt) {
    p.z[i] = __ldg(p.z0 + i);
    p.mu[i] = 0.0f;
    p.nu[i] = 0.0f;
  }
  float v[MAX_V];
#pragma unroll
  for (int i = 0; i < MAX_V; ++i) v[i] = 0.0f;
  v[0] = NEG;
  if (!CHOICE) {
    for (int j = tid; j < p.n; j += nt) {
      s.x[j] = sigmoid(__ldg(p.z0 + j));
      s.f[j] = task_time<false>(p, s, j);
      v[0] = max_nan(v[0], max_nan(__ldg(p.pc + j), __ldg(p.pg + j)));
    }
  } else {
    for (int j = tid; j < p.n; j += nt) {
      const int64_t base = static_cast<int64_t>(j) * p.C;
      float zr[MAX_C];
      for (int c = 0; c < p.C; ++c) {
        zr[c] = __ldg(p.z0 + base + c);
        const float pv = __ldg(p.p_choice + base + c);
        v[0] = max_nan(v[0], isfinite(pv) ? pv : 0.0f);
      }
      softmax_row(zr, s.x + base, p.ez + base, p.C);
      s.f[j] = task_time<true>(p, s, j);
    }
  }
  block_reduce(v, 1, 1u, s.red, one_warp);   // also publishes the staging above
  const float scale = v[0];
  if (COMM) comm_delays(p, s, one_warp);
  // v[0] the max hard finish, v[nl] the max soft finish; between them the
  // hybrid solve's two load sums (the choice solve's area sums follow in
  // XLA's windows)
  const int nl = CHOICE ? 1 : 3;
  float best = 0.0f;
  long long phase[4] = {0, 0, 0, 0};
  float sched[3] = {0.0f, 0.0f, 0.0f};   // step it's row, loaded a step ahead
  if (p.iters > 0)
    for (int c = 0; c < 3; ++c) sched[c] = __ldg(p.sched + c);
  for (int it = 0;; ++it) {
    const bool soft = it < p.iters;
    const float factor = sched[0], bc1 = sched[1], bc2 = sched[2];
    if (it + 1 < p.iters)
      for (int c = 0; c < 3; ++c) sched[c] = __ldg(p.sched + 3 * static_cast<int64_t>(it + 1) + c);
    const float tau = soft ? mul(scale, factor) : 0.0f;
    const long long t0 = clock64();
    // the exact lambda of the current x and, with `soft`, step it's forward
    fused_forward<CHOICE, COMM>(p, s, tau, soft, one_warp);
#pragma unroll
    for (int i = 0; i < MAX_V; ++i) v[i] = 0.0f;
    v[0] = NEG;
    v[nl] = NEG;
    for (int j = tid; j < p.n; j += nt) {
      v[0] = max_nan(v[0], s.fh[j]);
      if (!CHOICE) {
        const float x = s.x[j];
        v[1] = add(v[1], mul(__ldg(p.pc + j), x));
        v[2] = add(v[2], mul(__ldg(p.pg + j), sub(1.0f, x)));
      }
      if (soft) v[nl] = max_nan(v[nl], s.f[j]);
    }
    block_reduce(v, soft ? nl + 1 : nl, 1u | (1u << nl), s.red, one_warp);
    const float M = v[nl];
    if (CHOICE && p.n > WINDOW)   // the per-choice area sums, in XLA's windows
      window_sum(p, s, p.C, [&](int j, int c) {
        const int64_t i = static_cast<int64_t>(j) * p.C + c;
        return mul(__ldg(p.area + i), s.x[i]);
      }, v + 1, one_warp);
    else if (CHOICE)              // over one window: a multiply-add chain
      area_chain(p, s, v + 1, one_warp);
    float lam = v[0];
    if (!CHOICE) {
      lam = max_nan(lam, max_nan(dvd(v[1], static_cast<float>(p.m)),
                                 dvd(v[2], static_cast<float>(p.k))));
    } else {
      float mx = pool_load(p, s, v, 0);
      for (int q = 1; q < p.Q; ++q) mx = max_nan(mx, pool_load(p, s, v, q));
      lam = max_nan(lam, mx);
    }
    if (it == 0 || lam < best) {   // the same on every thread
      best = lam;
      for (int64_t i = tid; i < entries; i += nt) p.best_x[i] = s.x[i];
    }
    if (!soft) break;
    const long long t1 = clock64();
    const Grad g = CHOICE ? choice_loss_grad(p, s, tau, M, v, one_warp)
                          : hybrid_loss_grad(p, s, tau, M, v, one_warp);
    const long long t2 = clock64();
    reverse_walk<CHOICE>(p, s, g, one_warp);
    const long long t3 = clock64();
    adam_pass<CHOICE, COMM>(p, s, g, bc1, bc2);
    level_sync(one_warp);
    if (COMM) comm_delays(p, s, one_warp);
    phase[0] += t1 - t0;
    phase[1] += t2 - t1;
    phase[2] += t3 - t2;
    phase[3] += clock64() - t3;
  }
  if (tid == 0) {
    p.best_val[0] = best;
    if (p.cycles != nullptr)
      for (int i = 0; i < 4; ++i) p.cycles[i] = phase[i];
  }
}

// The chain floor: `steps` level steps of `blockDim.x` threads, each a
// shared-memory read of another thread's value from the last step, one
// expf and one logf on it (the soft step's two transcendentals), a store
// into the other buffer and a barrier.  The values start at 0 and stay 0
// (log(exp(0) + 1e-30) rounds to 0), which the compiler cannot know;
// `out[0]` keeps the result.
__global__ void __launch_bounds__(MAX_THREADS)
chain_probe_kernel(float* out, int steps, float tau) {
  __shared__ float buf[2][MAX_THREADS];
  const int tid = threadIdx.x, nt = blockDim.x;
  buf[0][tid] = 0.0f;
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const float* src = buf[t & 1];
    const float pf = src[(tid + 1 + t) % nt];
    const float m = src[tid];
    const float soft = add(m, mul(tau, logf(add(expf(dvd(sub(pf, m), tau)), TINY))));
    buf[(t + 1) & 1][tid] = max_nan(soft, 0.0f);
    __syncthreads();
  }
  if (tid == 0) out[0] = buf[steps & 1][0];
}

// XLA:CPU's float32 exp (op 0) or log (op 1) of n values as the choice
// solve computes them (xla_math.cuh), for the card tests to hold to the
// plain version's twins.
__global__ void transcendental_kernel(const float* x, float* y, int64_t n, int op) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    y[i] = op == 0 ? xla_math::xla_exp_f32(x[i]) : xla_math::xla_log_f32(x[i]);
}

unsigned long long g_configured[6] = {0, 0, 0, 0, 0, 0};   // per kernel: devices set up

template <bool CHOICE, bool COMM, bool SHARED>
int go(const Problem& p, int threads, cudaStream_t stream, int64_t bytes, int slot) {
  const cudaError_t err =
      allow_smem(hlp_fo_sm90_kernel<CHOICE, COMM, SHARED>, SMEM_LIMIT, g_configured[slot]);
  if (err != cudaSuccess) return static_cast<int>(err);
  hlp_fo_sm90_kernel<CHOICE, COMM, SHARED><<<1, threads, static_cast<size_t>(bytes), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The shared layout without scratch, the global one with it.
template <bool CHOICE, bool COMM>
int launch(const Problem& p, int threads, cudaStream_t stream, int slot) {
  if (p.n <= 0 || p.P <= 0 || p.E < 0 || p.levels <= 0 || p.iters < 0 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || p.C < 1 || p.C > MAX_C ||
      p.Q < 0 || p.Q > MAX_Q || (CHOICE && p.Q < 1))
    return cudaErrorInvalidValue;
  const bool shared = p.scratch == nullptr;
  const int64_t bytes = 4 * smem_floats(p.n, p.levels, p.C, p.Q, p.E, COMM, shared);
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  return shared ? go<CHOICE, COMM, true>(p, threads, stream, bytes, 2 * slot)
                : go<CHOICE, COMM, false>(p, threads, stream, bytes, 2 * slot + 1);
}

}  // namespace

extern "C" long long hlp_fo_sm90_smem_bytes(int n, int levels, int c, int q, int e,
                                            int comm, int shared) {
  return 4 * smem_floats(n, levels, c, q, e, comm != 0, shared != 0);
}

extern "C" int hlp_fo_sm90_hybrid_f32(const int* level_ptr, const int* level_task,
                                      const int* pred, const int* succ_ptr,
                                      const int* succ_task, const int* succ_slot,
                                      const int* pred_edge, const float* pc, const float* pg,
                                      const float* sched, const float* z0, float* z,
                                      float* mu, float* nu, float* best_x, float* best_val,
                                      float* scratch, long long* cycles, int n, int P, int E,
                                      int levels, int iters, int m, int k, int threads,
                                      cudaStream_t stream) {
  if (m <= 0 || k <= 0) return cudaErrorInvalidValue;
  Problem p{level_ptr, level_task, pred, succ_ptr, succ_task, succ_slot, pred_edge, pc, pg,
            nullptr, nullptr, nullptr, nullptr, nullptr, sched, z0, z, mu, nu, nullptr,
            best_x, best_val, scratch, cycles, n, P, E, levels, 1, 0, iters, m, k};
  return launch<false, false>(p, threads, stream, 0);
}

extern "C" int hlp_fo_sm90_choice_f32(const int* level_ptr, const int* level_task,
                                      const int* pred, const int* succ_ptr,
                                      const int* succ_task, const int* succ_slot,
                                      const int* pred_edge, const float* p_choice,
                                      const float* area, const float* type_mask,
                                      const float* inv_counts, const float* pred_comm,
                                      const float* sched, const float* z0, float* z,
                                      float* mu, float* nu, float* ez, float* best_x,
                                      float* best_val, float* scratch, long long* cycles,
                                      int n, int P, int E, int levels, int C, int Q,
                                      int iters, int use_comm, int threads,
                                      cudaStream_t stream) {
  Problem p{level_ptr, level_task, pred, succ_ptr, succ_task, succ_slot, pred_edge,
            nullptr, nullptr, p_choice, area, type_mask, inv_counts, pred_comm, sched, z0,
            z, mu, nu, ez, best_x, best_val, scratch, cycles, n, P, E, levels, C, Q, iters,
            1, 1};
  return use_comm ? launch<true, true>(p, threads, stream, 2)
                  : launch<true, false>(p, threads, stream, 1);
}

extern "C" int hlp_fo_sm90_chain_probe(float* out, int steps, int threads,
                                       cudaStream_t stream) {
  if (steps <= 0 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0)
    return cudaErrorInvalidValue;
  chain_probe_kernel<<<1, threads, 0, stream>>>(out, steps, 0.125f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hlp_fo_sm90_transcendental_f32(const float* x, float* y, long long n, int op,
                                             cudaStream_t stream) {
  if (n < 0 || (op != 0 && op != 1)) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long blocks = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
  transcendental_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(x, y, n, op);
  return static_cast<int>(cudaGetLastError());
}
