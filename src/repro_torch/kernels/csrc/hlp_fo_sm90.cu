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
// It computes what hlp_fo.cu (the first design, kept as a yardstick)
// computes, bit for bit: every float operation keeps its operands and its
// single rounding (__fadd_rn / __fmul_rn / __fdiv_rn, no FMA, full-precision
// expf / logf / sqrtf), and every sum keeps its order, so the best x and
// lambda are the same.  hlp_fo/ref.py holds the plain versions; their
// gradient comes from autograd, this kernel's from the reverse scan below,
// which drops the gradient through each max (it cancels in exact
// arithmetic), so the two agree to rounding.
//
// What bounds it on the H100: a chain of dependent level steps, each ended
// by a barrier; its inputs are a few hundred KB, read from L2 after the
// first step.  hlp_fo.cu walks the levels three times a step (soft
// forward, reverse, exact forward) and pays one expf and two divisions per
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
//     cotangent from the stored gp (in hlp_fo.cu's order), the marginals of
//     the new x and each slot's crossing delay (left in w).
//   * A task of up to PR pred slots keeps them in registers, so their
//     divisions and expf overlap; a longer row goes PR slots at a time.
//   * Adam's z, mu and nu stay in global memory: hlp_fo.cu's reverse split
//     (chip_smoke.py, potri nb=20) gives their loads and stores under 10%
//     of its reverse pass, and the pass here is off the chain.
//   * A block of one warp (the campaign's solves) ends each level with
//     __syncwarp instead of __syncthreads.
//   * Two layouts, chosen by size alone: the per-task arrays and the edge
//     buffer in shared memory, or, past 227 KB, in a global scratch buffer
//     the caller passes (L1-cached; only the level offsets, the type mask
//     and the reductions' scratch stay in shared memory).  So every problem
//     hlp_fo.cu takes, this kernel takes too.
//
// C interface (loaded with ctypes): hlp_fo_sm90_hybrid_f32 and
// hlp_fo_sm90_choice_f32 return the cudaError_t of the shared-memory
// attribute call or of the launch as an int, 0 on success, and, given a
// `cycles` array, thread 0's clock cycles in each phase of the step;
// hlp_fo_sm90_smem_bytes the bytes a launch takes; hlp_fo_sm90_chain_probe
// times the chain floor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

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
// the sum of the other v[i], i < nv, in hlp_fo.cu's tree: a butterfly
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

template <bool CHOICE>
__device__ __forceinline__ float task_time(const Problem& p, const Smem& s, int j) {
  if (!CHOICE) {
    const float x = s.x[j];
    return add(mul(__ldg(p.pc + j), x), mul(__ldg(p.pg + j), sub(1.0f, x)));
  }
  const float* pr = p.p_choice + static_cast<int64_t>(j) * p.C;
  const float* xr = s.x + static_cast<int64_t>(j) * p.C;
  float t = mul(__ldg(pr), xr[0]);
  for (int c = 1; c < p.C; ++c) t = add(t, mul(__ldg(pr + c), xr[c]));
  return t;
}

// The expected crossing delay of task j's pred slot kk from pred q.
__device__ __forceinline__ float edge_delay(const Problem& p, const Smem& s, int j, int kk,
                                            int q) {
  const float* a = s.X + static_cast<int64_t>(q) * p.Q;
  const float* b = s.X + static_cast<int64_t>(j) * p.Q;
  float dot = mul(a[0], b[0]);
  for (int t = 1; t < p.Q; ++t) dot = add(dot, mul(a[t], b[t]));
  return mul(__ldg(p.pred_comm + static_cast<int64_t>(j) * p.P + kk), sub(1.0f, dot));
}

// X = x @ type_mask^T for every task.
__device__ void marginals(const Problem& p, const Smem& s) {
  for (int j = threadIdx.x; j < p.n; j += blockDim.x) {
    const float* xr = s.x + static_cast<int64_t>(j) * p.C;
    for (int q = 0; q < p.Q; ++q) {
      const float* tr = s.tm + q * p.C;
      float acc = mul(xr[0], tr[0]);
      for (int c = 1; c < p.C; ++c) acc = add(acc, mul(xr[c], tr[c]));
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
// overlap; the sums still run in slot order.
template <bool COMM>
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
          e[kk] = a.q[kk] >= 0 ? expf(dvd(sub(pf[kk], m), tau)) : 0.0f;
#pragma unroll
        for (int kk = 0; kk < PR; ++kk)
          if (a.q[kk] >= 0) {
            s.w[a.pe[kk]] = e[kk];
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
#pragma unroll
          for (int u = 0; u < PR; ++u) pe[u] = k0 + u < np ? __ldg(erow + k0 + u) : 0;
#pragma unroll
          for (int u = 0; u < PR; ++u)
            e[u] = k0 + u < np ? expf(dvd(sub(s.w[pe[u]], m), tau)) : 0.0f;
#pragma unroll
          for (int u = 0; u < PR; ++u)
            if (k0 + u < np) {
              s.w[pe[u]] = e[u];
              sum = add(sum, e[u]);
            }
        }
      }
    }
    if (soft) {
      sv = add(m, mul(tau, logf(add(sum, TINY))));
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
template <bool COMM>
__device__ void fused_forward(const Problem& p, const Smem& s, float tau, bool soft,
                              bool one_warp) {
  for (int l = 0; l < p.levels; ++l) {
    for (int i = s.lp[l] + threadIdx.x; i < s.lp[l + 1]; i += blockDim.x) {
      forward_task<COMM>(p, s, load_task<false>(p, i), tau, soft);
    }
    level_sync(one_warp);
  }
}

// Pool q's load from the per-choice area sums v[1..C]:
// (type_mask @ sums)[q] * inv_counts[q].
__device__ __forceinline__ float pool_load(const Problem& p, const Smem& s,
                                           const float (&v)[MAX_V], int q) {
  const float* tr = s.tm + q * p.C;
  float acc = mul(tr[0], v[1]);
  for (int c = 1; c < p.C; ++c) acc = add(acc, mul(tr[c], v[1 + c]));
  return mul(acc, s.inv[q]);
}

// The loss's cotangents at one step, the same on every thread.
struct Grad {
  float tau, cfin;         // tau, the final soft max's coefficient
  float dc, dg;            // hybrid: d loss / d (pc.x), d loss / d (pg.(1 - x))
  float gpc[MAX_C];        // choice: d loss / d (per-choice area sum)
};

// The loss's cotangents from the max soft finish M and the pool loads in
// `sums`: the second reduction (the soft max's sum), whose terms stay in f.
template <bool CHOICE>
__device__ Grad loss_grad(const Problem& p, const Smem& s, float tau, float M,
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
  float terms[1 + MAX_Q];
  int nt = 0;
  terms[nt++] = add(M, mul(tau, logf(add(sum_f, TINY))));
  if (!CHOICE) {
    terms[nt++] = dvd(sums[1], static_cast<float>(p.m));
    terms[nt++] = dvd(sums[2], static_cast<float>(p.k));
  } else {
    for (int q = 0; q < p.Q; ++q) terms[nt++] = pool_load(p, s, sums, q);
  }
  float mx = terms[0];
  for (int i = 1; i < nt; ++i) mx = max_nan(mx, terms[i]);
  float e[1 + MAX_Q];
  float st = 0.0f;
  for (int i = 0; i < nt; ++i) {
    e[i] = expf(dvd(sub(terms[i], mx), tau));
    st = add(st, e[i]);
  }
  const float w = dvd(tau, st);       // (1 tau) / sum: the log's cotangent
  Grad g;
  g.tau = tau;
  g.cfin = dvd(mul(dvd(mul(w, e[0]), tau), tau), add(sum_f, TINY));
  g.dc = g.dg = 0.0f;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) g.gpc[c] = 0.0f;
  if (!CHOICE) {
    g.dc = dvd(dvd(mul(w, e[1]), tau), static_cast<float>(p.m));
    g.dg = dvd(dvd(mul(w, e[2]), tau), static_cast<float>(p.k));
  } else {
    for (int q = 0; q < p.Q; ++q) {
      const float gq = mul(dvd(mul(w, e[1 + q]), tau), s.inv[q]);
      const float* tr = s.tm + q * p.C;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < p.C) g.gpc[c] = add(g.gpc[c], mul(tr[c], gq));
    }
  }
  return g;
}

// One task of the reverse walk: its adjoint g_f from the gp its
// successors stored, w[e0 .. e1) (the loads first, then the adds in CSR
// order), then its coefficient c and its own slots' gp = c w / tau in
// place (PR at a time, so the divisions overlap).  Leaves g_f in f.
__device__ __forceinline__ void reverse_task(const Problem& p, const Smem& s, const Task& a,
                                             const Grad& g) {
  const float tau = g.tau;
  const int j = a.j;
  float gf = dvd(mul(g.cfin, s.f[j]), tau);
  int e = a.e0;
  for (; e + 4 <= a.e1; e += 4) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = s.w[e + u];
#pragma unroll
    for (int u = 0; u < 4; ++u) gf = add(gf, v[u]);
  }
  for (; e < a.e1; ++e) gf = add(gf, s.w[e]);
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

// The reverse walk, level by level from the last.
__device__ void reverse_walk(const Problem& p, const Smem& s, const Grad& g, bool one_warp) {
  for (int l = p.levels - 1; l >= 0; --l) {
    for (int i = s.lp[l] + threadIdx.x; i < s.lp[l + 1]; i += blockDim.x) {
      reverse_task(p, s, load_task<true>(p, i), g);
    }
    level_sync(one_warp);
  }
}

// One Adam step on entry i; returns the new logit.
__device__ __forceinline__ float adam(float* z, float* mu, float* nu, int64_t i, float gz,
                                      float bc1, float bc2) {
  const float m1 = add(mul(B1, mu[i]), mul(ONE_B1, gz));
  const float v1 = add(mul(B2, nu[i]), mul(mul(ONE_B2, gz), gz));
  mu[i] = m1;
  nu[i] = v1;
  const float zn = sub(z[i], dvd(mul(LR, dvd(m1, bc1)), add(sqrtf(dvd(v1, bc2)), EPS)));
  z[i] = zn;
  return zn;
}

__device__ __forceinline__ float sigmoid(float z) {
  return dvd(1.0f, add(1.0f, expf(-z)));
}

// softmax of a row of c logits into out
__device__ __forceinline__ void softmax_row(const float* z, float* out, int c) {
  float mx = z[0];
  for (int i = 1; i < c; ++i) mx = max_nan(mx, z[i]);
  float sum = 0.0f;
  for (int i = 0; i < c; ++i) {
    out[i] = expf(sub(z[i], mx));
    sum = add(sum, out[i]);
  }
  for (int i = 0; i < c; ++i) out[i] = dvd(out[i], sum);
}

// The chain rule from each task's g_f (and, with use_comm, the type
// marginals' cotangent, gathered from the stored gp in hlp_fo.cu's order:
// the successors' edges, then the task's own slots) into its logits, its
// Adam step and its new x: every task at once, off the level chain.
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
      const float xn = sigmoid(adam(p.z, p.mu, p.nu, j, mul(gx, mul(x, sub(1.0f, x))), bc1, bc2));
      s.x[j] = xn;
      s.f[j] = add(mul(pcj, xn), mul(pgj, sub(1.0f, xn)));   // the next walk's task time
      continue;
    }
    float gX[MAX_Q];
#pragma unroll
    for (int q = 0; q < MAX_Q; ++q) gX[q] = 0.0f;
    if (COMM) {
      const int e1 = __ldg(p.succ_ptr + j + 1);
      for (int e = __ldg(p.succ_ptr + j); e < e1; ++e) {
        const int sj = __ldg(p.succ_task + e);
        const int64_t slot = static_cast<int64_t>(sj) * p.P + __ldg(p.succ_slot + e);
        const float gd = -mul(s.w[e], __ldg(p.pred_comm + slot));
        for (int q = 0; q < p.Q; ++q)
          gX[q] = add(gX[q], mul(gd, s.X[static_cast<int64_t>(sj) * p.Q + q]));
      }
      const int* row = p.pred + static_cast<int64_t>(j) * p.P;
      for (int kk = 0; kk < p.P; ++kk) {
        const int q = __ldg(row + kk);
        if (q < 0) break;
        const int64_t slot = static_cast<int64_t>(j) * p.P + kk;
        const float gd = -mul(s.w[__ldg(p.pred_edge + slot)], __ldg(p.pred_comm + slot));
        for (int t = 0; t < p.Q; ++t)
          gX[t] = add(gX[t], mul(gd, s.X[static_cast<int64_t>(q) * p.Q + t]));
      }
    }
    const int64_t base = static_cast<int64_t>(j) * p.C;
    float gx[MAX_C], zn[MAX_C];
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      if (c < p.C) {
        float gc = add(mul(gf, __ldg(p.p_choice + base + c)),
                       mul(g.gpc[c], __ldg(p.area + base + c)));
        if (COMM)
          for (int q = 0; q < p.Q; ++q) gc = add(gc, mul(gX[q], s.tm[q * p.C + c]));
        gx[c] = gc;
        dot = add(dot, mul(s.x[base + c], gc));
      }
    }
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < p.C)
        zn[c] = adam(p.z, p.mu, p.nu, base + c, mul(s.x[base + c], sub(gx[c], dot)), bc1,
                     bc2);
    softmax_row(zn, s.x + base, p.C);
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
      softmax_row(zr, s.x + base, p.C);
      s.f[j] = task_time<true>(p, s, j);
    }
  }
  block_reduce(v, 1, 1u, s.red, one_warp);   // also publishes the staging above
  const float scale = v[0];
  if (COMM) comm_delays(p, s, one_warp);
  const int nl = CHOICE ? 1 + p.C : 3;   // the hard max and the load sums
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
    fused_forward<COMM>(p, s, tau, soft, one_warp);
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
      } else {
        const float* ar = p.area + static_cast<int64_t>(j) * p.C;
        const float* xr = s.x + static_cast<int64_t>(j) * p.C;
#pragma unroll
        for (int c = 0; c < MAX_C; ++c)
          if (c < p.C) v[1 + c] = add(v[1 + c], mul(__ldg(ar + c), xr[c]));
      }
      if (soft) v[nl] = max_nan(v[nl], s.f[j]);
    }
    block_reduce(v, soft ? nl + 1 : nl, 1u | (1u << nl), s.red, one_warp);
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
    const Grad g = loss_grad<CHOICE>(p, s, tau, v[nl], v, one_warp);
    const long long t2 = clock64();
    reverse_walk(p, s, g, one_warp);
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
// `out[0]` keeps the result.  hlp_fo.cu's probe, the same code.
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
            nullptr, nullptr, nullptr, nullptr, nullptr, sched, z0, z, mu, nu,
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
                                      float* mu, float* nu, float* best_x, float* best_val,
                                      float* scratch, long long* cycles, int n, int P, int E,
                                      int levels, int C, int Q, int iters, int use_comm,
                                      int threads, cudaStream_t stream) {
  Problem p{level_ptr, level_task, pred, succ_ptr, succ_task, succ_slot, pred_edge,
            nullptr, nullptr, p_choice, area, type_mask, inv_counts, pred_comm, sched, z0,
            z, mu, nu, best_x, best_val, scratch, cycles, n, P, E, levels, C, Q, iters, 1, 1};
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
