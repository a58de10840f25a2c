// The first-order HLP solve: Adam on logits against the tau-annealed soft
// longest path, every step of one problem in one block.  CUDA C++ for
// sm_90a; the card path of kernels/hlp_fo/hlp_fo.py.
//
// Replaces the JAX package's two jitted solvers
//   src/repro/core/hlp_jax.py::_solve (:122), the hybrid solve: x = sigmoid(z)
//     over n tasks, Q = 2, no edge costs;
//   src/repro/core/hlp_jax.py::_solve_choice (:172), the choice-grid solve:
//     x = softmax(z) over an (n, C) grid of (type, width) choices, with
//     use_comm adding each pred edge's expected crossing delay
//     pred_comm * (1 - X[pred] . X), X = x @ type_mask^T.
// Each runs `iters` steps of: the gradient of the loss (a smooth max of the
// soft critical path and the pool loads) by reverse-mode through the soft
// longest path, an Adam step, and the exact longest path of the new x to
// keep the iterate of least lambda.  hlp_fo/ref.py::hybrid_solve_ref and
// ::choice_solve_ref are the plain versions; their gradient comes from
// autograd, this kernel's from the hand-written reverse scan below.
//
// Arithmetic: float32 throughout, as the reference runs with x64 off.  The
// forward's operations are the reference's, in its order, each rounded
// once (__fadd_rn / __fmul_rn / __fdiv_rn: nothing contracts into an FMA;
// no fast math, so expf / logf / sqrtf are the full-precision ones).  The
// anneal factor of tau and Adam's bias corrections come from the wrapper
// as a table, computed by the plain version's own float32 operations.
// The backward uses the softmax weights alone: the gradient the reference
// sends through each max (m) cancels in exact arithmetic and is left out,
// so the gradient agrees with autograd's to rounding, not to the bit.
//
// What bounds it on the H100: a chain of dependent steps, not bytes.  Each
// Adam step walks the levels three times (soft forward, reverse, exact
// forward), a barrier after each level, and runs three block reductions;
// 300 steps over potri nb=20's 60 levels are 54,000 barrier-separated
// level steps, each a few dependent shared-memory reads and one or two
// expf / logf.  Its inputs are a few hundred KB, read from L2 after the
// first step.  chip_smoke.py measures one level step with
// hlp_fo_chain_probe and compares the solve with that floor.
//
// Design:
//   * One problem a block, threads_for(widest level) threads; the tasks of
//     a level are spread over the threads.
//   * Shared memory: the current x (n or n C; a task's row is written only
//     by the thread that owns it in the reverse pass, after its last read),
//     the finish times f, each task's max m over its pred slots and its sum
//     S of exp((pf - m) / tau) (the reverse pass overwrites S with the
//     task's coefficient c = g_soft tau / (S + 1e-30)), with use_comm the
//     type marginals X (n Q), the level offsets and the reductions' scratch.
//     A problem whose layout passes 227 KB raises in the wrapper.
//   * Reverse pass without atomics: level by level from the last, a task
//     gathers its adjoint from its successors (the successor CSR carries
//     each edge's slot in the successor's pred row), recomputing each
//     edge's softmax weight exp((f_j + delay - m_s) / tau) from the stored
//     m_s and c_s, then sets its own c, runs the chain rule through its
//     time, the loads and x = sigmoid(z) (or the softmax), and its Adam
//     step on z, mu and nu in global memory, and writes its new x.
//   * The pool loads of x are reduced once, in the exact pass, and reused
//     by the next step's loss: both read the same x.
//   * Masked pred slots (-1) are skipped, never gathered.
//
// C interface (loaded with ctypes): hlp_fo_hybrid_f32 and hlp_fo_choice_f32
// return the cudaError_t of the shared-memory attribute call or of the
// launch as an int, 0 on success, and, given a `cycles` array, thread 0's
// clock cycles in each phase of the step; hlp_fo_smem_bytes the bytes a
// launch takes; hlp_fo_chain_probe times the chain floor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float TINY = 1e-30f;
constexpr int MAX_C = 16;          // choices a task may have
constexpr int MAX_Q = 8;           // resource types
constexpr int MAX_V = MAX_C + 1;   // values one block reduction carries
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int SMEM_LIMIT = 232448; // 227 KB, the most a block may take

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
  long long* cycles;      // (4) out, or null: thread 0's clock cycles in
                          // the soft forward, the loss, the reverse pass
                          // and the exact pass, summed over the steps
  long long* task_cycles; // (n, 3) out, or null: each task's clock cycles
                          // in the reverse pass's successor gather, its
                          // chain rule and new x, and its Adam step's
                          // loads and stores, summed over the steps
  int n, P, levels, C, Q, iters, m, k;
};

// Dynamic shared memory in floats: x, f, m, S/c, X (use_comm), type_mask,
// inv_counts, the level offsets (as ints) and the reductions' scratch.
__host__ __device__ inline int64_t smem_floats(int n, int levels, int C, int Q, bool comm) {
  const int64_t tasks = static_cast<int64_t>(n);
  return tasks * C + 3 * tasks + (comm ? tasks * Q : 0) + Q * C + Q + (levels + 1) +
         MAX_WARPS * MAX_V;
}

struct Smem {
  float* x;
  float* f;
  float* mv;
  float* sc;
  float* X;
  float* tm;
  float* inv;
  int* lp;
  float* red;
};

__device__ Smem carve(float* base, const Problem& p, bool comm) {
  Smem s;
  float* cur = base;
  s.x = cur;   cur += static_cast<int64_t>(p.n) * p.C;
  s.f = cur;   cur += p.n;
  s.mv = cur;  cur += p.n;
  s.sc = cur;  cur += p.n;
  s.X = cur;   cur += comm ? static_cast<int64_t>(p.n) * p.Q : 0;
  s.tm = cur;  cur += p.Q * p.C;
  s.inv = cur; cur += p.Q;
  s.lp = reinterpret_cast<int*>(cur); cur += p.levels + 1;
  s.red = cur;
  return s;
}

// Every thread gets the block's max of v[0] and sums of v[1..nv).  The
// butterfly gives every lane the same value (each add is commutative), and
// every thread reduces the warps' partials in the same order.
__device__ void block_reduce(float (&v)[MAX_V], int nv, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < MAX_V; ++i) {
    if (i < nv) {
      float x = v[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, x, o);
        x = i == 0 ? max_nan(x, y) : add(x, y);
      }
      v[i] = x;
    }
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
      float x = scratch[i];
      for (int w = 1; w < nw; ++w) x = i == 0 ? max_nan(x, scratch[w * MAX_V + i])
                                              : add(x, scratch[w * MAX_V + i]);
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

template <bool COMM>
__device__ __forceinline__ float slot_finish(const Problem& p, const Smem& s, int j, int kk,
                                             int q) {
  float pf = s.f[q];
  if (COMM) pf = add(pf, edge_delay(p, s, j, kk, q));
  return pf;
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

// The soft forward: f, m and S of every task, level by level.
template <bool CHOICE, bool COMM>
__device__ void soft_forward(const Problem& p, const Smem& s, float tau) {
  for (int l = 0; l < p.levels; ++l) {
    const int lo = s.lp[l], hi = s.lp[l + 1];
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const int j = __ldg(p.level_task + i);
      const int* row = p.pred + static_cast<int64_t>(j) * p.P;
      const float t = task_time<CHOICE>(p, s, j);
      float m = NEG, sum = 0.0f, start = 0.0f;
      if (__ldg(row) >= 0) {
        for (int kk = 0; kk < p.P; ++kk) {
          const int q = __ldg(row + kk);
          if (q < 0) break;
          m = max_nan(m, slot_finish<COMM>(p, s, j, kk, q));
        }
        for (int kk = 0; kk < p.P; ++kk) {
          const int q = __ldg(row + kk);
          if (q < 0) break;
          sum = add(sum, expf(dvd(sub(slot_finish<COMM>(p, s, j, kk, q), m), tau)));
        }
        const float soft = add(m, mul(tau, logf(add(sum, TINY))));
        start = max_nan(soft, 0.0f);
      }
      s.f[j] = add(start, t);
      s.mv[j] = m;
      s.sc[j] = sum;
    }
    __syncthreads();
  }
}

// The exact forward on the current x: f of every task, level by level.
template <bool CHOICE, bool COMM>
__device__ void hard_forward(const Problem& p, const Smem& s) {
  for (int l = 0; l < p.levels; ++l) {
    const int lo = s.lp[l], hi = s.lp[l + 1];
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const int j = __ldg(p.level_task + i);
      const int* row = p.pred + static_cast<int64_t>(j) * p.P;
      float start = 0.0f;
      for (int kk = 0; kk < p.P; ++kk) {
        const int q = __ldg(row + kk);
        if (q < 0) break;
        start = max_nan(start, slot_finish<COMM>(p, s, j, kk, q));
      }
      s.f[j] = add(start, task_time<CHOICE>(p, s, j));
    }
    __syncthreads();
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

// Exact lambda of the current x: the hard forward, then one reduction of
// the max finish and the load sums (pc.x and pg.(1 - x), or the per-choice
// areas), which it also leaves in `sums` for the next step's loss.
template <bool CHOICE, bool COMM>
__device__ float exact_lambda(const Problem& p, const Smem& s, float (&sums)[MAX_V]) {
  if (COMM) {
    marginals(p, s);
    __syncthreads();
  }
  hard_forward<CHOICE, COMM>(p, s);
  float v[MAX_V];
#pragma unroll
  for (int i = 0; i < MAX_V; ++i) v[i] = 0.0f;
  v[0] = NEG;
  for (int j = threadIdx.x; j < p.n; j += blockDim.x) {
    v[0] = max_nan(v[0], s.f[j]);
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
  }
  block_reduce(v, CHOICE ? 1 + p.C : 3, s.red);
#pragma unroll
  for (int i = 0; i < MAX_V; ++i) sums[i] = v[i];
  float lam = v[0];
  if (!CHOICE) {
    lam = max_nan(lam, max_nan(dvd(v[1], static_cast<float>(p.m)),
                               dvd(v[2], static_cast<float>(p.k))));
  } else {
    float mx = pool_load(p, s, v, 0);
    for (int q = 1; q < p.Q; ++q) mx = max_nan(mx, pool_load(p, s, v, q));
    lam = max_nan(lam, mx);
  }
  return lam;
}

// The loss's cotangents at one step, the same on every thread.
struct Grad {
  float tau, M, cfin;      // tau, the max finish, the final soft max's coefficient
  float dc, dg;            // hybrid: d loss / d (pc.x), d loss / d (pg.(1 - x))
  float gpc[MAX_C];        // choice: d loss / d (per-choice area sum)
};

// The loss's cotangents from the soft forward's finish times and the pool
// loads: two reductions (the max finish, then its soft max's sum).
template <bool CHOICE>
__device__ Grad loss_grad(const Problem& p, const Smem& s, float tau,
                          const float (&sums)[MAX_V]) {
  float v[MAX_V];
#pragma unroll
  for (int i = 0; i < MAX_V; ++i) v[i] = 0.0f;
  v[0] = NEG;
  for (int j = threadIdx.x; j < p.n; j += blockDim.x) v[0] = max_nan(v[0], s.f[j]);
  block_reduce(v, 1, s.red);
  const float M = v[0];
  v[1] = 0.0f;
  for (int j = threadIdx.x; j < p.n; j += blockDim.x)
    v[1] = add(v[1], expf(dvd(sub(s.f[j], M), tau)));
  block_reduce(v, 2, s.red);
  const float sum_f = v[1];
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
  g.M = M;
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

// One Adam step on entry i; returns the new logit.
__device__ __forceinline__ float adam(const Problem& p, int64_t i, float gz, float bc1,
                                      float bc2) {
  const float mu = add(mul(B1, p.mu[i]), mul(ONE_B1, gz));
  const float nu = add(mul(B2, p.nu[i]), mul(mul(ONE_B2, gz), gz));
  p.mu[i] = mu;
  p.nu[i] = nu;
  const float z = sub(p.z[i], dvd(mul(LR, dvd(mu, bc1)), add(sqrtf(dvd(nu, bc2)), EPS)));
  p.z[i] = z;
  return z;
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

// The reverse pass, level by level from the last: each task's adjoint from
// its successors' weights, its own coefficient c, the chain rule into its
// logits, its Adam step and its new x.
template <bool CHOICE, bool COMM>
__device__ void reverse(const Problem& p, const Smem& s, const Grad& g, float bc1, float bc2) {
  const float tau = g.tau;
  const bool timed = p.task_cycles != nullptr;
  for (int l = p.levels - 1; l >= 0; --l) {
    const int lo = s.lp[l], hi = s.lp[l + 1];
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const int j = __ldg(p.level_task + i);
      long long t_start = timed ? clock64() : 0, t_adam = 0;
      const float fj = s.f[j];
      float gf = dvd(mul(g.cfin, expf(dvd(sub(fj, g.M), tau))), tau);
      float gX[MAX_Q];
#pragma unroll
      for (int q = 0; q < MAX_Q; ++q) gX[q] = 0.0f;
      const int e1 = __ldg(p.succ_ptr + j + 1);
      for (int e = __ldg(p.succ_ptr + j); e < e1; ++e) {
        const int sj = __ldg(p.succ_task + e);
        const int kk = __ldg(p.succ_slot + e);
        const float pf = slot_finish<COMM>(p, s, sj, kk, j);
        const float gp = dvd(mul(s.sc[sj], expf(dvd(sub(pf, s.mv[sj]), tau))), tau);
        gf = add(gf, gp);
        if (COMM) {
          const float gd = -mul(gp, __ldg(p.pred_comm + static_cast<int64_t>(sj) * p.P + kk));
          for (int q = 0; q < p.Q; ++q)
            gX[q] = add(gX[q], mul(gd, s.X[static_cast<int64_t>(sj) * p.Q + q]));
        }
      }
      const long long t_gather = timed ? clock64() : 0;
      const int* row = p.pred + static_cast<int64_t>(j) * p.P;
      float cj = 0.0f;
      if (__ldg(row) >= 0) {
        const float S = s.sc[j];
        const float soft = add(s.mv[j], mul(tau, logf(add(S, TINY))));
        // jnp.maximum(soft, 0) sends half of the cotangent each way at a tie
        const float gs = soft > 0.0f ? gf : (soft == 0.0f ? mul(0.5f, gf) : 0.0f);
        cj = dvd(mul(gs, tau), add(S, TINY));
        if (COMM) {
          for (int kk = 0; kk < p.P; ++kk) {
            const int q = __ldg(row + kk);
            if (q < 0) break;
            const float pf = slot_finish<COMM>(p, s, j, kk, q);
            const float gp = dvd(mul(cj, expf(dvd(sub(pf, s.mv[j]), tau))), tau);
            const float gd = -mul(gp, __ldg(p.pred_comm + static_cast<int64_t>(j) * p.P + kk));
            for (int t = 0; t < p.Q; ++t)
              gX[t] = add(gX[t], mul(gd, s.X[static_cast<int64_t>(q) * p.Q + t]));
          }
        }
      }
      s.sc[j] = cj;
      if (!CHOICE) {
        const float x = s.x[j];
        const float pcj = __ldg(p.pc + j), pgj = __ldg(p.pg + j);
        float gx = sub(mul(gf, pcj), mul(gf, pgj));
        gx = add(gx, mul(g.dc, pcj));
        gx = sub(gx, mul(g.dg, pgj));
        const float gz = mul(gx, mul(x, sub(1.0f, x)));
        const long long ta = timed ? clock64() : 0;
        const float zn = adam(p, j, gz, bc1, bc2);
        if (timed) t_adam += clock64() - ta;
        s.x[j] = sigmoid(zn);
      } else {
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
          if (c < p.C) {
            const float gz = mul(s.x[base + c], sub(gx[c], dot));
            const long long ta = timed ? clock64() : 0;
            zn[c] = adam(p, base + c, gz, bc1, bc2);
            if (timed) t_adam += clock64() - ta;
          }
        softmax_row(zn, s.x + base, p.C);
      }
      if (timed) {
        long long* tc = p.task_cycles + 3 * static_cast<int64_t>(j);
        const long long t_end = clock64();
        tc[0] += t_gather - t_start;
        tc[1] += t_end - t_gather - t_adam;
        tc[2] += t_adam;
      }
    }
    __syncthreads();
  }
}

template <bool CHOICE, bool COMM>
__global__ void __launch_bounds__(MAX_THREADS)
hlp_fo_kernel(Problem p) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, p, COMM);
  const int tid = threadIdx.x, nt = blockDim.x;
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
    }
  }
  block_reduce(v, 1, s.red);   // its barriers also publish the staging above
  const float scale = v[0];
  float sums[MAX_V];
  float best = exact_lambda<CHOICE, COMM>(p, s, sums);
  for (int64_t i = tid; i < entries; i += nt) p.best_x[i] = s.x[i];
  long long phase[4] = {0, 0, 0, 0};
  for (int it = 0; it < p.iters; ++it) {
    const float* row = p.sched + 3 * static_cast<int64_t>(it);
    const float tau = mul(scale, __ldg(row));
    const long long t0 = clock64();
    soft_forward<CHOICE, COMM>(p, s, tau);
    const long long t1 = clock64();
    const Grad g = loss_grad<CHOICE>(p, s, tau, sums);
    const long long t2 = clock64();
    reverse<CHOICE, COMM>(p, s, g, __ldg(row + 1), __ldg(row + 2));
    const long long t3 = clock64();
    const float lam = exact_lambda<CHOICE, COMM>(p, s, sums);
    phase[0] += t1 - t0;
    phase[1] += t2 - t1;
    phase[2] += t3 - t2;
    phase[3] += clock64() - t3;
    if (lam < best) {           // the same on every thread
      best = lam;
      for (int64_t i = tid; i < entries; i += nt) p.best_x[i] = s.x[i];
    }
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

unsigned long long g_configured[3] = {0, 0, 0};   // per kernel: devices set up

template <bool CHOICE, bool COMM>
int launch(const Problem& p, int threads, cudaStream_t stream, int slot) {
  if (p.n <= 0 || p.P <= 0 || p.levels <= 0 || p.iters < 0 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || p.C < 1 || p.C > MAX_C ||
      p.Q < 0 || p.Q > MAX_Q || (CHOICE && p.Q < 1))
    return cudaErrorInvalidValue;
  const int64_t bytes = 4 * smem_floats(p.n, p.levels, p.C, p.Q, COMM);
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  const cudaError_t err =
      allow_smem(hlp_fo_kernel<CHOICE, COMM>, SMEM_LIMIT, g_configured[slot]);
  if (err != cudaSuccess) return static_cast<int>(err);
  hlp_fo_kernel<CHOICE, COMM><<<1, threads, static_cast<size_t>(bytes), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long hlp_fo_smem_bytes(int n, int levels, int c, int q, int comm) {
  return 4 * smem_floats(n, levels, c, q, comm != 0);
}

extern "C" int hlp_fo_hybrid_f32(const int* level_ptr, const int* level_task, const int* pred,
                                 const int* succ_ptr, const int* succ_task,
                                 const int* succ_slot, const float* pc, const float* pg,
                                 const float* sched, const float* z0, float* z, float* mu,
                                 float* nu, float* best_x, float* best_val,
                                 long long* cycles, long long* task_cycles, int n, int P,
                                 int levels, int iters, int m, int k, int threads,
                                 cudaStream_t stream) {
  if (m <= 0 || k <= 0) return cudaErrorInvalidValue;
  Problem p{level_ptr, level_task, pred, succ_ptr, succ_task, succ_slot, pc, pg,
            nullptr, nullptr, nullptr, nullptr, nullptr, sched, z0, z, mu, nu,
            best_x, best_val, cycles, task_cycles, n, P, levels, 1, 0, iters, m, k};
  return launch<false, false>(p, threads, stream, 0);
}

extern "C" int hlp_fo_choice_f32(const int* level_ptr, const int* level_task, const int* pred,
                                 const int* succ_ptr, const int* succ_task,
                                 const int* succ_slot, const float* p_choice,
                                 const float* area, const float* type_mask,
                                 const float* inv_counts, const float* pred_comm,
                                 const float* sched, const float* z0, float* z, float* mu,
                                 float* nu, float* best_x, float* best_val,
                                 long long* cycles, long long* task_cycles, int n, int P,
                                 int levels, int C, int Q, int iters, int use_comm,
                                 int threads, cudaStream_t stream) {
  Problem p{level_ptr, level_task, pred, succ_ptr, succ_task, succ_slot, nullptr, nullptr,
            p_choice, area, type_mask, inv_counts, pred_comm, sched, z0, z, mu, nu,
            best_x, best_val, cycles, task_cycles, n, P, levels, C, Q, iters, 1, 1};
  return use_comm ? launch<true, true>(p, threads, stream, 2)
                  : launch<true, false>(p, threads, stream, 1);
}

extern "C" int hlp_fo_chain_probe(float* out, int steps, int threads, cudaStream_t stream) {
  if (steps <= 0 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0)
    return cudaErrorInvalidValue;
  chain_probe_kernel<<<1, threads, 0, stream>>>(out, steps, 0.125f);
  return static_cast<int>(cudaGetLastError());
}
