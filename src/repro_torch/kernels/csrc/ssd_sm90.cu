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
// Numbers.  Every product of both directions runs on the tensor cores with
// fp32 accumulators and is rounded once to T where the plain version's
// einsum rounds; no operand is rounded below what the plain version
// carries:
//   * a bf16 operand (x, dy, B, C, the saved states, r(L), U = r(sdecay x))
//     goes in as it is: its products with another bf16 value are exact;
//   * a product of two bf16 values (dy * r(exp(cums))) has 16 significant
//     bits and splits exactly into a bf16 hi and a bf16 lo: two products;
//   * an fp32 operand (g, the state cotangent; dcb, the scores' cotangent)
//     splits as hi = tf32_rna(v), lo = tf32_rna(v - hi) (3xTF32): hi hi' +
//     hi lo' + lo hi', lo lo' (about 2^-22 of the product) dropped; a bf16
//     partner is exact in TF32, so its lo is zero and its product is
//     skipped;
//   * with T fp32 every operand is fp32 and takes 3xTF32.
// In bf16 each of the forward's products is of two bf16 values (the
// scores C B^T, r(L) x, C S^T, U^T B): one MMA, no split.  The forward's
// elementwise steps round where scan_ref rounds, with __fmul_rn /
// __fadd_rn (no contraction): the scores r(cb); r(L) = r((cb * exp(cums_i
// - cums_j)) * dt_j) masked to j <= i before the exp (masked_score, the
// backward's definition too); y = r(r(intra) + r(r(C . S) *
// r(exp(cums_i)))); sdecay r(exp(seg - cums_j) * dt_j) and U = r(sdecay *
// x); the state update r(r(S * r(exp(seg))) + r(contrib)); the cumsum of
// dt * A in order.  The backward carries fp32 (scan_grad_ref's
// definition): the forward's values as the forward rounded them, each
// rounding's cotangent passed straight through, each cotangent rounded once
// to its input's dtype.  step is elementwise and equals step_ref bit for
// bit in the state and the conv window; its readout sums over n in a
// fixed tree (each lane its chunks in order, then a butterfly).
// So scan and scan_grad agree with scan_ref and scan_grad_ref to the order
// of fp32 sums (the order inside an MMA's k step is the hardware's).  Every
// sum runs in a fixed order: a product's k steps in order, where A comes
// from registers each step's two halves of k into two partials that are
// then added; the row and column sums of a tile by shuffles in a fixed tree
// and then over the warps in order; dcb over a group of heads in head
// order, the groups in group order; dB and dC over the heads in head order
// inside one accumulator; dA over (batch, chunk) in that order; no float
// atomics, so two runs give the same bits.
//
// Design.  Chunk-parallel, as SSD's chunked form allows: each chunk's
// outputs within the chunk do not depend on the state.
//   scan, two launches:
//   (1) state, a block a (batch, head, 64 x 64 tile of the (hd, ns) state):
//   the one sequential walk over the chunks, the cumsums of dt * A taken
//   CU_WIN chunks at a time into shared memory (a thread a chunk, in
//   order; the blocks of tile 0 also write them out for the output
//   kernel): at chunk c the contribution U^T B (U computed from x as A in
//   registers), the entering state written out once from the registers
//   that carry it across the chunks, and the state updated there; the
//   final state after the last chunk (mamba2-130m's training shape: 384
//   blocks, jamba's 256, mamba2-130m's serving 192);
//   (2) out, a block a (pair of 64-row tiles I: the first and the last,
//   the second and the one before, an even load as tile I has I + 1
//   column tiles on or below the diagonal; chunk, batch, group of heads,
//   grouped as the backward's heads kernel groups them): the scores'
//   strip r(C_I . B_J^T), J <= I, once for the group in shared memory (at
//   most 64 x 256 in T), then for each head the intra product r(L_I.) x,
//   its A built in registers from the strip, the head's cums and dt, its
//   k stopping at the tile's last row, and C_I S^T, and the epilogue y
//   from the two accumulators (256 blocks at mamba2-130m's training shape
//   and at jamba's, 128 at mamba2-130m's serving shape).  No scores and no
//   contributions reach device memory.
//   scan_grad, four launches:
//   (1) carry, a block a (batch, head): the chunks' cumsums, then the one
//   reverse pass over the chunks; at chunk c the state cotangent its
//   outputs give, gs = (dy r(exp(cums)))^T C, then g (the cotangent of the
//   state after chunk c) written out, dG = sum g * S_c in a fixed tree, and
//   g <- g r(exp(seg)) + gs, g held in shared memory;
//   (2) heads, a block a (pair of 64-column tiles J: the first and the
//   last, the second and the one before, an even load; chunk, batch, group
//   of heads): the scores' strip r(C_I . B_J) (I >= J) once for the group,
//   in shared memory; each tile dL_IJ = dy_I . x_J^T once a head, its
//   epilogue in registers giving dcb (summed over the group's heads in
//   registers, written once a tile), the rows' and the columns' exponent
//   sums and ddt's score part; then each head's dx for the rows J, sdecay
//   (B_J . g^T) + sum_I r(L_IJ)^T dy_I in one accumulator, the row sum d
//   sdecay = sum_p x dU, and d exp(cums) = sum_p dy r(C . S^T);
//   (3) finish, a block a (batch, chunk, head): the groups' dcb folded into
//   the first group's (a share of the chunk a block, in group order), the
//   exponents' cotangents, the reverse cumsum in order, ddt and dA's
//   partial;
//   (4) sums, a block a (64 rows T, 64 columns of ns, chunk, batch): dB_T =
//   sum_h U_T g_h + dcb_{.,T}^T C and dC_T = sum_h dQ_T S_h + dcb_{T,.} B,
//   each one accumulator whose k runs over (head, p), rounded once to T;
//   dA's partials summed in order.
//   B and C are shared by the heads, so dB and dC sum over them: the sums
//   stay in the accumulators of (4) and the registers of (2), and of the
//   per-head values only the scores' cotangent of each group of heads
//   reaches device memory (groups of at most G_MAX heads, as many as give
//   (2) about GROUP_BLOCKS blocks but no more than GROUPS_AIM groups: two
//   groups of 12 at mamba2-130m's training shape, 2 x 16.8 MB).
// The products are wgmma, 64 x 64 output tiles, the block's two
// warpgroups sharing a tile:
//   * an operand computed on its load (the decay-weighted scores r(L), dy
//     r(exp(cums)), U = r(sdecay x)) goes in as A from registers, each
//     thread computing its fragment from shared memory; the warpgroups
//     split each step's k, each a 64 x 64 partial (m64n64), so every value
//     is computed once a block, and the partials meet at the end;
//   * with T = bf16 and hd, lc multiples of 32 and ns of 8 (mamba2-130m's
//     and jamba's full configs), the operands that are bf16 as they stand
//     in device memory come by TMA straight into shared memory in wgmma's
//     layout, one thread arming a stage's mbarrier (Tgemm): the
//     backward's in boxes of 8 columns (A and B of the scores' strip, of
//     dL = dy x^T and of d exp(cums); B of the register products, read
//     transposed), k in steps of 32; the forward's (x, B, C, the states)
//     in boxes of 64 columns with 128-byte swizzle, k in steps of 64, and
//     y leaves through a swizzled tile by TMA store;
//   * the fp32 operands (g, dcb) are split by the threads into 3xTF32
//     planes, K-major, as is every operand that does not take TMA (T =
//     fp32, other shapes): each thread copies runs of eight with cp.async
//     into its own slots of a ring and writes them into the planes (Gemm),
//     k in steps of 32; the operands with both split are the warpgroups' n
//     halves (m64n32).
// A shape that fits no 64-row tile (lc 8, 13, 24; hd 12, 16; ns 16, 20)
// runs the same products on zero-padded tiles.  The next product's first
// steps are issued before this one's epilogue.
//
// What bounds it on the H100: at mamba2-130m's training shape (8 x 2048,
// nh 24, hd 64, ns 128, lc 256) the scan moves 138.9 MB and does 19.89
// GFLOP (41 us at the byte rate, 20 us at the bf16 tensor-core peak); the
// backward moves 196.1 MB and does 39.78 GFLOP (59 us by bytes, 40 us at
// the bf16 peak) and as many again for the hi / lo and 3xTF32 splits, with
// 98 MB of scratch besides (the per-chunk state cotangents, 50 MB, written
// once and read twice; the two groups' dcb, 34 MB).  What holds both back
// is the instruction stream around the products: the register fragments
// (the forward's r(L) an expf, a mask and three roundings a value) and the
// staged planes are computed by every thread a step, a step waits for its
// products, and a step's barrier waits for the slowest warp; the tensor
// cores are busy a few percent of the time.
//   step moves the state (read and written once) and is bound by bytes:
// 3.27 MB at mamba2-130m's decode shape (4 x 24 heads of 64 x 128), 0.98
// us at the byte rate, under its launch floor (~1.5 us).  A block of four
// warps takes a group of rows p of one (batch, head); a row's ns values
// split into 16-byte vectors over a power-of-two group of its warp's lanes
// (16 lanes at ns 128 in bf16, 2 at jamba's ns 16), so every thread moves
// its state with one 16-byte load and store, and the grid spreads the
// state over the card (768 blocks at mamba2-130m, not one a (batch,
// head)).  The readout is a lane's chunks in order, then a butterfly of
// shuffles over the row's lanes: no shared memory, no serial chain of ns
// adds.  The conv window's shift takes its own blocks after the state's.
//
// Launch: each entry launches its kernels on the caller's stream and
// returns the first CUDA error (0 on success); scratch comes from the
// caller's workspace (ssd_workspace_floats).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "sm90_common.cuh"

namespace {

constexpr int TILE = 64;        // rows and columns of a block's output tile
constexpr int THREADS = 256;    // two warpgroups
constexpr int MAX_CHUNK = 256;
constexpr int CU_WIN = 8;       // chunks whose cumsums the state kernel holds
constexpr int MAX_STATE = 8192;              // hd * ns
constexpr int STEP_THREADS = 128;             // step: four warps a block
constexpr int STEP_WARPS = STEP_THREADS / 32;
constexpr int CONV_UNROLL = 4;               // step's conv shift: loads in flight

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

// ------------------------------------------------- tensor-core products
// Tensor-core products: wgmma.  A block's two warpgroups share a 64 x 64
// output tile, warpgroup wg its columns [32 wg, 32 wg + 32) (m64n32, A and
// B from shared memory); each thread holds 16 fp32 accumulators, element q
// at row 16 w + g + 8 ((q & 3) >> 1) and column 32 wg + 8 (q >> 2) + 2 t +
// (q & 1) (w the warp in its warpgroup, g = lane / 4, t = lane % 4:
// wgmma's accumulator layout, the same for bf16 k16 and tf32 k8).
// The kinds of a plane: bf16, tf32, and fp32 kept whole (FP: an operand's
// values as loaded, before the threads compute a register operand from
// them; TF32's layout).
enum Kind { BF = 0, TF = 1, FP = 2 };

constexpr int KS = 32;                     // the k depth of a step
// A plane: one operand's 64 rows x KS, K-major in wgmma's layout without
// swizzle: core matrices of 8 rows x 16 bytes, the 8 row groups of a k
// chunk 128 bytes apart (SBO) and the k chunks LBO apart.  LBO is 64 x 16
// bytes plus 16, so the k chunks fall in different banks and the threads'
// stores along m (put_col) do not collide.
constexpr int SBO = 128;
constexpr int LBO = TILE * 16 + 16;
constexpr int PLANE_BF = (KS / 8) * LBO;   // 4 k chunks of 8 bf16
constexpr int PLANE_TF = (KS / 4) * LBO;   // 8 k chunks of 4 fp32
// The ring of a kernel: S steps of STAGE bytes (a step's runs of A, then
// B's), and NB buffers of planes of BUF bytes (A's planes, then B's); with
// two or more, a step's planes are staged while the step before runs on
// the tensor cores.  The TMA products take the planes' region as stages.
template <int S_, int STAGE_, int BUF_, int NB_>
struct Ring {
  static constexpr int S = S_, STAGE = STAGE_, BUF = BUF_, NB = NB_;
};
// Stage bytes: runs of T and fp32, or of T and T.
template <typename T>
struct Stage2 {
  static constexpr int MIXED = THREADS * 8 * (sizeof(T) + 4);
  static constexpr int SAME = THREADS * 8 * 2 * sizeof(T);
};
constexpr int HEADS_STAGES = 2;            // the rings' depths
constexpr int SUMS_STAGES = 2;
constexpr int CARRY_STAGES = 3;
// The plane buffers: one keeps two heads blocks an SM beside the scores'
// strip (with two, one block an SM would be left to hide its own
// latencies); three let a register product compute a step's fragments
// while the step before runs, at two blocks an SM.
constexpr int HEADS_NB = 1;
constexpr int SUMS_NB = 3;
constexpr int CARRY_NB = 3;
constexpr int SUMS_HEADS = 32;             // heads a table of the sums kernel
constexpr int G_MAX = 16;                  // heads a group of the heads kernel
constexpr int GROUP_BLOCKS = 256;          // the heads kernel's blocks aimed at
constexpr int GROUPS_AIM = 8;              // and the groups at most, within G_MAX
constexpr int SP = TILE + 1;               // a row of the scores' strip
constexpr int FIN = 64;                    // threads of the finish kernel

// The kind and planes of an operand of the compute dtype: a bf16 value
// goes in as itself (one plane, exact in bf16 and in TF32); an fp32 value
// splits into hi and lo TF32 planes.  TT: the kind of a product of two.
// BUF: the bytes of a buffer of planes, the most any product of the
// backward takes (bf16: a TF32 product of a bf16 and a split fp32 operand,
// three planes; fp32: four).
template <typename T> struct Prec;
// CARRY_BUF: the carry kernel's, whose one product takes A's values as
// loaded and B in T (bf16: two bf16 planes; fp32: one fp32, two tf32).
template <> struct Prec<float> {
  static constexpr int TT = TF, PT = 2, BUF = 4 * PLANE_TF,
                       CARRY_BUF = 3 * PLANE_TF;
};
template <> struct Prec<BF16> {
  static constexpr int TT = BF, PT = 1, BUF = 3 * PLANE_TF,
                       CARRY_BUF = 2 * PLANE_BF;
};

// An operand computed on its load from shared memory alone: no run is
// copied for it.
struct Computed {};
template <class E> struct IsComputed {
  static constexpr bool value = false;
};
template <> struct IsComputed<Computed> {
  static constexpr bool value = true;
};

// A wgmma descriptor of a K-major plane without swizzle at shared address
// addr (PTX ISA, "Matrix Descriptor"; layout type 0).
__device__ __forceinline__ uint64_t plane_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(LBO >> 4) << 16) |
         (static_cast<uint64_t>(SBO >> 4) << 32);
}

// D[64 x 32] += A[64 x 16] B[16 x 32], bf16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 8] B[8 x 32], tf32, both K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], bf16, A in registers, B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32], const uint32_t* a,
                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, "
      "p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 8] B[8 x 64], tf32, A in registers, B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t* a,
                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, "
      "p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v split into its kind's planes: BF hi = r_bf16(v), lo = r_bf16(v - hi);
// TF hi = tf32_rna(v), lo = tf32_rna(v - hi).  v - hi is exact in fp32.
// With one plane v must be exact in the kind.  FP: v itself.
template <int K>
__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  if (K == BF) {
    hi = __bfloat162float(__float2bfloat16_rn(v));
    lo = __bfloat162float(__float2bfloat16_rn(v - hi));
  } else if (K == FP) {
    hi = v;
    lo = 0.f;
  } else {
    hi = tf32_rna(v);
    lo = tf32_rna(v - hi);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
             << 16;
}

// The byte offset of element (row mm, k kk) in a plane of kind K.
template <int K>
__host__ __device__ __forceinline__ int plane_at(int mm, int kk) {
  return K == BF ? (kk >> 3) * LBO + mm * 16 + (kk & 7) * 2
                 : (kk >> 2) * LBO + mm * 16 + (kk & 3) * 4;
}
template <int K> __host__ __device__ constexpr int plane_bytes() {
  return K == BF ? PLANE_BF : PLANE_TF;
}

// Eight values along k of an operand's row mm, from k kk (a multiple of
// 8), into its planes: one 16-byte store a plane (two in TF32).
template <int K, int P>
__device__ __forceinline__ void put_row(unsigned char* base, int mm, int kk,
                                        const float (&v)[8]) {
  float hi[8], lo[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) split<K>(v[e], hi[e], lo[e]);
#pragma unroll
  for (int pl = 0; pl < P; ++pl) {
    const float* x = pl == 0 ? hi : lo;
    unsigned char* at = base + pl * plane_bytes<K>() + plane_at<K>(mm, kk);
    if (K == BF) {
      *reinterpret_cast<uint4*>(at) =
          make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                     pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
    } else {
      *reinterpret_cast<float4*>(at) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(at + LBO) =
          make_float4(x[4], x[5], x[6], x[7]);
    }
  }
}

// Eight values along m (rows mm..mm+7) at k kk into the planes.
template <int K, int P>
__device__ __forceinline__ void put_col(unsigned char* base, int mm, int kk,
                                        const float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float hi, lo;
    split<K>(v[e], hi, lo);
#pragma unroll
    for (int pl = 0; pl < P; ++pl) {
      const float x = pl == 0 ? hi : lo;
      unsigned char* at =
          base + pl * plane_bytes<K>() + plane_at<K>(mm + e, kk);
      if (K == BF)
        *reinterpret_cast<uint16_t*>(at) =
            __bfloat16_as_ushort(__float2bfloat16_rn(x));
      else
        *reinterpret_cast<float*>(at) = x;
    }
  }
}

// A thread's run of eight in a k step: along k (kf), row b0 + tid / 4
// from k (tid % 4) * 8; along the other dimension, k row tid % 32 from
// b0 + (tid / 32) * 8, so a warp's stores into the planes fall in distinct
// banks.  cnt of the eight lie inside [k_lo, k_hi) x [b0, B).
__device__ __forceinline__ void run_at(bool kf, int c, int k_lo, int k_hi,
                                       int b0, int B, int& k, int& r,
                                       int& cnt) {
  const int tid = threadIdx.x;
  auto clamp8 = [](int n) { return n < 0 ? 0 : (n > 8 ? 8 : n); };
  if (kf) {
    r = b0 + tid / 4;
    k = k_lo + c * KS + (tid % 4) * 8;
    cnt = r < B ? clamp8(k_hi - k) : 0;
  } else {
    k = k_lo + c * KS + tid % 32;
    r = b0 + (tid / 32) * 8;
    cnt = k < k_hi ? clamp8(B - r) : 0;
  }
}

// A run's cnt elements from p into the thread's slot: cp.async (16 bytes
// a copy, the rest zero-filled) where p is 16-byte aligned, else plain
// loads.  The slot is the thread's own: only it reads the run back.
__device__ __forceinline__ uint16_t raw_bits(BF16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ float raw_bits(float v) { return v; }
template <class E>
__device__ __forceinline__ void issue_run(unsigned char* slot, const E* p,
                                          int cnt) {
  if (cnt <= 0) return;
  constexpr int es = sizeof(E);
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint32_t dst = smem_addr(slot);
    cp_async16(dst, p, cnt * es < 16 ? cnt * es : 16);
    if (es == 4) cp_async16(dst + 16, cnt > 4 ? p + 4 : p, cnt > 4 ? (cnt - 4) * 4 : 0);
  } else {
    auto* out = reinterpret_cast<decltype(raw_bits(*p))*>(slot);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      out[e] = e < cnt ? raw_bits(p[e]) : decltype(raw_bits(*p))(0);
  }
}
// The same, element by element through src(e) (a run that is not
// contiguous in memory).
template <class E, class F>
__device__ __forceinline__ void issue_elems(unsigned char* slot, F src,
                                            int cnt) {
  auto* out = reinterpret_cast<decltype(raw_bits(*src(0)))*>(slot);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    out[e] = e < cnt ? raw_bits(*src(e)) : decltype(raw_bits(*src(0)))(0);
}

// The run in the slot as fp32, the elements past cnt zero.
__device__ __forceinline__ void read_run(const unsigned char* slot, const BF16*,
                                         int cnt, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(slot);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(w[e] << 16);
    v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e >= cnt) v[e] = 0.f;
}
__device__ __forceinline__ void read_run(const unsigned char* slot,
                                         const float*, int cnt, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(slot)[0];
  const float4 b = reinterpret_cast<const float4*>(slot)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e >= cnt) v[e] = 0.f;
}
__device__ __forceinline__ void read_run(const unsigned char*, const Computed*,
                                         int, float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
}

// One k step (kn <= KS valid) of the warpgroup's 64 x 32 on the planes at
// shared address buf (A's PA planes, then B's PB): for each k slice of 16
// (bf16) or 8 (tf32) the lo products first, then hi hi'.
template <int K, int PA, int PB>
__device__ __forceinline__ void wg_chunk(float (&acc)[16], uint32_t buf,
                                         int kn) {
  constexpr int PL = plane_bytes<K>(), KK = K == BF ? 16 : 8;
  const uint32_t a = buf;
  const uint32_t b = buf + PA * PL + (threadIdx.x >> 7) * 4 * SBO;
#pragma unroll
  for (int ks = 0; ks < KS; ks += KK) {
    if (ks >= kn) break;
    const uint32_t off = (ks / KK) * 2 * LBO;   // two k chunks a slice
    const uint64_t ah = plane_desc(a + off), bh = plane_desc(b + off);
    if (K == BF) {
      if (PA == 2) wgmma_bf16(acc, plane_desc(a + PL + off), bh);
      if (PB == 2) wgmma_bf16(acc, ah, plane_desc(b + PL + off));
      wgmma_bf16(acc, ah, bh);
    } else {
      if (PA == 2) wgmma_tf32(acc, plane_desc(a + PL + off), bh);
      if (PB == 2) wgmma_tf32(acc, ah, plane_desc(b + PL + off));
      wgmma_tf32(acc, ah, bh);
    }
  }
}

// One product on the tensor cores: acc[q] += sum_{k in [k_lo, k_hi)}
// A(k, m) B(k, n) for the thread's elements (m, n) of the tile at (m0, n0)
// (m < M, n < N; the rest sums zeros).  An operand comes as runs of eight
// consecutive values, along k where AK / BK (it is contiguous in k) and
// along m / n otherwise: sa(k, m) points at a run in device memory (EA the
// element type; Computed: none, xa makes it), copied with cp.async into the
// thread's own slot of a ring of R::S steps, and xa(k, m, cnt, v) turns the
// run's fp32 values into the operand's on their way into the planes of
// kind K (PA and PB planes; a bf16 run that goes in as it is is copied
// as it is).  contig_a false: A's runs are not contiguous (read element by
// element through sa).  prologue() issues the first S - 1 steps; run()
// issues S - 1 steps ahead of the one it stages, so the next product's
// prologue can be issued before this one's epilogue.  With two buffers of
// planes, run() stages step c while the tensor cores run step c - 1: one
// barrier a step.  Every thread of the block calls run(); it reads shared
// memory written before it only after its first barrier, and returns with
// its warpgroup's products complete.
// acc += half 0 + half 1 at each of the thread's elements: each
// warpgroup's 64 x 64 partial over its half of k, the columns that the
// other warpgroup holds handed over through 16 KB of shared memory at x,
// free once every thread has passed the first barrier.  (Constant indices
// keep part in registers.)
__device__ __forceinline__ void meet_halves(float (&acc)[16],
                                            const float (&part)[32],
                                            unsigned char* at) {
  float* x = reinterpret_cast<float*>(at);            // [2][16][128]
  const int wg = threadIdx.x >> 7, ti = threadIdx.x & 127;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 16; ++q)
    x[(wg * 16 + q) * 128 + ti] = wg == 0 ? part[16 + q] : part[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 16; ++q)
    acc[q] = __fadd_rn(acc[q], __fadd_rn(wg == 0 ? part[q] : part[16 + q],
                                         x[((1 - wg) * 16 + q) * 128 + ti]));
}

template <class X> struct Unchanged {
  static constexpr bool value = false;
};
// A's transform for a register operand: f(k, m, v, q) the value of A at
// (k, m) from the operand's value v as loaded (0 for a Computed operand);
// with span > 0 every k slice lies inside one span of k and q is the
// slice's k / span (the head, where k runs over (head, p)), else q = -1.
template <class F> struct Reg {
  F f;
  int span;
};
template <class F>
__device__ __forceinline__ Reg<F> reg(F f, int span = 0) {
  return {f, span};
}
template <class X> struct IsReg {
  static constexpr bool value = false;
};
template <class F> struct IsReg<Reg<F>> {
  static constexpr bool value = true;
};
// The TMA state of a block: its stages' mbarriers and, a bit a stage, the
// parity of each one's next phase (the same in every thread).
struct Tma {
  uint32_t bars;                  // shared address of TMA_STAGES mbarriers
  uint32_t phase;
};
// What a kernel's products share: the planes' region (region bytes), the
// cp.async ring and the TMA state.
struct Ctx {
  unsigned char* planes;
  unsigned char* ring;
  int region;
  Tma tm;
};
template <class F> __device__ __forceinline__ int span_of(const Reg<F>& r) {
  return r.span;
}
template <class X> __device__ __forceinline__ int span_of(const X&) {
  return 0;
}

// the transform that leaves a run as it came
struct Same {
  __device__ void operator()(int, int, int, float (&)[8]) const {}
};
template <> struct Unchanged<Same> {
  static constexpr bool value = true;
};

template <int K, int PA, int PB, bool AK, bool BK, class EA, class EB,
          class R, class SA, class XA, class SB, class XB>
struct Gemm {
  int m0, n0, M, N, k_lo, k_hi;
  SA sa;
  XA xa;
  SB sb;
  XB xb;
  bool contig_a;

  static constexpr int RA = IsComputed<EA>::value ? 0 : 8 * sizeof(EA);
  static constexpr int RB = IsComputed<EB>::value ? 0 : 8 * sizeof(EB);
  static constexpr int PL = plane_bytes<K>();
  // A in registers: its values as loaded go into one plane of kind AK_ (bf16
  // as it is, fp32 whole), none for a Computed operand
  static constexpr bool AR = IsReg<XA>::value;
  static constexpr int KA = IsComputed<EA>::value || sizeof(EA) == 2 ? BF : FP;
  static constexpr int A_BYTES =
      !AR ? PA * PL : (IsComputed<EA>::value ? 0 : plane_bytes<KA>());
  static_assert(THREADS * (RA + RB) <= R::STAGE, "a step's runs fit a stage");
  static_assert(A_BYTES + PB * PL <= R::BUF, "a step's planes fit a buffer");
  static_assert(2 * 16 * 128 * 4 <= R::NB * R::BUF,
                "the halves' exchange fits the planes");

  __device__ int steps() const {
    return k_hi > k_lo ? (k_hi - k_lo + KS - 1) / KS : 0;
  }
  __device__ void issue(unsigned char* ring, int c) const {
    if (c < steps()) {
      unsigned char* st = ring + (c % R::S) * R::STAGE;
      int k, r, cnt;
      if constexpr (!IsComputed<EA>::value) {
        run_at(AK, c, k_lo, k_hi, m0, M, k, r, cnt);
        unsigned char* at = st + threadIdx.x * RA;
        if (contig_a)
          issue_run(at, reinterpret_cast<const EA*>(sa(k, r)), cnt);
        else
          issue_elems<EA>(at, [&](int e) {
            return reinterpret_cast<const EA*>(AK ? sa(k + e, r) : sa(k, r + e));
          }, cnt);
      }
      if constexpr (!IsComputed<EB>::value) {
        run_at(BK, c, k_lo, k_hi, n0, N, k, r, cnt);
        issue_run(st + THREADS * RA + threadIdx.x * RB,
                  reinterpret_cast<const EB*>(sb(k, r)), cnt);
      }
    }
    cp_commit();
  }
  __device__ void prologue(unsigned char* ring) const {
    for (int c = 0; c < R::S - 1; ++c) issue(ring, c);
  }
  // one operand's run of step c from its slot into the planes at `pl`
  template <int KD, int P, bool KF, class E, class XF>
  __device__ void stage_one(const unsigned char* slot, unsigned char* pl,
                            int c, int b0, int B, XF xf) const {
    int k, r, cnt;
    run_at(KF, c, k_lo, k_hi, b0, B, k, r, cnt);
    const int lr = r - b0, lk = k - k_lo - c * KS;
    if constexpr (KD == BF && P == 1 && KF && Unchanged<XF>::value &&
                  sizeof(E) == 2 && !IsComputed<E>::value) {
      const uint4 u = cnt > 0 ? *reinterpret_cast<const uint4*>(slot)
                              : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(pl + plane_at<BF>(lr, lk)) = u;
    } else {
      float v[8];
      read_run(slot, static_cast<const E*>(nullptr), cnt, v);
      xf(k, r, cnt, v);
      if (KF) put_row<KD, P>(pl, lr, lk, v);
      else put_col<KD, P>(pl, lr, lk, v);
    }
  }
  // step c: its runs issued S - 1 steps before, staged into planes `pl`
  __device__ void stage(unsigned char* ring, unsigned char* pl, int c) const {
    issue(ring, c + R::S - 1);
    cp_wait<R::S - 1>();
    const unsigned char* st = ring + (c % R::S) * R::STAGE;
    if constexpr (!AR)
      stage_one<K, PA, AK, EA>(st + threadIdx.x * RA, pl, c, m0, M, xa);
    else if constexpr (!IsComputed<EA>::value)
      stage_one<KA, 1, AK, EA>(st + threadIdx.x * RA, pl, c, m0, M, Same());
    stage_one<K, PB, BK, EB>(st + THREADS * RA + threadIdx.x * RB,
                             pl + A_BYTES, c, n0, N, xb);
  }
  // A in registers: the two warpgroups split each step's k, warpgroup wg
  // its half (bf16: the k slice of 16 at 16 wg; tf32: the slices of 8 at 16
  // wg and 16 wg + 8), each summing a 64 x 64 partial (m64n64), so each A
  // value is computed once a block; the two partials meet at the end.
  static constexpr int KK = K == BF ? 16 : 8;
  static constexpr int WSL = KS / 2 / KK;     // k slices a warpgroup a step
  static constexpr int FR = WSL * 8;          // fr[(s * 2 + plane) * 4 + j]
  // The thread's A fragments of step c, split into its PA planes: wgmma's
  // register layout for the warp's 16 rows (bf16 k16: a register the pair
  // (k, k + 1) at rows g and g + 8, k = 2 t and 2 t + 8; tf32 k8: (g, t),
  // (g + 8, t), (g, t + 4), (g + 8, t + 4)).
  __device__ void frags(const unsigned char* buf, int c,
                        uint32_t (&fr)[FR]) const {
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3, kc = k_lo + c * KS;
    const int wg = threadIdx.x >> 7;
#pragma unroll
    for (int sl = 0; sl < WSL; ++sl) {
      const int k0 = (wg * WSL + sl) * KK;
      const int q = xa.span > 0 ? (kc + k0) / xa.span : -1;
      float v[8];
#pragma unroll
      for (int e = 0; e < (K == BF ? 8 : 4); ++e) {
        int mm, kk;
        if (K == BF) {
          const int j = e >> 1;
          mm = 16 * w + g + 8 * (j & 1);
          kk = k0 + 2 * t + 8 * (j >> 1) + (e & 1);
        } else {
          mm = 16 * w + g + 8 * (e & 1);
          kk = k0 + t + 4 * (e >> 1);
        }
        const int m = m0 + mm, k = kc + kk;
        float raw = 0.f;
        if constexpr (!IsComputed<EA>::value) {
          const unsigned char* at = buf + plane_at<KA>(mm, kk);
          raw = KA == BF ? __bfloat162float(*reinterpret_cast<const BF16*>(at))
                         : *reinterpret_cast<const float*>(at);
        }
        v[e] = m < M && k < k_hi ? xa.f(k, m, raw, q) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (K == BF) {
          float h0, l0, h1, l1;
          split<BF>(v[2 * j], h0, l0);
          split<BF>(v[2 * j + 1], h1, l1);
          fr[sl * 8 + j] = pack_bf16(h0, h1);
          fr[sl * 8 + 4 + j] = pack_bf16(l0, l1);
        } else {
          float h, l;
          split<TF>(v[j], h, l);
          fr[sl * 8 + j] = __float_as_uint(h);
          fr[sl * 8 + 4 + j] = __float_as_uint(l);
        }
      }
    }
  }
  // The warpgroup's half of a k step (kn <= KS valid) with A from
  // registers: for each slice the lo products first, then hi hi'.
  __device__ void chunk_rs(float (&part)[32], const uint32_t (&fr)[FR],
                           uint32_t buf, int kn) const {
    const uint32_t b = buf + A_BYTES;
    const int wg = threadIdx.x >> 7;
#pragma unroll
    for (int sl = 0; sl < WSL; ++sl) {
      const int s_ = wg * WSL + sl;
      if (s_ * KK >= kn) break;
      const uint32_t off = s_ * 2 * LBO;
      const uint64_t bh = plane_desc(b + off);
      if (K == BF) {
        if (PA == 2) wgmma_bf16_rs(part, fr + sl * 8 + 4, bh);
        if (PB == 2) wgmma_bf16_rs(part, fr + sl * 8, plane_desc(b + PL + off));
        wgmma_bf16_rs(part, fr + sl * 8, bh);
      } else {
        if (PA == 2) wgmma_tf32_rs(part, fr + sl * 8 + 4, bh);
        if (PB == 2) wgmma_tf32_rs(part, fr + sl * 8, plane_desc(b + PL + off));
        wgmma_tf32_rs(part, fr + sl * 8, bh);
      }
    }
  }
  __device__ void run(float (&acc)[16], unsigned char* planes,
                      unsigned char* ring) const {
    if constexpr (AR) run_rs(acc, planes, ring);
    else run_ss(acc, planes, ring);
  }
  __device__ void prologue(Ctx& x) const { prologue(x.ring); }
  __device__ void run(float (&acc)[16], Ctx& x) const {
    run(acc, x.planes, x.ring);
  }
  __device__ void run_ss(float (&acc)[16], unsigned char* planes,
                         unsigned char* ring) const {
    const bool busy = n0 + (threadIdx.x >> 7) * 32 < N;
    const int n = steps();
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      unsigned char* buf = planes + (c % R::NB) * R::BUF;
      if (R::NB == 1 && c > 0) __syncthreads();
      stage(ring, buf, c);
      fence_async_smem();
      if (R::NB > 1) {                  // step c - 1 done: its buffer frees
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncthreads();
      if (busy) {
        fence_regs(acc);
        wgmma_fence();
        wg_chunk<K, PA, PB>(acc, smem_addr(buf),
                            min(KS, k_hi - k_lo - c * KS));
        wgmma_commit();
        fence_regs(acc);
      }
      if (R::NB == 1) {
        wgmma_wait<0>();
        fence_regs(acc);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }
  // With three buffers of planes the fragments of step c are computed
  // while step c - 1 runs on the tensor cores (their registers alternate):
  // a buffer is staged again three steps on, after every thread has waited
  // for the products that read it and passed a barrier since.
  __device__ void step_rs(float (&part)[32], unsigned char* planes,
                          unsigned char* ring, int c, uint32_t (&fr)[FR],
                          uint32_t (&prev)[FR]) const {
    unsigned char* buf = planes + (c % R::NB) * R::BUF;
    stage(ring, buf, c);
    fence_async_smem();
    __syncthreads();
    frags(buf, c, fr);
    wgmma_wait<0>();                    // step c - 1 done: prev is free
    fence_regs(part);
    fence_regs(prev);
    wgmma_fence();
    chunk_rs(part, fr, smem_addr(buf), min(KS, k_hi - k_lo - c * KS));
    wgmma_commit();
    fence_regs(part);
    fence_regs(fr);
  }
  // acc += the product, its two k halves summed each in its warpgroup's
  // 64 x 64 partial and then added, each warpgroup handing the other the
  // columns it holds: acc + (half 0 + half 1) at every element.  With one
  // or two buffers a step's fragments follow its barrier.
  __device__ void run_rs(float (&acc)[16], unsigned char* planes,
                         unsigned char* ring) const {
    const int n = steps();
    float part[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) part[q] = 0.f;
    uint32_t fr[FR] = {}, fr2[FR] = {};  // read by a step until its wait
    __syncthreads();
    if constexpr (R::NB >= 3) {
      for (int c = 0; c < n; c += 2) {
        step_rs(part, planes, ring, c, fr, fr2);
        if (c + 1 < n) step_rs(part, planes, ring, c + 1, fr2, fr);
      }
    } else {
      for (int c = 0; c < n; ++c) {
        unsigned char* buf = planes + (c % R::NB) * R::BUF;
        if (R::NB == 1 && c > 0) __syncthreads();
        stage(ring, buf, c);
        fence_async_smem();
        if (R::NB == 2) {
          wgmma_wait<0>();
          fence_regs(part);
          fence_regs(fr);
        }
        __syncthreads();
        frags(buf, c, fr);
        fence_regs(part);
        wgmma_fence();
        chunk_rs(part, fr, smem_addr(buf), min(KS, k_hi - k_lo - c * KS));
        wgmma_commit();
        fence_regs(part);
        fence_regs(fr);
        if (R::NB == 1) {
          wgmma_wait<0>();
          fence_regs(part);
          fence_regs(fr);
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(fr);
    fence_regs(fr2);
    meet_halves(acc, part, planes);
  }
};

template <int K, int PA, int PB, bool AK, bool BK, class EA, class EB,
          class R, class SA, class XA, class SB, class XB>
__device__ __forceinline__ Gemm<K, PA, PB, AK, BK, EA, EB, R, SA, XA, SB, XB>
gemm(int m0, int n0, int M, int N, int k_lo, int k_hi, SA sa, XA xa, SB sb,
     XB xb, bool contig_a = true) {
  return {m0, n0, M, N, k_lo, k_hi, sa, xa, sb, xb, contig_a};
}

// the source of a Computed operand
struct Nowhere {
  __device__ const void* operator()(int, int) const { return nullptr; }
};

// ------------------------------------------------- products through TMA
// With T = bf16 and shapes that TMA's boxes fit (tma_fits), the products
// whose operands are bf16 as they stand in device memory take them by TMA
// straight into shared memory: a box of 8 columns (16 bytes) by 64 rows a
// k chunk of a K-major plane (its rows 16 bytes apart, the chunks 1024:
// wgmma's layout without swizzle), or by 32 rows of k an 8-column group of
// an MN-major plane (k rows 16 bytes apart, the groups 512; B read
// transposed).  One thread arms the stage's mbarrier and issues the boxes;
// the stages live in the planes' region, each refilled after a barrier
// once its product has run.  Out-of-range rows and columns of a tensor
// come as zeros.
constexpr int TMA_PLANE = 4096;            // a bf16 plane of 64 x KS by TMA
// an MN-major plane's k groups (LBO) and n groups (SBO)
constexpr uint32_t MN_LBO = 128, MN_SBO = 512;
constexpr int TMA_STAGES = 4;              // at most, as the region allows
constexpr int KW = 2 * KS;                 // the k depth of a wide step

// The 2-d tensor maps of the bf16 operands, box 8 x 64 (K-major chunks) or
// 8 x 32 (MN-major groups): dy, x (b s, nh hd), B, C (b s, ns), the states
// (nc b nh hd, ns).  The forward has no dy.
struct Maps {
  CUtensorMap dyK, dyMN, xK, BK, CK, CMN, SK, SMN;
  // the forward's, wide and swizzled: x, B, C, the states and y
  CUtensorMap xW, BW, CW, SW, yW;
};

__device__ __forceinline__ void tma_load2(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// The 2-d box at (col, row) of map from shared address src, in a bulk
// group of the issuing thread.
__device__ __forceinline__ void tma_store2(const CUtensorMap* map,
                                           uint32_t src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The issuing thread's bulk stores have read their shared memory (READ)
// or are complete.
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A wgmma descriptor without swizzle: leading and stride byte offsets
__device__ __forceinline__ uint64_t desc_of(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D[64 x 64] += A[64 x 16] B[16 x 64], bf16, A in registers, B MN-major in
// shared memory (read transposed).
__device__ __forceinline__ void wgmma_bf16_rs_t(float (&d)[32],
                                                const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, "
      "p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Waits for stage s's boxes and flips its parity.
__device__ __forceinline__ void tma_wait(Tma& tm, int s) {
  mbar_wait(tm.bars + 8 * s, (tm.phase >> s) & 1);
  tm.phase ^= 1u << s;
}

// An operand by TMA: the map, and the box origin of k_lo (col, row).
struct Src {
  const CUtensorMap* map;
  int col, row;
};

// The operand kinds of a TMA product.
enum TmaA { A_K = 0, A_COMPUTED = 1, A_RAW_MN = 2, A_RAW_K = 3 };

// The byte of (row, byte b of its 128) in a tile of 128-byte swizzled
// rows (TMA's CU_TENSOR_MAP_SWIZZLE_128B, wgmma's 128-byte swizzle): a
// row's 16-byte chunks permuted by row % 8.  The tile starts 1024-aligned.
__device__ __forceinline__ int sw128(int row, int b) {
  return row * 128 + ((((b >> 4) ^ row) & 7) << 4) + (b & 15);
}

// acc += sum_{k in [k_lo, k_hi)} A(k, m) B(k, n) for the thread's elements
// of the tile at (m0, n0), k in steps of KD through NS stages of the
// region at `planes`: KS with boxes of 8 columns (16 bytes), or, W (the
// forward's products), KW with boxes of 64 columns (128 bytes, swizzled,
// sw128), a K-major operand a box of 64 rows a 64 k, an MN-major one a
// box of KW rows of k.  AM = A_K: A and B K-major by TMA, both from shared
// memory, the warpgroups splitting n as Gemm does.  Otherwise B is
// MN-major by TMA and A comes from registers, f(k, m, v, -1) of A's value
// v as loaded (A_RAW_MN: A's k are its rows; A_RAW_K: its columns) or from
// nothing (A_COMPUTED), the warpgroups splitting k as Gemm's register
// products do; PA planes of A (bf16 hi and lo).  prologue() (every thread,
// after the block's last product) issues the first stages; run() issues
// each further stage after the barrier that frees it, and reads shared
// memory written before it only after its first barrier.
template <int AM, int PA, class XA, bool W = false>
struct Tgemm {
  int m0, n0, M, N, k_lo, k_hi;
  Src a, b;
  XA xa;

  static constexpr int KD = W ? KW : KS;
  static constexpr int PLANE = W ? KW * 128 : TMA_PLANE;   // 64 x KD bf16
  static constexpr int A_BYTES = AM == A_COMPUTED ? 0 : PLANE;
  static constexpr int STAGE = A_BYTES + PLANE;
  static constexpr int KK = 16, WSL = KD / 2 / KK, FR = WSL * 8;

  __device__ int steps() const {
    return k_hi > k_lo ? (k_hi - k_lo + KD - 1) / KD : 0;
  }
  __device__ static int stages(int region) {
    const int n = region / STAGE;
    return n < TMA_STAGES ? n : TMA_STAGES;
  }
  // thread 0: step c's boxes into stage s
  __device__ void issue(unsigned char* planes, const Tma& tm, int c,
                        int s) const {
    const uint32_t dst = smem_addr(planes + s * STAGE);
    const uint32_t bar = tm.bars + 8 * s;
    const int k = c * KD;
    mbar_expect_tx(bar, STAGE);
    if constexpr (W) {
      if (AM == A_K || AM == A_RAW_K)
        tma_load2(dst, a.map, bar, a.col + k, a.row);
      else if (AM == A_RAW_MN)
        tma_load2(dst, a.map, bar, a.col, a.row + k);
      if (AM == A_K)
        tma_load2(dst + A_BYTES, b.map, bar, b.col + k, b.row);
      else
        tma_load2(dst + A_BYTES, b.map, bar, b.col, b.row + k);
      return;
    }
    if (AM == A_K || AM == A_RAW_K)
      for (int q = 0; q < KS / 8; ++q)
        tma_load2(dst + q * 1024, a.map, bar, a.col + k + 8 * q, a.row);
    else if (AM == A_RAW_MN)
      for (int q = 0; q < TILE / 8; ++q)
        tma_load2(dst + q * 512, a.map, bar, a.col + 8 * q, a.row + k);
    if (AM == A_K)
      for (int q = 0; q < KS / 8; ++q)
        tma_load2(dst + A_BYTES + q * 1024, b.map, bar, b.col + k + 8 * q,
                  b.row);
    else
      for (int q = 0; q < TILE / 8; ++q)
        tma_load2(dst + A_BYTES + q * 512, b.map, bar, b.col + 8 * q,
                  b.row + k);
  }
  __device__ void prologue(unsigned char* planes, int region,
                           const Tma& tm) const {
    fence_async_smem();
    __syncthreads();                    // the region is free
    if (threadIdx.x == 0) {
      const int n = steps(), ns = stages(region);
      for (int c = 0; c < n && c < ns; ++c) issue(planes, tm, c, c);
    }
  }
  // the thread's A fragments of stage `st`'s step c (Gemm::frags' layout)
  __device__ void frags(const unsigned char* st, int c,
                        uint32_t (&fr)[FR]) const {
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3, kc = k_lo + c * KD;
    const int wg = threadIdx.x >> 7, span = span_of(xa);
#pragma unroll
    for (int sl = 0; sl < WSL; ++sl) {
      const int k0 = (wg * WSL + sl) * KK;
      const int q = span > 0 ? (kc + k0) / span : -1;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = e >> 1;
        const int mm = 16 * w + g + 8 * (j & 1);
        const int kk = k0 + 2 * t + 8 * (j >> 1) + (e & 1);
        const int m = m0 + mm, k = kc + kk;
        float raw = 0.f;
        if (AM == A_RAW_MN)
          raw = __bfloat162float(*reinterpret_cast<const BF16*>(
              st + (W ? sw128(kk, 2 * mm)
                      : (mm >> 3) * 512 + kk * 16 + (mm & 7) * 2)));
        else if (AM == A_RAW_K)
          raw = __bfloat162float(*reinterpret_cast<const BF16*>(
              st + (W ? sw128(mm, 2 * kk)
                      : (kk >> 3) * 1024 + mm * 16 + (kk & 7) * 2)));
        v[e] = m < M && k < k_hi ? xa.f(k, m, raw, q) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (W && PA == 1) {   // bf16 values: one plane, one cvt
          const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j],
                                                         v[2 * j + 1]);
          fr[sl * 8 + j] = *reinterpret_cast<const uint32_t*>(&h);
          fr[sl * 8 + 4 + j] = 0u;
        } else {
          float h0, l0, h1, l1;
          split<BF>(v[2 * j], h0, l0);
          split<BF>(v[2 * j + 1], h1, l1);
          fr[sl * 8 + j] = pack_bf16(h0, h1);
          fr[sl * 8 + 4 + j] = pack_bf16(l0, l1);
        }
      }
    }
  }
  template <class ACC>
  __device__ void run_steps(ACC& acc, unsigned char* planes, int region,
                            Tma& tm) const {
    const int n = steps(), ns = stages(region);
    const int wg = threadIdx.x >> 7;
    const bool busy = AM != A_K || n0 + wg * 32 < N;
    uint32_t fr[FR] = {};
    for (int c = 0; c < n; ++c) {
      const int s = c % ns;
      unsigned char* st = planes + s * STAGE;
      const uint32_t sa = smem_addr(st), sb = sa + A_BYTES;
      const int kn = min(KD, k_hi - k_lo - c * KD);
      tma_wait(tm, s);
      if (busy) {
        if constexpr (AM == A_K) {
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int sl = 0; sl < KD / 16; ++sl) {
            if (sl * 16 >= kn) break;
            if constexpr (W)            // 16 k: 32 bytes of a 128-byte row
              wgmma_bf16(acc, smem_desc(sa + sl * 32, 16, 1024),
                         smem_desc(sb + wg * 4096 + sl * 32, 16, 1024));
            else
              wgmma_bf16(acc, desc_of(sa + sl * 2048, 1024, 128),
                         desc_of(sb + wg * 512 + sl * 2048, 1024, 128));
          }
        } else {
          frags(st, c, fr);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int sl = 0; sl < WSL; ++sl) {
            const int s_ = wg * WSL + sl;
            if (s_ * KK >= kn) break;
            const uint64_t db =
                W ? smem_desc(sb + s_ * 16 * 128, PLANE, 1024)
                  : desc_of(sb + s_ * 256, MN_LBO, MN_SBO);
            if (PA == 2) wgmma_bf16_rs_t(acc, fr + sl * 8 + 4, db);
            wgmma_bf16_rs_t(acc, fr + sl * 8, db);
          }
        }
        wgmma_commit();
        fence_regs(acc);
        fence_regs(fr);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(fr);
      if (c + ns < n) {
        __syncthreads();                // every product of stage s has run
        if (threadIdx.x == 0) {
          fence_async_smem();
          issue(planes, tm, c + ns, s);
        }
      }
    }
  }
  __device__ void prologue(Ctx& x) const {
    prologue(x.planes, x.region, x.tm);
  }
  __device__ void run(float (&acc)[16], Ctx& x) const {
    run(acc, x.planes, x.region, x.tm);
  }
  __device__ void run(float (&acc)[16], unsigned char* planes, int region,
                      Tma& tm) const {
    __syncthreads();                    // what the block wrote before it
    if constexpr (AM == A_K) {
      run_steps(acc, planes, region, tm);
    } else {
      float part[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) part[q] = 0.f;
      run_steps(part, planes, region, tm);
      meet_halves(acc, part, planes);
    }
  }
};

template <int AM, int PA, bool W = false, class XA>
__device__ __forceinline__ Tgemm<AM, PA, XA, W> tgemm(int m0, int n0, int M,
                                                      int N, int k_lo,
                                                      int k_hi, Src a, Src b,
                                                      XA xa) {
  return {m0, n0, M, N, k_lo, k_hi, a, b, xa};
}
struct NoX {
  __device__ float f(int, int, float v, int) const { return v; }
};

// Sets up the block's TMA stages' mbarriers at `bars` (thread 0), before
// the block's first barrier.
__device__ __forceinline__ Tma tma_init(unsigned char* bars) {
  const uint32_t b = smem_addr(bars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < TMA_STAGES; ++s) mbar_init(b + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return {b, 0u};
}

// f(q, m, n) for each of the thread's accumulators inside (M, N)
template <class F>
__device__ __forceinline__ void each_mma(int m0, int n0, int M, int N, F f) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x >> 7, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int m = m0 + w * 16 + g + 8 * ((q & 3) >> 1);
    const int n = n0 + wg * 32 + (q >> 2) * 8 + 2 * t + (q & 1);
    if (m < M && n < N) f(q, m, n);
  }
}

__device__ __forceinline__ void zero16(float (&v)[16]) {
#pragma unroll
  for (int q = 0; q < 16; ++q) v[q] = 0.f;
}

// ------------------------------------------------------------- forward
// The masked score r(L_ij) = r((cb_ij exp(cums_i - cums_j)) dt_j) for j <=
// i, and 0 above the diagonal, where the exponent is never taken: the
// forward's intra-chunk operand and the backward's for dx, one definition
// (cb(i, j) the rounded score, read only on and below the diagonal).
template <typename T, class CB>
__device__ __forceinline__ float masked_score(int i, int j, CB cb,
                                              const float* cu,
                                              const float* dts) {
  return j <= i ? rnd<T>(__fmul_rn(__fmul_rn(cb(i, j), expf(cu[i] - cu[j])),
                                   dts[j]))
                : 0.f;
}

// A forward kernel's TMA region: the stages of its products (two of A and
// B, or four of B alone), with room for the halves' exchange.
constexpr int FWD_REGION = TMA_STAGES * 2 * TMA_PLANE;

// The state kernel's ring of planes for its cp.async products: the
// backward carry kernel's.
template <typename T>
using StateRing = Ring<CARRY_STAGES, Stage2<T>::SAME, Prec<T>::CARRY_BUF,
                       CARRY_NB>;
// The output kernel's: bf16, two buffers of two bf16 planes; fp32, one of
// four 3xTF32 planes; each with room for the halves' exchange.
template <typename T> struct OutRing;
template <> struct OutRing<BF16> {
  using R = Ring<HEADS_STAGES, Stage2<BF16>::SAME, 2 * PLANE_TF, 2>;
};
template <> struct OutRing<float> {
  using R = Ring<HEADS_STAGES, Stage2<float>::SAME, Prec<float>::BUF, 1>;
};
// A row of the output kernel's scores strip: lc rounded up to 8, plus 8
// (rows 16 bytes apart in the banks).
__host__ __device__ __forceinline__ int strip_width(int lc) {
  return (lc + 7) / 8 * 8 + 8;
}
// A forward kernel's shared memory from its first 1024-byte boundary (the
// swizzled tiles' alignment; the launch asks for 1024 bytes more).
__device__ __forceinline__ unsigned char* align1024(unsigned char* smem) {
  return smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
}
// The bytes ahead of a forward kernel's own arrays: the TMA region (and,
// for the output kernel, a 64 x 64 bf16 tile that y passes through on its
// way to a TMA store: swizzled, STORE_TILE bytes), or the ring R's planes
// and its cp.async stages.
constexpr int STORE_TILE = TILE * TILE * 2;
template <class R>
__host__ __device__ constexpr int fwd_head(bool tm, bool store) {
  return tm ? FWD_REGION + (store ? STORE_TILE : 0)
            : R::NB * R::BUF + R::S * R::STAGE;
}

// v(q, m, n) of the thread's accumulators of the 64 x 64 tile at (m0, n0),
// rounded to bf16, through the swizzled tile at buf to the box (col, row)
// of map by thread 0's TMA store.  The box is written whole, clipped only
// at the tensor's edges.  Called by every thread; buf is written once the
// store before it has read it.
template <class F>
__device__ void store_tile(unsigned char* buf, const CUtensorMap* map,
                          int col, int row, int m0, int n0, F v) {
  if (threadIdx.x == 0) bulk_wait<true>();
  __syncthreads();
  each_mma(m0, n0, m0 + TILE, n0 + TILE, [&](int q, int m, int n) {
    *reinterpret_cast<BF16*>(buf + sw128(m - m0, 2 * (n - n0))) =
        __float2bfloat16_rn(v(q, m, n));
  });
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) tma_store2(map, smem_addr(buf), col, row);
}

// The context of a forward kernel's products at `base` (1024-aligned): by
// TMA a region of FWD_REGION bytes and TMA_STAGES mbarriers at `bars`;
// else the ring R (planes, then its cp.async stages).
template <bool TM, class R>
__device__ __forceinline__ Ctx fwd_ctx(unsigned char* base,
                                       unsigned char* bars) {
  if constexpr (TM) return Ctx{base, nullptr, FWD_REGION, tma_init(bars)};
  else return Ctx{base, base + R::NB * R::BUF, R::NB * R::BUF, {}};
}

// (1) The chunks of a (batch, head) in order, for the 64 x 64 tile
// blockIdx.y of its (hd, ns) state.  The cumsums of dt * A of CU_WIN
// chunks at a time (a thread a chunk, in order) into shared memory, and by
// the blocks of tile 0 into cums for the output kernel; at chunk c, sdecay = r(exp(seg - cums_j) dt_j) into shared memory and the
// tile's contribution sum_j U_j^T B_j on the tensor cores (U = r(sdecay x)
// as A from registers, the warpgroups splitting k), the entering state
// written out from the registers that carry it, and S <- r(r(S
// r(exp(seg))) + r(contrib)); the final state after the last chunk.  The
// chunks' products are one stream, each one's loads issued during the
// epilogue of the one before.
template <typename T, bool TM>
__global__ void __launch_bounds__(THREADS, 2)
state_kernel(const float* __restrict__ dt, const float* __restrict__ A,
             const T* __restrict__ X, const T* __restrict__ B, Dims d,
             float* __restrict__ cums, T* __restrict__ states,
             T* __restrict__ final_state, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  using R = StateRing<T>;
  unsigned char* base = align1024(smem);
  float* sdb = reinterpret_cast<float*>(base + fwd_head<R>(TM, false));
  // sdb [2][MAX_CHUNK], cw [CU_WIN][MAX_CHUNK], then TMA_STAGES mbarriers
  float* cw = sdb + 2 * MAX_CHUNK;
  Ctx cx = fwd_ctx<TM, R>(base, reinterpret_cast<unsigned char*>(
                                    cw + CU_WIN * MAX_CHUNK));
  const int tid = threadIdx.x, bh = blockIdx.x, bb = bh / d.nh, h = bh % d.nh;
  const int tn = (d.ns + TILE - 1) / TILE, tile = blockIdx.y;
  const int p0 = (tile / tn) * TILE, n0 = (tile % tn) * TILE;
  const float a = A[h];
  // the cumsums of chunks [c0, c0 + CU_WIN) into cw, a thread a chunk;
  // then tile 0's blocks copy them out, every thread a step
  auto window = [&](int c0) {
    const int c = c0 + tid;
    if (tid < CU_WIN && c < d.nc) {
      float acc = 0.f;
      for (int j = 0; j < d.lc; ++j) {
        acc = __fadd_rn(acc, __fmul_rn(dt[row(d, bb, c * d.lc + j) * d.nh + h],
                                       a));
        cw[tid * MAX_CHUNK + j] = acc;
      }
    }
    __syncthreads();
    if (tile != 0) return;
    for (int i = tid; i < CU_WIN * d.lc; i += THREADS) {
      const int w = i / d.lc, j = i % d.lc;
      if (c0 + w < d.nc)
        cums[row(d, bb, (c0 + w) * d.lc + j) * d.nh + h] =
            cw[w * MAX_CHUNK + j];
    }
  };
  window(0);                  // its barrier also covers the mbarriers' init
  auto prod = [&](int c) {
    const size_t r0 = row(d, bb, c * d.lc);
    const float* sd = sdb + (c & 1) * MAX_CHUNK;
    auto xa = reg([=](int j, int, float v, int) {
      return rnd<T>(__fmul_rn(sd[j], v));
    });
    if constexpr (TM)
      return tgemm<A_RAW_MN, 1, true>(
          p0, n0, d.hd, d.ns, 0, d.lc,
          Src{&maps.xW, h * d.hd + p0, static_cast<int>(r0)},
          Src{&maps.BW, n0, static_cast<int>(r0)}, xa);
    else
      return gemm<Prec<T>::TT, Prec<T>::PT, Prec<T>::PT, false, false, T, T,
                  R>(
          p0, n0, d.hd, d.ns, 0, d.lc,
          [=](int j, int p) { return X + ((r0 + j) * d.nh + h) * d.hd + p; },
          xa, [=](int j, int n) { return B + (r0 + j) * d.ns + n; }, Same());
  };
  float sv[16];
  zero16(sv);
  prod(0).prologue(cx);
  for (int c = 0; c < d.nc; ++c) {
    if (c > 0 && c % CU_WIN == 0) {
      __syncthreads();                    // the window before is read
      window(c);
    }
    const size_t r0 = row(d, bb, c * d.lc);
    const float* cu = cw + (c % CU_WIN) * MAX_CHUNK;
    const float seg = cu[d.lc - 1];
    for (int j = tid; j < d.lc; j += THREADS)
      sdb[(c & 1) * MAX_CHUNK + j] =
          rnd<T>(__fmul_rn(expf(seg - cu[j]), dt[(r0 + j) * d.nh + h]));
    const float g = rnd<T>(expf(seg));
    const size_t base_c = state_base(d, c, bb, h);
    float acc[16];
    zero16(acc);
    prod(c).run(acc, cx);
    if (c + 1 < d.nc) prod(c + 1).prologue(cx);
    each_mma(p0, n0, d.hd, d.ns, [&](int q, int p, int n) {
      states[base_c + static_cast<size_t>(p) * d.ns + n] = to_t<T>(sv[q]);
      sv[q] = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(sv[q], g)), rnd<T>(acc[q])));
    });
  }
  const size_t hn = static_cast<size_t>(d.hd) * d.ns;
  each_mma(p0, n0, d.hd, d.ns, [&](int q, int p, int n) {
    final_state[bh * hn + static_cast<size_t>(p) * d.ns + n] = to_t<T>(sv[q]);
  });
}

// (2) The outputs of up to two 64-row tiles I of a chunk (the first and
// the last, the second and the one before: tile I has I + 1 column tiles
// on or below the diagonal, so a pair has an even load), for a group of
// heads [h0, h1).  For each I: the scores' strip r(C_I . B_J^T), J <= I,
// once for the group, in shared memory; then for each head and 64 columns
// of hd, the intra product r(L_I.) x (A from registers through
// masked_score, k stopping at the tile's last row) and C_I S^T, and y =
// r(r(intra) + r(r(C S) r(exp(cums_i)))).  The products are one stream,
// each one's loads issued before the epilogue of the one ahead of it, and
// the next head's cums are loaded during the product before.
template <typename T, bool TM>
__global__ void __launch_bounds__(THREADS, 2)
out_kernel(const float* __restrict__ dt, const T* __restrict__ X,
           const T* __restrict__ B, const T* __restrict__ C,
           const float* __restrict__ cums, const T* __restrict__ states,
           Dims d, int gsize, T* __restrict__ y,
           const __grid_constant__ Maps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  using S = typename OutRing<T>::R;
  unsigned char* base = align1024(smem);
  unsigned char* stile = base + FWD_REGION;   // TM: the store tile
  T* strip = reinterpret_cast<T*>(base + fwd_head<S>(TM, true));
  // [TILE][sw]
  const int sw = strip_width(d.lc);
  float* cub = reinterpret_cast<float*>(strip + TILE * sw);  // [2][MAX_CHUNK]
  float* dtb = cub + 2 * MAX_CHUNK;                          // [2][MAX_CHUNK]
  float* eb = dtb + 2 * MAX_CHUNK;                           // [2][MAX_CHUNK]
  Ctx cx = fwd_ctx<TM, S>(base, reinterpret_cast<unsigned char*>(
                                    eb + 2 * MAX_CHUNK));
  const int tid = threadIdx.x, c = blockIdx.y;
  const int ngroups = (d.nh + gsize - 1) / gsize;
  const int bb = blockIdx.z / ngroups, grp = blockIdx.z % ngroups;
  const int h0 = grp * gsize, h1 = min(d.nh, h0 + gsize), gh = h1 - h0;
  const int nt = (d.lc + TILE - 1) / TILE, tp = (d.hd + TILE - 1) / TILE;
  const int tasks = gh * tp;
  const size_t r0 = row(d, bb, c * d.lc);
  constexpr int TT = Prec<T>::TT, PT = Prec<T>::PT;
  auto at = [=](int pos, int h) { return (r0 + pos) * d.nh + h; };
  auto xo = [=](int pos, int h, int p) {
    return ((r0 + pos) * d.nh + h) * d.hd + p;
  };
  // a head's cums and dt over the chunk: loaded into registers (a thread a
  // position) during the product before, stored to slot `sl` with r(exp(
  // cums)) before the product that needs them
  float pcu = 0.f, pdt = 0.f;
  auto pre_head = [&](int h) {
    if (tid < d.lc) {
      pcu = cums[at(tid, h)];
      pdt = dt[at(tid, h)];
    }
  };
  auto put_head = [&](int sl) {
    if (tid < d.lc) {
      cub[sl * MAX_CHUNK + tid] = pcu;
      dtb[sl * MAX_CHUNK + tid] = pdt;
      eb[sl * MAX_CHUNK + tid] = rnd<T>(expf(pcu));
    }
  };
  // the row tile of a side (-1: none) and its products: (a) a 64-column
  // tile J of the scores' strip; (b) a task's (head, p tile) intra product
  // and (c) its C S^T
  auto side_tile = [&](int side) {
    const int it = side == 0 ? static_cast<int>(blockIdx.x)
                             : nt - 1 - static_cast<int>(blockIdx.x);
    return side == 0 || it != static_cast<int>(blockIdx.x) ? it : -1;
  };
  auto prod_a = [&](int it, int jt) {
    const int I0 = it * TILE, iend = min(d.lc, I0 + TILE);
    if constexpr (TM)
      return tgemm<A_K, 1, true>(
          I0, jt * TILE, iend, iend, 0, d.ns,
          Src{&maps.CW, 0, static_cast<int>(r0) + I0},
          Src{&maps.BW, 0, static_cast<int>(r0) + jt * TILE}, NoX());
    else
      return gemm<TT, PT, PT, true, true, T, T, S>(
          I0, jt * TILE, iend, iend, 0, d.ns,
          [=](int n, int i) { return C + (r0 + i) * d.ns + n; }, Same(),
          [=](int n, int j) { return B + (r0 + j) * d.ns + n; }, Same());
  };
  auto prod_i = [&](int it, int task) {
    const int I0 = it * TILE, iend = min(d.lc, I0 + TILE);
    const int h = h0 + task / tp, p0 = (task % tp) * TILE;
    const float* cu = cub + (task & 1) * MAX_CHUNK;
    const float* dts = dtb + (task & 1) * MAX_CHUNK;
    auto cb_at = [=](int i, int j) {
      return ld(strip, static_cast<size_t>(i - I0) * sw + j);
    };
    auto xa = reg([=](int j, int i, float, int) {
      return masked_score<T>(i, j, cb_at, cu, dts);
    });
    if constexpr (TM)
      return tgemm<A_COMPUTED, 1, true>(
          I0, p0, iend, d.hd, 0, iend, Src{nullptr, 0, 0},
          Src{&maps.xW, h * d.hd + p0, static_cast<int>(r0)}, xa);
    else
      return gemm<TT, PT, PT, false, false, Computed, T, S>(
          I0, p0, iend, d.hd, 0, iend, Nowhere(), xa,
          [=](int j, int p) { return X + xo(j, h, p); }, Same());
  };
  auto prod_s = [&](int it, int task) {
    const int I0 = it * TILE, iend = min(d.lc, I0 + TILE);
    const int h = h0 + task / tp, p0 = (task % tp) * TILE;
    const T* S_ = states + state_base(d, c, bb, h);
    if constexpr (TM)
      return tgemm<A_K, 1, true>(
          I0, p0, iend, d.hd, 0, d.ns,
          Src{&maps.CW, 0, static_cast<int>(r0) + I0},
          Src{&maps.SW, 0, ((c * d.b + bb) * d.nh + h) * d.hd + p0},
          NoX());
    else
      return gemm<TT, PT, PT, true, true, T, T, S>(
          I0, p0, iend, d.hd, 0, d.ns,
          [=](int n, int i) { return C + (r0 + i) * d.ns + n; }, Same(),
          [=](int n, int p) {
            return S_ + static_cast<size_t>(p) * d.ns + n;
          },
          Same());
  };
  float acc[16], a1[16];
  prod_a(side_tile(0), 0).prologue(cx);
  for (int side = 0; side < 2; ++side) {
    const int it = side_tile(side);
    if (it < 0) break;
    const int I0 = it * TILE, iend = min(d.lc, I0 + TILE);
    for (int jt = 0; jt <= it; ++jt) {
      zero16(acc);
      prod_a(it, jt).run(acc, cx);
      if (jt < it) prod_a(it, jt + 1).prologue(cx);
      else prod_i(it, 0).prologue(cx);
      each_mma(I0, jt * TILE, iend, iend, [&](int q, int i, int j) {
        strip[static_cast<size_t>(i - I0) * sw + j] = to_t<T>(acc[q]);
      });
    }
    pre_head(h0);
    for (int task = 0; task < tasks; ++task) {
      const int h = h0 + task / tp, p0 = (task % tp) * TILE;
      const int sl = task & 1;
      put_head(sl);
      if (task + 1 < tasks) pre_head(h0 + (task + 1) / tp);
      zero16(a1);
      prod_i(it, task).run(a1, cx);
      prod_s(it, task).prologue(cx);
      zero16(acc);
      prod_s(it, task).run(acc, cx);
      const int nxt = side_tile(1);
      if (task + 1 < tasks) prod_i(it, task + 1).prologue(cx);
      else if (side == 0 && nxt >= 0) prod_a(nxt, 0).prologue(cx);
      const float* e = eb + sl * MAX_CHUNK;
      auto yv = [&](int q, int i, int) {
        return __fadd_rn(rnd<T>(a1[q]),
                         rnd<T>(__fmul_rn(rnd<T>(acc[q]), e[i])));
      };
      if constexpr (TM) {
        if (iend - I0 == TILE && d.hd - p0 >= TILE) {  // the box: y's alone
          store_tile(stile, &maps.yW, h * d.hd + p0,
                     static_cast<int>(r0) + I0, I0, p0, yv);
          continue;
        }
      }
      each_mma(I0, p0, iend, d.hd, [&](int q, int i, int p) {
        y[xo(i, h, p)] = to_t<T>(yv(q, i, p));
      });
    }
  }
  if constexpr (TM)
    if (tid == 0) bulk_wait<false>();   // the stores before the block ends
}

// A tile's 64 row sums of v (zero outside the tile) in a fixed order: the
// thread's eight values of a row, ((c, c+1) + (c+8, c+9)) + ((c+16, c+17)
// + (c+24, c+25)), the row's four lanes by shuffles (row_parts, into red:
// 2 x 64 floats), then after a barrier the two warpgroups in order
// (row_total, to thread r for row r < 64).  The block passes another
// barrier before it writes red again.
__device__ void row_parts(const float (&v)[16], float* red) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x >> 7, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int q = 2 * hf;
    float s = __fadd_rn(
        __fadd_rn(__fadd_rn(v[q], v[q + 1]), __fadd_rn(v[q + 4], v[q + 5])),
        __fadd_rn(__fadd_rn(v[q + 8], v[q + 9]),
                  __fadd_rn(v[q + 12], v[q + 13])));
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
    if (t == 0) red[wg * TILE + w * 16 + g + 8 * hf] = s;
  }
}
__device__ float row_total(const float* red) {
  const int r = threadIdx.x;
  return r < TILE ? __fadd_rn(red[r], red[TILE + r]) : 0.f;
}

// The same for the 64 column sums: the thread's two values of a column
// (rows g and g + 8), the column's eight lanes by shuffles (col_parts, into
// red: 4 x 64 floats), then the four warps of its warpgroup in order
// (col_total, to thread n).
__device__ void col_parts(const float (&v)[16], float* red) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x >> 7, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = __fadd_rn(v[4 * j + e], v[4 * j + 2 + e]);
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 4));
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 8));
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 16));
      if (g == 0) red[w * TILE + wg * 32 + j * 8 + 2 * t + e] = s;
    }
}
__device__ float col_total(const float* red) {
  const int n = threadIdx.x;
  return n < TILE ? __fadd_rn(__fadd_rn(__fadd_rn(red[n], red[TILE + n]),
                                        red[2 * TILE + n]),
                              red[3 * TILE + n])
                  : 0.f;
}

// The per-position vectors of the backward, (b, s, nh) fp32 each; rowp
// holds one (b, s, nh) plane of row sums per column tile.
struct Vecs {
  float *dsd, *dE, *colsum, *ddti, *rowp;
};

// (1) The reverse pass of a (batch, head).  First every chunk's cumsum (a
// thread a chunk, in order); then from the last chunk to the first: gs =
// (dy r(exp(cums)))^T C on the tensor cores (the operand a product of two
// bf16 values: hi and lo), g, the cotangent of the state after chunk c,
// written out, dG[c] = sum g * S_c in a fixed tree, g <- g r(exp(seg)) +
// gs.  g lives in shared memory; the tiles of (hd, ns) are one stream of
// products, each one's loads issued during the one before.
template <typename T, bool TM>
__global__ void __launch_bounds__(THREADS, 2)
carry_kernel(const float* __restrict__ dt, const float* __restrict__ A,
             const T* __restrict__ dy, const T* __restrict__ C,
             const T* __restrict__ states, const T* __restrict__ dfinal,
             Dims d, float* __restrict__ cums, float* __restrict__ gc,
             float* __restrict__ dG, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* planes = smem;
  using R = Ring<CARRY_STAGES, Stage2<T>::SAME, Prec<T>::CARRY_BUF, CARRY_NB>;
  unsigned char* ring = smem + R::NB * R::BUF;
  float* ef = reinterpret_cast<float*>(ring + R::S * R::STAGE);
  float* g = ef + 2 * MAX_CHUNK;                              // [hd * ns]
  float* red = g + MAX_STATE;                                 // [THREADS]
  Ctx cx{planes, ring, R::NB * R::BUF, {}};
  if constexpr (TM) cx.tm = tma_init(reinterpret_cast<unsigned char*>(
                        red + THREADS));                      // [TMA_STAGES]
  const int tid = threadIdx.x, bh = blockIdx.x, bb = bh / d.nh, h = bh % d.nh;
  const int hn = d.hd * d.ns;
  const int tp = (d.hd + TILE - 1) / TILE, tn = (d.ns + TILE - 1) / TILE;
  const float a = A[h];
  for (int c = tid; c < d.nc; c += THREADS) {
    float acc = 0.f;
    for (int j = 0; j < d.lc; ++j) {
      const size_t v = row(d, bb, c * d.lc + j) * d.nh + h;
      acc = __fadd_rn(acc, __fmul_rn(dt[v], a));
      cums[v] = acc;
    }
  }
  for (int e = tid; e < hn; e += THREADS)
    g[e] = dfinal != nullptr ? ld(dfinal, static_cast<size_t>(bh) * hn + e)
                             : 0.f;
  // task t: chunk nc - 1 - t / (tp tn), tile (t % (tp tn)) of (hd, ns)
  auto prod = [&](int t) {
    const int c = d.nc - 1 - t / (tp * tn), tile = t % (tp * tn);
    const size_t r0 = row(d, bb, c * d.lc);
    const float* e = ef + (c & 1) * MAX_CHUNK;
    const int p0 = (tile / tn) * TILE, n0 = (tile % tn) * TILE;
    auto xa = reg([=](int i, int, float v, int) { return __fmul_rn(v, e[i]); });
    if constexpr (TM)
      return tgemm<A_RAW_MN, 2>(
          p0, n0, d.hd, d.ns, 0, d.lc,
          Src{&maps.dyMN, h * d.hd + p0, static_cast<int>(r0)},
          Src{&maps.CMN, n0, static_cast<int>(r0)}, xa);
    else
      return gemm<Prec<T>::TT, 2, Prec<T>::PT, false, false, T, T, R>(
          p0, n0, d.hd, d.ns, 0, d.lc,
          [=](int i, int p) {
            return dy + ((r0 + i) * d.nh + h) * d.hd + p;
          },
          xa, [=](int i, int n) { return C + (r0 + i) * d.ns + n; }, Same());
  };
  const int tasks = d.nc * tp * tn;
  __syncthreads();
  prod(0).prologue(cx);
  float part = 0.f;
  for (int t = 0; t < tasks; ++t) {
    const int c = d.nc - 1 - t / (tp * tn), tile = t % (tp * tn);
    const int p0 = (tile / tn) * TILE, n0 = (tile % tn) * TILE;
    const size_t r0 = row(d, bb, c * d.lc);
    if (tile == 0) {
      for (int i = tid; i < d.lc; i += THREADS)
        ef[(c & 1) * MAX_CHUNK + i] = rnd<T>(expf(cums[(r0 + i) * d.nh + h]));
      part = 0.f;
    }
    const float gr = rnd<T>(expf(cums[(r0 + d.lc - 1) * d.nh + h]));
    const size_t base = state_base(d, c, bb, h);
    float sv[16];
    each_mma(p0, n0, d.hd, d.ns, [&](int q, int p, int n) {
      sv[q] = ld(states, base + static_cast<size_t>(p) * d.ns + n);
    });
    float acc[16];
    zero16(acc);
    prod(t).run(acc, cx);
    if (t + 1 < tasks) prod(t + 1).prologue(cx);
    each_mma(p0, n0, d.hd, d.ns, [&](int q, int p, int n) {
      const int e = p * d.ns + n;
      const float gold = g[e];
      gc[base + e] = gold;
      part = fmaf(gold, sv[q], part);
      g[e] = __fadd_rn(__fmul_rn(gold, gr), acc[q]);
    });
    if (tile == tp * tn - 1) {
      red[tid] = part;
      __syncthreads();
      for (int half = THREADS / 2; half > 0; half >>= 1) {
        if (tid < half) red[tid] = __fadd_rn(red[tid], red[tid + half]);
        __syncthreads();
      }
      if (tid == 0)
        dG[(static_cast<size_t>(c) * d.b + bb) * d.nh + h] = red[0];
    }
  }
}

// (2) A pair of 64-column tiles J of a chunk (J and the one as far from
// the end: an even load), for a group of heads [h0, h1).  For each J:
// (a) the scores' strip r(C_I . B_J), I >= J, in shared memory.  (b) Each
// tile dL_IJ = dy_I . x_J^T once a head; in its epilogue, with L = (cb e)
// dt_j and e = exp(cums_i - cums_j) on and below the diagonal: dcb = (dL
// e) dt_j summed over the group's heads in registers and written once a
// tile; dL L summed over the tile's columns (a plane of rowp) and over its
// rows, and (dL cb) e over its rows (ddt's score part), both summed over I
// in shared memory.  (c) Each head's dx for the rows J: sdecay (B_J . g^T)
// (3xTF32 on g), its row sum with x (d sdecay), then + r(L_IJ)^T dy_I for
// each I >= J in the same accumulator, rounded once.  (d) d exp(cums) for
// the rows J: sum_p dy r(C . S^T).  Each phase is one stream of products,
// the next one's loads and the next head's cums issued during the one
// before.
template <typename T, bool TM>
__global__ void __launch_bounds__(THREADS, 2)
heads_kernel(const float* __restrict__ dt, const T* __restrict__ X,
             const T* __restrict__ B, const T* __restrict__ C,
             const T* __restrict__ dy, const T* __restrict__ states,
             const float* __restrict__ cums, const float* __restrict__ gc,
             Dims d, int gsize, Vecs vec, float* __restrict__ dcbp,
             T* __restrict__ dxh, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  using S = Ring<HEADS_STAGES, Stage2<T>::MIXED, Prec<T>::BUF, HEADS_NB>;
  unsigned char* planes = smem;
  unsigned char* ring = smem + S::NB * S::BUF;
  T* strip = reinterpret_cast<T*>(ring + S::S * S::STAGE);  // [lc][SP]
  float* cub = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(strip) +
      (d.lc * SP * sizeof(T) + 15) / 16 * 16);              // [2][MAX_CHUNK]
  float* dtb = cub + 2 * MAX_CHUNK;                         // [2][MAX_CHUNK]
  float* red = dtb + 2 * MAX_CHUNK;                         // [10][TILE]
  float* colacc = red + 10 * TILE;                          // [G_MAX][TILE]
  float* ddtacc = colacc + G_MAX * TILE;                    // [G_MAX][TILE]
  float* vacc = ddtacc + G_MAX * TILE;                      // [TILE]
  Ctx cx{planes, ring, S::NB * S::BUF, {}};
  if constexpr (TM) cx.tm = tma_init(reinterpret_cast<unsigned char*>(
                        vacc + TILE));                        // [TMA_STAGES]
  const int tid = threadIdx.x, c = blockIdx.y;
  const int ngroups = (d.nh + gsize - 1) / gsize;
  const int bb = blockIdx.z / ngroups, grp = blockIdx.z % ngroups;
  const int h0 = grp * gsize, h1 = min(d.nh, h0 + gsize), gh = h1 - h0;
  const int nt = (d.lc + TILE - 1) / TILE, tp = (d.hd + TILE - 1) / TILE;
  const size_t r0 = row(d, bb, c * d.lc);
  const size_t n1 = static_cast<size_t>(d.b) * d.s * d.nh;
  constexpr int TT = Prec<T>::TT, PT = Prec<T>::PT;
  auto at = [=](int pos, int h) { return (r0 + pos) * d.nh + h; };
  auto xo = [=](int pos, int h, int p) {
    return ((r0 + pos) * d.nh + h) * d.hd + p;
  };
  // a head's cums and dt over the chunk: loaded into registers (a thread a
  // position) during the product before, stored to slot `sl` before the
  // product that needs them
  float pcu = 0.f, pdt = 0.f;
  auto pre_head = [&](int h) {
    if (tid < d.lc) {
      pcu = cums[at(tid, h)];
      pdt = dt[at(tid, h)];
    }
  };
  auto put_head = [&](int sl) {
    if (tid < d.lc) {
      cub[sl * MAX_CHUNK + tid] = pcu;
      dtb[sl * MAX_CHUNK + tid] = pdt;
    }
  };
  float acc[16], dcb[16];
  for (int side = 0; side < 2; ++side) {
    const int jt = side == 0 ? blockIdx.x : nt - 1 - blockIdx.x;
    if (side == 1 && jt == static_cast<int>(blockIdx.x)) break;
    const int J0 = jt * TILE, jend = min(d.lc, J0 + TILE), cols = jend - J0;
    const int ni = nt - jt;                    // the I tiles >= J
    auto cb_at = [=](int i, int j) {
      return ld(strip, static_cast<size_t>(i - J0) * SP + (j - J0));
    };
    // (a) the scores' strip
    auto prod_a = [&](int it) {
      if constexpr (TM)
        return tgemm<A_K, 1>(
            J0 + it * TILE, J0, d.lc, jend, 0, d.ns,
            Src{&maps.CK, 0, static_cast<int>(r0) + J0 + it * TILE},
            Src{&maps.BK, 0, static_cast<int>(r0) + J0}, NoX());
      else
        return gemm<TT, PT, PT, true, true, T, T, S>(
            J0 + it * TILE, J0, d.lc, jend, 0, d.ns,
            [=](int n, int i) { return C + (r0 + i) * d.ns + n; }, Same(),
            [=](int n, int j) { return B + (r0 + j) * d.ns + n; }, Same());
    };
    __syncthreads();
    prod_a(0).prologue(cx);
    for (int it = 0; it < ni; ++it) {
      zero16(acc);
      prod_a(it).run(acc, cx);
      if (it + 1 < ni) prod_a(it + 1).prologue(cx);
      each_mma(J0 + it * TILE, J0, d.lc, jend, [&](int q, int i, int j) {
        strip[static_cast<size_t>(i - J0) * SP + (j - J0)] = to_t<T>(acc[q]);
      });
    }
    // (b) dL once a tile: task (I, head) = (it, hh), heads inner
    for (int e = tid; e < G_MAX * TILE; e += THREADS)
      colacc[e] = ddtacc[e] = 0.f;
    auto prod_b = [&](int task) {
      const int I0 = J0 + (task / gh) * TILE, h = h0 + task % gh;
      if constexpr (TM)
        return tgemm<A_K, 1>(
            I0, J0, d.lc, jend, 0, d.hd,
            Src{&maps.dyK, h * d.hd, static_cast<int>(r0) + I0},
            Src{&maps.xK, h * d.hd, static_cast<int>(r0) + J0}, NoX());
      else
        return gemm<TT, PT, PT, true, true, T, T, S>(
            I0, J0, d.lc, jend, 0, d.hd,
            [=](int p, int i) { return dy + xo(i, h, p); }, Same(),
            [=](int p, int j) { return X + xo(j, h, p); }, Same());
    };
    const int tasks_b = ni * gh;
    pre_head(h0);
    prod_b(0).prologue(cx);
    zero16(dcb);
    for (int task = 0; task < tasks_b; ++task) {
      const int I0 = J0 + (task / gh) * TILE, h = h0 + task % gh;
      const int sl = task & 1;
      put_head(sl);
      if (task + 1 < tasks_b) pre_head(h0 + (task + 1) % gh);
      zero16(acc);
      prod_b(task).run(acc, cx);
      if (task + 1 < tasks_b) prod_b(task + 1).prologue(cx);
      const float* cu = cub + sl * MAX_CHUNK;
      const float* dts = dtb + sl * MAX_CHUNK;
      float vr[16], vd[16];
      zero16(vr);
      zero16(vd);
      each_mma(I0, J0, d.lc, jend, [&](int q, int i, int j) {
        if (j <= i) {
          const float cbv = cb_at(i, j), e = expf(cu[i] - cu[j]);
          const float L = __fmul_rn(__fmul_rn(cbv, e), dts[j]);
          dcb[q] = __fadd_rn(dcb[q], __fmul_rn(__fmul_rn(acc[q], e), dts[j]));
          vr[q] = __fmul_rn(acc[q], L);
          vd[q] = __fmul_rn(__fmul_rn(acc[q], cbv), e);
        }
      });
      row_parts(vr, red);
      col_parts(vr, red + 2 * TILE);
      col_parts(vd, red + 6 * TILE);
      __syncthreads();
      const float rs = row_total(red), cs = col_total(red + 2 * TILE),
                  ds = col_total(red + 6 * TILE);
      if (tid < min(TILE, d.lc - I0))
        vec.rowp[jt * n1 + at(I0 + tid, h)] = rs;
      if (tid < cols) {
        float* ca = colacc + (h - h0) * TILE + tid;
        float* da = ddtacc + (h - h0) * TILE + tid;
        *ca = __fadd_rn(*ca, cs);
        *da = __fadd_rn(*da, ds);
      }
      if (h == h1 - 1) {
        float* out = dcbp + ((static_cast<size_t>(grp) * d.nc + c) * d.b +
                             bb) * d.lc * d.lc;
        each_mma(I0, J0, d.lc, jend, [&](int q, int i, int j) {
          out[static_cast<size_t>(i) * d.lc + j] = dcb[q];
        });
        zero16(dcb);
      }
    }
    if (tid < cols)
      for (int h = h0; h < h1; ++h) {
        vec.colsum[at(J0 + tid, h)] = colacc[(h - h0) * TILE + tid];
        vec.ddti[at(J0 + tid, h)] = ddtacc[(h - h0) * TILE + tid];
      }
    // (c) dx and d sdecay for the rows J: task (head, p tile) = two
    // products, dU = B_J . g^T (k over ns) and r(L)^T dy (k over i >= J)
    auto prod_c1 = [&](int task) {
      const int h = h0 + task / tp, p0 = (task % tp) * TILE;
      const float* G = gc + state_base(d, c, bb, h);
      return gemm<TF, PT, 2, true, true, T, float, S>(
          J0, p0, jend, d.hd, 0, d.ns,
          [=](int n, int j) { return B + (r0 + j) * d.ns + n; }, Same(),
          [=](int n, int p) { return G + static_cast<size_t>(p) * d.ns + n; },
          Same());
    };
    auto prod_c2 = [&](int task, const float* cu, const float* dts) {
      const int h = h0 + task / tp, p0 = (task % tp) * TILE;
      auto xa = reg([=](int i, int j, float, int) {
        return masked_score<T>(i, j, cb_at, cu, dts);
      });
      if constexpr (TM)
        return tgemm<A_COMPUTED, 1>(
            J0, p0, jend, d.hd, J0, d.lc, Src{nullptr, 0, 0},
            Src{&maps.dyMN, h * d.hd + p0, static_cast<int>(r0) + J0}, xa);
      else
        return gemm<TT, PT, PT, false, false, Computed, T, S>(
            J0, p0, jend, d.hd, J0, d.lc, Nowhere(), xa,
            [=](int i, int p) { return dy + xo(i, h, p); }, Same());
    };
    const int tasks_c = gh * tp;
    pre_head(h0);
    __syncthreads();
    prod_c1(0).prologue(cx);
    for (int task = 0; task < tasks_c; ++task) {
      const int h = h0 + task / tp, p0 = (task % tp) * TILE;
      const int sl = task & 1;
      put_head(sl);
      if (task + 1 < tasks_c) pre_head(h0 + (task + 1) / tp);
      const float* cu = cub + sl * MAX_CHUNK;
      const float* dts = dtb + sl * MAX_CHUNK;
      zero16(acc);
      prod_c1(task).run(acc, cx);
      prod_c2(task, cu, dts).prologue(cx);
      float vr[16];
      zero16(vr);
      each_mma(J0, p0, jend, d.hd, [&](int q, int j, int p) {
        vr[q] = __fmul_rn(ld(X, xo(j, h, p)), acc[q]);
        acc[q] = __fmul_rn(
            rnd<T>(__fmul_rn(expf(cu[d.lc - 1] - cu[j]), dts[j])), acc[q]);
      });
      row_parts(vr, red);
      __syncthreads();
      const float rs = row_total(red);
      if (tid < cols) vacc[tid] = p0 == 0 ? rs : __fadd_rn(vacc[tid], rs);
      prod_c2(task, cu, dts).run(acc, cx);
      if (task + 1 < tasks_c) prod_c1(task + 1).prologue(cx);
      each_mma(J0, p0, jend, d.hd, [&](int q, int j, int p) {
        dxh[xo(j, h, p)] = to_t<T>(acc[q]);
      });
      if (p0 + TILE >= d.hd && tid < cols) vec.dsd[at(J0 + tid, h)] = vacc[tid];
    }
    // (d) d exp(cums) for the rows J: task (head, p tile)
    auto prod_d = [&](int task) {
      const int h = h0 + task / tp, p0 = (task % tp) * TILE;
      const T* S_ = states + state_base(d, c, bb, h);
      if constexpr (TM)
        return tgemm<A_K, 1>(
            J0, p0, jend, d.hd, 0, d.ns,
            Src{&maps.CK, 0, static_cast<int>(r0) + J0},
            Src{&maps.SK, 0, ((c * d.b + bb) * d.nh + h) * d.hd + p0},
            NoX());
      else
        return gemm<TT, PT, PT, true, true, T, T, S>(
            J0, p0, jend, d.hd, 0, d.ns,
            [=](int n, int i) { return C + (r0 + i) * d.ns + n; }, Same(),
            [=](int n, int p) {
              return S_ + static_cast<size_t>(p) * d.ns + n;
            },
            Same());
    };
    __syncthreads();
    prod_d(0).prologue(cx);
    for (int task = 0; task < tasks_c; ++task) {
      const int h = h0 + task / tp, p0 = (task % tp) * TILE;
      zero16(acc);
      prod_d(task).run(acc, cx);
      if (task + 1 < tasks_c) prod_d(task + 1).prologue(cx);
      float vr[16];
      zero16(vr);
      each_mma(J0, p0, jend, d.hd, [&](int q, int i, int p) {
        vr[q] = __fmul_rn(ld(dy, xo(i, h, p)), rnd<T>(acc[q]));
      });
      row_parts(vr, red);
      __syncthreads();
      const float rs = row_total(red);
      if (tid < cols) vacc[tid] = p0 == 0 ? rs : __fadd_rn(vacc[tid], rs);
      if (p0 + TILE >= d.hd && tid < cols) vec.dE[at(J0 + tid, h)] = vacc[tid];
    }
  }
}

// (3) A (batch, chunk, head): the exponents' cotangents in parallel, then
// one thread the sum of d sdecay's part of seg (in order) and cums' reverse
// cumsum (in order) into ddt and dA's partial.  With more than one group
// of heads, the blocks of a (batch, chunk) also fold the groups' dcb into
// the first group's plane, in group order, each a share of the chunk.
__global__ void __launch_bounds__(FIN)
finish_kernel(const float* __restrict__ dt, const float* __restrict__ A,
              const float* __restrict__ cums, const float* __restrict__ dG,
              Dims d, Vecs vec, int ngroups, float* __restrict__ dcbp,
              float* __restrict__ ddt, float* __restrict__ da_part) {
  __shared__ float base[MAX_CHUNK], qv[MAX_CHUNK], sv[MAX_CHUNK],
      dsd[MAX_CHUNK], dtv[MAX_CHUNK];
  const int h = blockIdx.x % d.nh, bc = blockIdx.x / d.nh;
  const int c = bc % d.nc, bb = bc / d.nc;
  const size_t r0 = row(d, bb, c * d.lc);
  const size_t n1 = static_cast<size_t>(d.b) * d.s * d.nh;
  if (ngroups > 1) {
    const size_t lc2 = static_cast<size_t>(d.lc) * d.lc;
    const size_t plane = static_cast<size_t>(d.nc) * d.b * lc2;
    float* p = dcbp + (static_cast<size_t>(c) * d.b + bb) * lc2;
    if (lc2 % 4 == 0) {                      // four at a time
      float4* p4 = reinterpret_cast<float4*>(p);
      const size_t n4 = lc2 / 4, per = (n4 + d.nh - 1) / d.nh;
      const size_t e1 = min(n4, (h + 1) * per);
      for (size_t e = h * per + threadIdx.x; e < e1; e += FIN) {
        float4 s = p4[e];
        for (int k = 1; k < ngroups; ++k) {
          const float4 w = p4[k * plane / 4 + e];
          s = make_float4(__fadd_rn(s.x, w.x), __fadd_rn(s.y, w.y),
                          __fadd_rn(s.z, w.z), __fadd_rn(s.w, w.w));
        }
        p4[e] = s;
      }
    } else {
      const size_t per = (lc2 + d.nh - 1) / d.nh;
      const size_t e1 = min(lc2, (h + 1) * per);
      for (size_t e = h * per + threadIdx.x; e < e1; e += FIN) {
        float s = p[e];
        for (int k = 1; k < ngroups; ++k) s = __fadd_rn(s, p[k * plane + e]);
        p[e] = s;
      }
    }
  }
  const float seg = cums[(r0 + d.lc - 1) * d.nh + h];
  for (int i = threadIdx.x; i < d.lc; i += FIN) {
    const size_t v = (r0 + i) * d.nh + h;
    float rowsum = 0.f;
    for (int jt = 0; jt <= i / TILE; ++jt)
      rowsum = __fadd_rn(rowsum, vec.rowp[jt * n1 + v]);
    const float e = expf(seg - cums[v]);
    float dc = __fsub_rn(rowsum, vec.colsum[v]);
    dc = __fadd_rn(dc, __fmul_rn(vec.dE[v], expf(cums[v])));
    dc = __fsub_rn(dc, __fmul_rn(vec.dsd[v], __fmul_rn(e, dt[v])));
    base[i] = dc;
    qv[i] = __fadd_rn(vec.ddti[v], __fmul_rn(vec.dsd[v], e));
    sv[i] = __fmul_rn(e, dt[v]);
    dsd[i] = vec.dsd[v];
    dtv[i] = dt[v];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float sum = 0.f;
  for (int j = 0; j < d.lc; ++j) sum = fmaf(dsd[j], sv[j], sum);
  const float dseg = __fadd_rn(
      __fmul_rn(dG[(static_cast<size_t>(c) * d.b + bb) * d.nh + h], expf(seg)),
      sum);
  const float a = A[h];
  float da = 0.f, dA = 0.f;
  for (int i = d.lc - 1; i >= 0; --i) {
    const float dc = i == d.lc - 1 ? __fadd_rn(base[i], dseg) : base[i];
    da = __fadd_rn(da, dc);
    ddt[(r0 + i) * d.nh + h] = __fadd_rn(qv[i], __fmul_rn(da, a));
    dA = fmaf(da, dtv[i], dA);
  }
  da_part[(static_cast<size_t>(bb) * d.nc + c) * d.nh + h] = dA;
}

// (4) 64 rows T and 64 columns of ns of a chunk: dB = sum_h U_h g_h +
// dcb^T C and dC = sum_h dQ_h S_h + dcb B, each in one accumulator over
// every head (one product whose k runs over (head, p)), rounded once to T.
// The first block also sums dA's partials in (batch, chunk) order.
template <typename T, bool TM>
__global__ void __launch_bounds__(THREADS, 2)
sums_kernel(const float* __restrict__ dt, const T* __restrict__ X,
            const T* __restrict__ B, const T* __restrict__ C,
            const T* __restrict__ dy, const T* __restrict__ states,
            const float* __restrict__ cums, const float* __restrict__ gc,
            const float* __restrict__ dcbp,
            const float* __restrict__ da_part, Dims d, T* __restrict__ dB,
            T* __restrict__ dC, float* __restrict__ dA,
            const __grid_constant__ Maps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  using S = Ring<SUMS_STAGES, Stage2<T>::MIXED, Prec<T>::BUF, SUMS_NB>;
  unsigned char* planes = smem;
  unsigned char* ring = smem + S::NB * S::BUF;
  float* tab = reinterpret_cast<float*>(ring + S::S * S::STAGE);
  // [SUMS_HEADS][TILE]
  Ctx cx{planes, ring, S::NB * S::BUF, {}};
  if constexpr (TM) cx.tm = tma_init(reinterpret_cast<unsigned char*>(
                        tab + SUMS_HEADS * TILE));            // [TMA_STAGES]
  const int tid = threadIdx.x, T0 = blockIdx.x * TILE, n0 = blockIdx.y * TILE;
  const int c = blockIdx.z % d.nc, bb = blockIdx.z / d.nc;
  const int tend = min(d.lc, T0 + TILE), rows = tend - T0;
  const size_t r0 = row(d, bb, c * d.lc);
  const float* dcb = dcbp + (static_cast<size_t>(c) * d.b + bb) * d.lc * d.lc;
  const bool whole = d.hd % 8 == 0;          // a run of eight stays in a head
  constexpr int TT = Prec<T>::TT, PT = Prec<T>::PT;
  auto xo = [=](int pos, int h, int p) {
    return ((r0 + pos) * d.nh + h) * d.hd + p;
  };
  // dB's state part, U_h g_h: k = (h, p), SUMS_HEADS heads at a time;
  // tab[h - hb][j] = r(sdecay_j) of head h
  float acc[16];
  zero16(acc);
  for (int hb = 0; hb < d.nh; hb += SUMS_HEADS) {
    const int he = min(d.nh, hb + SUMS_HEADS);
    __syncthreads();
    for (int e = tid; e < (he - hb) * rows; e += THREADS) {
      const int h = hb + e / rows, r = e % rows;
      const size_t v = (r0 + T0 + r) * d.nh + h;
      tab[(h - hb) * TILE + r] = rnd<T>(__fmul_rn(
          expf(cums[(r0 + d.lc - 1) * d.nh + h] - cums[v]), dt[v]));
    }
    auto prod_u = gemm<TF, PT, 2, true, false, T, float, S>(
        T0, n0, tend, d.ns, hb * d.hd, he * d.hd,
        [=](int k, int j) { return X + xo(j, k / d.hd, k % d.hd); },
        reg([=](int k, int j, float v, int q) {
          const int h = q >= 0 ? q : k / d.hd;
          return rnd<T>(__fmul_rn(tab[(h - hb) * TILE + j - T0], v));
        }, d.hd % 8 == 0 ? d.hd : 0),
        [=](int k, int n) {
          return gc + state_base(d, c, bb, k / d.hd) +
                 static_cast<size_t>(k % d.hd) * d.ns + n;
        },
        Same(), whole);
    prod_u.prologue(cx);
    prod_u.run(acc, cx);
  }
  auto prod_bi = gemm<TF, 2, PT, false, false, float, T, S>(  // + dcb^T C
      T0, n0, tend, d.ns, T0, d.lc,
      [=](int i, int j) { return dcb + static_cast<size_t>(i) * d.lc + j; },
      Same(), [=](int i, int n) { return C + (r0 + i) * d.ns + n; }, Same());
  prod_bi.prologue(cx);
  prod_bi.run(acc, cx);
  each_mma(T0, n0, tend, d.ns, [&](int q, int j, int n) {
    dB[(r0 + j) * d.ns + n] = to_t<T>(acc[q]);
  });
  // dC's inter part, dQ_h S_h: k = (h, p), SUMS_HEADS heads at a time;
  // tab[h - hb][i] = r(exp(cums_i)) of head h
  zero16(acc);
  for (int hb = 0; hb < d.nh; hb += SUMS_HEADS) {
    const int he = min(d.nh, hb + SUMS_HEADS);
    __syncthreads();
    for (int e = tid; e < (he - hb) * rows; e += THREADS) {
      const int h = hb + e / rows, r = e % rows;
      tab[(h - hb) * TILE + r] = rnd<T>(expf(cums[(r0 + T0 + r) * d.nh + h]));
    }
    auto xq = reg([=](int k, int i, float v, int q) {
      const int h = q >= 0 ? q : k / d.hd;
      return __fmul_rn(v, tab[(h - hb) * TILE + i - T0]);
    }, d.hd % (Prec<T>::TT == BF ? 16 : 8) == 0 ? d.hd : 0);
    auto go = [&](const auto& prod) {
      prod.prologue(cx);
      prod.run(acc, cx);
    };
    if constexpr (TM)
      go(tgemm<A_RAW_K, 2>(
          T0, n0, tend, d.ns, hb * d.hd, he * d.hd,
          Src{&maps.dyK, hb * d.hd, static_cast<int>(r0) + T0},
          Src{&maps.SMN, n0, (c * d.b + bb) * d.nh * d.hd + hb * d.hd}, xq));
    else
      go(gemm<TT, 2, PT, true, false, T, T, S>(
          T0, n0, tend, d.ns, hb * d.hd, he * d.hd,
          [=](int k, int i) { return dy + xo(i, k / d.hd, k % d.hd); }, xq,
          [=](int k, int n) {
            return states + state_base(d, c, bb, k / d.hd) +
                   static_cast<size_t>(k % d.hd) * d.ns + n;
          },
          Same(), whole));
  }
  auto prod_ci = gemm<TF, 2, PT, true, false, float, T, S>(   // + dcb B
      T0, n0, tend, d.ns, 0, tend,
      [=](int j, int i) { return dcb + static_cast<size_t>(i) * d.lc + j; },
      Same(), [=](int j, int n) { return B + (r0 + j) * d.ns + n; }, Same());
  prod_ci.prologue(cx);
  prod_ci.run(acc, cx);
  each_mma(T0, n0, tend, d.ns, [&](int q, int i, int n) {
    dC[(r0 + i) * d.ns + n] = to_t<T>(acc[q]);
  });
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    for (int h = tid; h < d.nh; h += THREADS) {
      float s = 0.f;
      for (int bc = 0; bc < d.b * d.nc; ++bc)
        s = __fadd_rn(s, da_part[static_cast<size_t>(bc) * d.nh + h]);
      dA[h] = s;
    }
}

// --------------------------------------------------------------- step
// One decode step.  A block takes STEP_WARPS x (32 / lanes) rows p of one
// (batch, head); a row's ns values split into chunks of V (a 16-byte
// vector), lane l of the row's `lanes` taking chunks l, l + lanes, ...:
// the state updated in place elementwise, and the row's readout summed in
// fixed order, each lane its chunks' products in order, then the lanes by
// shuffles in a butterfly (offsets lanes / 2, ..., 1).  The blocks past
// `state_blocks` shift the conv window.  VEC: every row of the state, B, C
// and the conv window a whole number of aligned 16-byte vectors.
template <typename T, bool VEC>
__global__ void __launch_bounds__(STEP_THREADS)
step_kernel(T* __restrict__ state, T* __restrict__ conv,
            const T* __restrict__ window, const T* __restrict__ xh,
            const float* __restrict__ dtv, const float* __restrict__ A,
            const T* __restrict__ Bv, const T* __restrict__ Cv, int nh,
            int hd, int ns, int lanes, int row_blocks, int state_blocks,
            long long conv_per, int width, long long conv_total,
            T* __restrict__ y) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < state_blocks) {
    const int bh = blockIdx.x / row_blocks, rb = blockIdx.x % row_blocks;
    const int bb = bh / nh, h = bh % nh;
    const int lane = tid & 31, per_warp = 32 / lanes, sub = lane & (lanes - 1);
    const int p = (rb * STEP_WARPS + (tid >> 5)) * per_warp + lane / lanes;
    float acc = 0.f;
    if (p < hd) {
      const float dv = dtv[bh];
      const float da = rnd<T>(expf(__fmul_rn(dv, A[h])));
      const float xd = rnd<T>(__fmul_rn(
          ld(xh, static_cast<size_t>(bh) * hd + p), rnd<T>(dv)));
      T* sp = state + (static_cast<size_t>(bh) * hd + p) * ns;
      const T* bp = Bv + static_cast<size_t>(bb) * ns;
      const T* cp = Cv + static_cast<size_t>(bb) * ns;
      for (int n0 = sub * V; n0 < ns; n0 += lanes * V) {
        alignas(16) T sv[V], bv[V], cv[V];
        const int m = VEC ? V : (ns - n0 < V ? ns - n0 : V);
        if constexpr (VEC) {
          *reinterpret_cast<uint4*>(sv) = *reinterpret_cast<const uint4*>(sp + n0);
          *reinterpret_cast<uint4*>(bv) = *reinterpret_cast<const uint4*>(bp + n0);
          *reinterpret_cast<uint4*>(cv) = *reinterpret_cast<const uint4*>(cp + n0);
        } else {
          for (int q = 0; q < m; ++q) {
            sv[q] = sp[n0 + q];
            bv[q] = bp[n0 + q];
            cv[q] = cp[n0 + q];
          }
        }
#pragma unroll
        for (int q = 0; q < V; ++q) {
          if (q < m) {
            const float u = rnd<T>(__fmul_rn(xd, ld(bv, q)));
            const float sn = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(ld(sv, q), da)), u));
            sv[q] = to_t<T>(sn);
            acc = __fadd_rn(acc, __fmul_rn(ld(cv, q), sn));
          }
        }
        if constexpr (VEC) {
          *reinterpret_cast<uint4*>(sp + n0) = *reinterpret_cast<const uint4*>(sv);
        } else {
          for (int q = 0; q < m; ++q) sp[n0 + q] = sv[q];
        }
      }
    }
    for (int o = lanes / 2; o >= 1; o >>= 1)   // every lane, live or not
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    if (p < hd && sub == 0) y[static_cast<size_t>(bh) * hd + p] = to_t<T>(acc);
    return;
  }
  // the conv window's shift: conv[b2, r, :] = window[b2, r + 1, :], in
  // 16-byte vectors where VEC, CONV_UNROLL loads in flight before the stores
  using U = typename std::conditional<VEC, uint4, T>::type;
  const int w = VEC ? V : 1;
  const long long per = conv_per / w, row = width / w, total = conv_total / w;
  const U* src = reinterpret_cast<const U*>(window);
  U* dst = reinterpret_cast<U*>(conv);
  const long long stride =
      static_cast<long long>(gridDim.x - state_blocks) * STEP_THREADS * CONV_UNROLL;
  for (long long e0 = (static_cast<long long>(blockIdx.x) - state_blocks) *
                          STEP_THREADS * CONV_UNROLL + tid;
       e0 < total; e0 += stride) {
    U v[CONV_UNROLL];
#pragma unroll
    for (int u = 0; u < CONV_UNROLL; ++u) {
      const long long e = e0 + static_cast<long long>(u) * STEP_THREADS;
      if (e < total) {
        const long long b2 = e / per;
        v[u] = src[b2 * (per + row) + row + (e - b2 * per)];
      }
    }
#pragma unroll
    for (int u = 0; u < CONV_UNROLL; ++u) {
      const long long e = e0 + static_cast<long long>(u) * STEP_THREADS;
      if (e < total) dst[e] = v[u];
    }
  }
}

__global__ void empty_kernel(int) {}


// ------------------------------------------------------------ launches
struct Launch {
  dim3 grid;
  int threads;
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

// The heads a group of the heads kernel: as many as keep about
// GROUP_BLOCKS blocks, at most G_MAX and nh.  Fixed by the shapes alone, so
// the order of every sum is.
int group_size(const Dims& d) {
  long long g = static_cast<long long>(div_up(div_up(d.lc, TILE), 2)) * d.nc *
                d.b * d.nh / GROUP_BLOCKS;
  if (g < div_up(d.nh, GROUPS_AIM)) g = div_up(d.nh, GROUPS_AIM);
  if (g > G_MAX) g = G_MAX;
  if (g > d.nh) g = d.nh;
  return g < 1 ? 1 : static_cast<int>(g);
}
int groups(const Dims& d) { return div_up(d.nh, group_size(d)); }

// The state kernel's blocks a (batch, head): one a 64 x 64 tile of the
// state.
int state_tiles(const Dims& d) {
  return div_up(d.hd, TILE) * div_up(d.ns, TILE);
}

// The workspace of an entry in floats, carved in this order:
// scan: the cums; scan_grad:
// cums, the state cotangents gc, dG, the vectors (dsd, dE, colsum, ddti,
// then a plane of row sums a column tile), the groups' dcb, dA's partials.
struct Work {
  float *cums, *gc, *dG, *vec, *dcbp, *da_part;
  size_t floats;
};

Work carve(const Dims& d, int dtype, int entry, float* base) {
  const size_t n1 = static_cast<size_t>(d.b) * d.s * d.nh;
  const size_t hn = static_cast<size_t>(d.hd) * d.ns;
  const size_t bcn = static_cast<size_t>(d.b) * d.nc;
  const size_t lc2 = static_cast<size_t>(d.lc) * d.lc;
  size_t sizes[7] = {};
  float** slots[7] = {};
  Work w{};
  int used = 0;
  if (entry == SCAN) {
    sizes[0] = up4(n1);
    slots[0] = &w.cums;
    used = 1;
  } else {
    sizes[0] = up4(n1);
    sizes[1] = up4(bcn * d.nh * hn);
    sizes[2] = up4(bcn * d.nh);
    sizes[3] = up4((4 + div_up(d.lc, TILE)) * n1);
    sizes[4] = up4(groups(d) * bcn * lc2);
    sizes[5] = up4(bcn * d.nh);
    float** s[6] = {&w.cums, &w.gc, &w.dG, &w.vec, &w.dcbp, &w.da_part};
    for (int k = 0; k < 6; ++k) slots[k] = s[k];
    used = 6;
  }
  size_t at = 0;
  for (int k = 0; k < used; ++k) {
    *slots[k] = base == nullptr ? nullptr : base + at;
    at += sizes[k];
  }
  w.floats = at;
  return w;
}

size_t buf_bytes(size_t el) {
  return el == 2 ? Prec<BF16>::BUF : Prec<float>::BUF;
}
size_t carry_smem(size_t el) {
  return CARRY_NB * (el == 2 ? Prec<BF16>::CARRY_BUF : Prec<float>::CARRY_BUF) +
         CARRY_STAGES * THREADS * 8 * 2 * el +
         sizeof(float) * (2 * MAX_CHUNK + MAX_STATE + THREADS) +
         8 * TMA_STAGES;
}
size_t heads_smem(const Dims& d, size_t el) {
  return HEADS_NB * buf_bytes(el) + HEADS_STAGES * THREADS * 8 * (el + 4) +
         (d.lc * SP * el + 15) / 16 * 16 +
         sizeof(float) * (4 * MAX_CHUNK + 10 * TILE + 2 * G_MAX * TILE + TILE) +
         8 * TMA_STAGES;
}
size_t state_smem(size_t el, bool tm) {
  return 1024 + (el == 2 ? fwd_head<StateRing<BF16>>(tm, false)
                         : fwd_head<StateRing<float>>(tm, false)) +
         sizeof(float) * (2 + CU_WIN) * MAX_CHUNK + 8 * TMA_STAGES;
}
size_t out_smem(const Dims& d, size_t el, bool tm) {
  return 1024 + (el == 2 ? fwd_head<OutRing<BF16>::R>(tm, true)
                         : fwd_head<OutRing<float>::R>(tm, true)) +
         TILE * strip_width(d.lc) * el + sizeof(float) * 6 * MAX_CHUNK +
         8 * TMA_STAGES;
}
size_t sums_smem(size_t el) {
  return 8 * TMA_STAGES + SUMS_NB * buf_bytes(el) +
         SUMS_STAGES * THREADS * 8 * (el + 4) +
         sizeof(float) * SUMS_HEADS * TILE;
}

// True when TMA's boxes fit the bf16 operands' shapes: a step's 32 k stay
// inside a head (hd), a chunk (lc) and rows of 16-byte multiples (ns).
bool tma_shape(const Dims& d, int dtype) {
  return dtype == 1 && d.hd % KS == 0 && d.lc % KS == 0 && d.ns % 8 == 0;
}

// The lanes step gives a row of the state: its chunks of a 16-byte vector
// of values, rounded up to a power of two, at most 32.
int step_lanes(int ns, int dtype) {
  const int chunks = div_up(ns, static_cast<int>(16 / elem(dtype)));
  int lanes = 1;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  return lanes;
}

// step's blocks of rows of a (batch, head): STEP_WARPS x (32 / lanes) rows
// a block.
int step_row_blocks(const Dims& d, int dtype) {
  return div_up(d.hd, STEP_WARPS * (32 / step_lanes(d.ns, dtype)));
}

// step's blocks of the conv window's shift (conv_rows x width values a
// sequence): CONV_UNROLL 16-byte vectors a thread.
int step_conv_blocks(int b, int conv_rows, int width, int dtype) {
  const long long vecs = (static_cast<long long>(b) * conv_rows * width *
                              static_cast<long long>(elem(dtype)) + 15) / 16;
  return static_cast<int>((vecs + STEP_THREADS * CONV_UNROLL - 1) /
                          (STEP_THREADS * CONV_UNROLL));
}

// The launches of an entry, in order: each kernel's grid, block and
// dynamic shared memory (tm: the forward's products by TMA).  step reads
// d.s as the conv window's rows (cw - 1) and d.lc as its width.
int launches(int entry, const Dims& d, int dtype, bool tm, Launch* out) {
  const int t = div_up(d.lc, TILE);
  if (entry == SCAN) {
    out[0] = {dim3(d.b * d.nh, state_tiles(d)), THREADS,
              state_smem(elem(dtype), tm)};
    out[1] = {dim3(div_up(t, 2), d.nc, d.b * groups(d)), THREADS,
              out_smem(d, elem(dtype), tm)};
    return 2;
  }
  if (entry == SCAN_GRAD) {
    out[0] = {dim3(d.b * d.nh), THREADS, carry_smem(elem(dtype))};
    out[1] = {dim3(div_up(t, 2), d.nc, d.b * groups(d)), THREADS,
              heads_smem(d, elem(dtype))};
    out[2] = {dim3(d.b * d.nc * d.nh), FIN, 0};
    out[3] = {dim3(t, div_up(d.ns, TILE), d.nc * d.b), THREADS,
              sums_smem(elem(dtype))};
    return 4;
  }
  out[0] = {dim3(d.b * d.nh * step_row_blocks(d, dtype) +
                 step_conv_blocks(d.b, d.s, d.lc, dtype)),
            STEP_THREADS, 0};
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
  SSD_CHECK(allow_smem(state_kernel<T, false>, state_smem(sizeof(T), false)));
  SSD_CHECK(allow_smem(out_kernel<T, false>, out_smem(most, sizeof(T), false)));
  SSD_CHECK(allow_smem(carry_kernel<T, false>, carry_smem(sizeof(T))));
  SSD_CHECK(allow_smem(heads_kernel<T, false>, heads_smem(most, sizeof(T))));
  SSD_CHECK(allow_smem(sums_kernel<T, false>, sums_smem(sizeof(T))));
  if constexpr (std::is_same<T, BF16>::value) {
    SSD_CHECK(allow_smem(state_kernel<T, true>, state_smem(2, true)));
    SSD_CHECK(allow_smem(out_kernel<T, true>, out_smem(most, 2, true)));
    SSD_CHECK(allow_smem(carry_kernel<T, true>, carry_smem(sizeof(T))));
    SSD_CHECK(allow_smem(heads_kernel<T, true>, heads_smem(most, sizeof(T))));
    SSD_CHECK(allow_smem(sums_kernel<T, true>, sums_smem(sizeof(T))));
  }
  size_t most_smem = heads_smem(most, sizeof(float));
  for (size_t b : {carry_smem(4), sums_smem(4), state_smem(4, false),
                   out_smem(most, 4, false), state_smem(2, true),
                   out_smem(most, 2, true)})
    most_smem = b > most_smem ? b : most_smem;
  SSD_CHECK(allow_smem(empty_kernel, most_smem));
  done[dev] = true;
  return 0;
}

int last_error() { return static_cast<int>(cudaGetLastError()); }


// True when TMA's boxes fit the bf16 operands (tma_shape) and every base
// is 16-byte aligned.
bool tma_fits(const Dims& d, int dtype,
              std::initializer_list<const void*> bases) {
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return tma_shape(d, dtype);
}

// A 2-d map of a row-major bf16 (rows, cols) tensor, box 8 columns by
// box_rows rows without swizzle, or (wide) 64 columns by box_rows rows
// with 128-byte swizzle; zeros out of range; 0, else 10000 + the driver's
// CUresult.
int encode2(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
            uint32_t box_rows, bool wide = false) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {wide ? static_cast<cuuint32_t>(TILE) : 8u,
                             box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         wide ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

// The forward's maps: wide, swizzled.
int make_fwd_maps(const Dims& d, const BF16* xh, const BF16* B,
                  const BF16* C, const BF16* y, const BF16* states, Maps& m) {
  const uint64_t rows = static_cast<uint64_t>(d.b) * d.s;
  const uint64_t wide = static_cast<uint64_t>(d.nh) * d.hd;
  const uint64_t srows = static_cast<uint64_t>(d.nc) * d.b * wide;
  SSD_CHECK(encode2(&m.xW, xh, wide, rows, KW, true));
  SSD_CHECK(encode2(&m.BW, B, d.ns, rows, KW, true));
  SSD_CHECK(encode2(&m.CW, C, d.ns, rows, TILE, true));
  SSD_CHECK(encode2(&m.SW, states, d.ns, srows, TILE, true));
  return encode2(&m.yW, y, wide, rows, TILE, true);
}

// The backward's maps.
int make_maps(const Dims& d, const BF16* xh, const BF16* B, const BF16* C,
              const BF16* states, const BF16* dy, Maps& m) {
  const uint64_t rows = static_cast<uint64_t>(d.b) * d.s;
  const uint64_t wide = static_cast<uint64_t>(d.nh) * d.hd;
  const uint64_t srows = static_cast<uint64_t>(d.nc) * d.b * wide;
  SSD_CHECK(encode2(&m.dyK, dy, wide, rows, TILE));
  SSD_CHECK(encode2(&m.dyMN, dy, wide, rows, KS));
  SSD_CHECK(encode2(&m.xK, xh, wide, rows, TILE));
  SSD_CHECK(encode2(&m.BK, B, d.ns, rows, TILE));
  SSD_CHECK(encode2(&m.CK, C, d.ns, rows, TILE));
  SSD_CHECK(encode2(&m.CMN, C, d.ns, rows, KS));
  SSD_CHECK(encode2(&m.SK, states, d.ns, srows, TILE));
  return encode2(&m.SMN, states, d.ns, srows, KS);
}

template <typename T, bool TM>
int launch_scan(const float* dt, const T* xh, const T* B, const T* C,
                const float* A, const Dims& d, const Launch (&g)[2],
                const Work& w, const Maps& maps, T* y, T* final_state,
                T* states, cudaStream_t stream) {
  state_kernel<T, TM><<<g[0].grid, g[0].threads, g[0].smem, stream>>>(
      dt, A, xh, B, d, w.cums, states, final_state, maps);
  SSD_CHECK(last_error());
  out_kernel<T, TM><<<g[1].grid, g[1].threads, g[1].smem, stream>>>(
      dt, xh, B, C, w.cums, states, d, group_size(d), y, maps);
  return last_error();
}

template <typename T>
int scan_impl(const float* dt, const T* xh, const T* B, const T* C,
              const float* A, const Dims& d, int dtype, const Work& w, T* y,
              T* final_state, T* states, cudaStream_t stream) {
  const bool tm = tma_fits(d, dtype, {xh, B, C, y, states});
  Launch g[2];
  launches(SCAN, d, dtype, tm, g);
  SSD_CHECK(prepare<T>());
  Maps maps{};
  if constexpr (std::is_same<T, BF16>::value) {
    if (tm) {
      SSD_CHECK(make_fwd_maps(d, xh, B, C, y, states, maps));
      return launch_scan<T, true>(dt, xh, B, C, A, d, g, w, maps, y,
                                  final_state, states, stream);
    }
  }
  return launch_scan<T, false>(dt, xh, B, C, A, d, g, w, maps, y,
                               final_state, states, stream);
}

template <typename T, bool TM>
int launch_grad(const float* dt, const T* xh, const T* B, const T* C,
                const float* A, const T* states, const T* dy,
                const T* dfinal, const Dims& d, const Launch (&g)[4],
                const Work& w, const Maps& maps, T* dxh, float* ddt, T* dB,
                T* dC, float* dA, cudaStream_t stream) {
  const size_t n1 = static_cast<size_t>(d.b) * d.s * d.nh;
  const Vecs vec{w.vec, w.vec + n1, w.vec + 2 * n1, w.vec + 3 * n1,
                 w.vec + 4 * n1};
  carry_kernel<T, TM><<<g[0].grid, g[0].threads, g[0].smem, stream>>>(
      dt, A, dy, C, states, dfinal, d, w.cums, w.gc, w.dG, maps);
  SSD_CHECK(last_error());
  heads_kernel<T, TM><<<g[1].grid, g[1].threads, g[1].smem, stream>>>(
      dt, xh, B, C, dy, states, w.cums, w.gc, d, group_size(d), vec, w.dcbp,
      dxh, maps);
  SSD_CHECK(last_error());
  finish_kernel<<<g[2].grid, g[2].threads, g[2].smem, stream>>>(
      dt, A, w.cums, w.dG, d, vec, groups(d), w.dcbp, ddt, w.da_part);
  SSD_CHECK(last_error());
  sums_kernel<T, TM><<<g[3].grid, g[3].threads, g[3].smem, stream>>>(
      dt, xh, B, C, dy, states, w.cums, w.gc, w.dcbp, w.da_part, d, dB, dC,
      dA, maps);
  return last_error();
}

template <typename T>
int scan_grad_impl(const float* dt, const T* xh, const T* B, const T* C,
                   const float* A, const T* states, const T* dy,
                   const T* dfinal, const Dims& d, int dtype, const Work& w,
                   T* dxh, float* ddt, T* dB, T* dC, float* dA,
                   cudaStream_t stream) {
  Launch g[4];
  launches(SCAN_GRAD, d, dtype, false, g);
  SSD_CHECK(prepare<T>());
  Maps maps{};
  if constexpr (std::is_same<T, BF16>::value) {
    if (tma_fits(d, dtype, {xh, B, C, states, dy})) {
      SSD_CHECK(make_maps(d, xh, B, C, states, dy, maps));
      return launch_grad<T, true>(dt, xh, B, C, A, states, dy, dfinal, d, g,
                                  w, maps, dxh, ddt, dB, dC, dA, stream);
    }
  }
  return launch_grad<T, false>(dt, xh, B, C, A, states, dy, dfinal, d, g, w,
                               maps, dxh, ddt, dB, dC, dA, stream);
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
                     A, d, dtype, w, static_cast<BF16*>(y),
                     static_cast<BF16*>(final_state),
                     static_cast<BF16*>(states), stream);
  return scan_impl(dt, static_cast<const float*>(xh),
                   static_cast<const float*>(B), static_cast<const float*>(C),
                   A, d, dtype, w, static_cast<float*>(y),
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
        static_cast<const BF16*>(dy), static_cast<const BF16*>(dfinal), d,
        dtype, w,
        static_cast<BF16*>(dxh), ddt, static_cast<BF16*>(dB),
        static_cast<BF16*>(dC), dA, stream);
  return scan_grad_impl(
      dt, static_cast<const float*>(xh), static_cast<const float*>(B),
      static_cast<const float*>(C), A, static_cast<const float*>(states),
      static_cast<const float*>(dy), static_cast<const float*>(dfinal), d,
      dtype, w,
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
  const Dims d = dims(b, conv_rows, nh, hd, ns, width);
  Launch g[1];
  launches(STEP, d, dtype, false, g);
  const int row_blocks = step_row_blocks(d, dtype);
  const int state_blocks = b * nh * row_blocks;
  const long long per = static_cast<long long>(conv_rows) * width;
  const size_t e = elem(dtype);
  bool vec = (ns * e) % 16 == 0 && (width * e) % 16 == 0;
  for (const void* ptr : {static_cast<const void*>(state),
                          static_cast<const void*>(conv), window, Bv, Cv})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  const int lanes = step_lanes(ns, dtype);
  if (dtype == 1) {
    auto kernel = vec ? step_kernel<BF16, true> : step_kernel<BF16, false>;
    kernel<<<g[0].grid, g[0].threads, 0, stream>>>(
        static_cast<BF16*>(state), static_cast<BF16*>(conv),
        static_cast<const BF16*>(window), static_cast<const BF16*>(xh), dtv,
        A, static_cast<const BF16*>(Bv), static_cast<const BF16*>(Cv), nh, hd,
        ns, lanes, row_blocks, state_blocks, per, width, per * b,
        static_cast<BF16*>(y));
  } else {
    auto kernel = vec ? step_kernel<float, true> : step_kernel<float, false>;
    kernel<<<g[0].grid, g[0].threads, 0, stream>>>(
        static_cast<float*>(state), static_cast<float*>(conv),
        static_cast<const float*>(window), static_cast<const float*>(xh),
        dtv, A, static_cast<const float*>(Bv), static_cast<const float*>(Cv),
        nh, hd, ns, lanes, row_blocks, state_blocks, per, width, per * b,
        static_cast<float*>(y));
  }
  return last_error();
}

// The launch floor of an entry: an empty kernel launched with each of the
// entry's grids, blocks and dynamic shared memory, in order.
extern "C" int ssd_floor_sm90(int entry, int b, int s, int nh, int hd, int ns,
                              int lc, int dtype, cudaStream_t stream) {
  const Dims d = dims(b, s, nh, hd, ns, lc);
  if (entry == STEP ? (b < 1 || nh < 1 || hd < 1 || ns < 1 || s < 0 || lc < 1 ||
                       (dtype != 0 && dtype != 1))
                    : bad(d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch g[4];
  const int n = launches(entry, d, dtype, entry == SCAN && tma_shape(d, dtype),
                         g);
  SSD_CHECK(prepare<float>());
  for (int k = 0; k < n; ++k) {
    empty_kernel<<<g[k].grid, g[k].threads, g[k].smem, stream>>>(0);
    SSD_CHECK(last_error());
  }
  return 0;
}
