// Flash attention in fp32 on Hopper's tensor cores: 3xTF32 wgmma on tiles
// that TMA brings into shared memory.  CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:62 flash_attention_bhsd
//   (body _flash_kernel :24), with the kv-head repeat of its GQA wrapper
//   src/repro/kernels/flash_attention/ops.py:13 flash_attention,
// for float32 inputs (bf16 inputs launch flash_attention_sm90.cu).
//
// It computes what _flash_kernel computes: softmax(q k^T / sqrt(D), causal
// mask -1e30) v with the running max m, the running sum l and the
// accumulator in fp32, and writes acc / (l + 1e-30) in fp32, within the JAX
// kernel tests' float32 tolerance (atol = rtol = 2e-5) of the plain version.
//
// Arithmetic.  One TF32 product keeps 10 mantissa bits and misses 2e-5 by
// an order of magnitude.  Each operand x is split as hi = tf32_rna(x), lo =
// tf32_rna(x - hi) (x - hi is exact in fp32; rounding both explicitly makes
// the result independent of how the tensor core reads the low 13 bits), and
// each product is hi hi' + hi lo' + lo hi' in the fp32 wgmma accumulator;
// lo lo' (about 2^-22 of the product) is dropped.  Both products are split:
// S = q k^T, and O += P v with P split in registers.
//
// Layout: q, o are (B, S, H, D), k, v are (B, S, Hkv, D), contiguous; q head
// h reads kv head h / (H / Hkv) (GQA by index, no repeated copy).
//
// What bounds it on the H100 (495 TFLOP/s TF32 dense, 3.35 TB/s): three
// TF32 products for each fp32 one.  At the serving shape (B=4, S=512, H=12,
// Hkv=2, D=128, causal) 3 x 3.23 GFLOP take 19.6 us against 29.4 MB of
// bytes, 8.8 us; at S=8192 (B=1) 3 x 206 GFLOP take 1.25 ms: operations
// bound at both.  The design keeps both products on the tensor cores and
// every intermediate on chip.
//
// Design:
//   * TF32 wgmma reads both operands K-major from shared memory (the
//     transpose bits exist for 16-bit types only), so v has to arrive as
//     v^T with the kv index contiguous.  A pre-pass kernel, which the
//     wrapper launches just before the attention kernel on the same
//     stream, writes k and v^T split into hi and lo into scratch that the
//     wrapper allocates (torch.empty): kx (2, B*Hkv, S_pad, D) and vt (2,
//     B*Hkv, D, S_pad), S_pad = S rounded up to 64 with zero rows.
//     k and v have only Hkv heads (2.1 MB each at the serving shape), read
//     by every q tile of 6 q heads: splitting them once costs a few
//     microseconds, where splitting in every block would repeat the work
//     ceil(S / 64) * H / Hkv times.  q (12.6 MB) is split inside the block,
//     once per q tile, in place in shared memory.
//   * P stays in registers.  For TF32 k8 a thread's A fragment holds
//     columns t and t + 4 (t = lane % 4) of each 8-column group, its
//     accumulator columns 2t and 2t + 1.  P v sums over the kv index, so
//     the A fragment takes the accumulator as it is and the pre-pass
//     permutes v^T's kv index inside every group of 8 to match: position p
//     holds kv row 2p for p < 4 and 2(p - 4) + 1 for p >= 4.
//   * One block per (b * H + h, 64-row q tile), 192 threads: one consumer
//     warpgroup (wgmma's M = 64) and two producer warps, one thread of one
//     issuing the q and k loads, one of the other the v loads, so a free k
//     buffer refills while v is still in use.  q tiles run heaviest first.
//   * Shared memory, 128-byte swizzle (a box row holds 32 fp32, so a D=128
//     row is four boxes): q hi + lo 2 x 32 KB, k tile (64 rows) hi + lo
//     2 x 32 KB, v^T tile hi + lo 2 x 32 KB: 196,608 bytes at D = 128 with
//     one k and one v stage (the 227 KB a block may hold leave no room for
//     a second); 163,840 bytes at D = 64 with two stages.
//   * S = q k^T: wgmma m64n64k8, 3 x D / 8 products per tile, lo terms
//     first.  The online softmax is flash_attention_sm90.cu's: registers,
//     exp2 domain, masks only on diagonal or ragged tiles.  O += P v:
//     m64nDk8 with A from registers, 3 x 8 products per tile.  The
//     warpgroup issues S of tile j, then P v of tile j - 1, waits for S
//     alone and runs the softmax of j while P v runs.  Registers are
//     pinned around every wait (fence_regs).
//   * o = acc / (l + 1e-30) goes out through the q hi buffer and one TMA
//     store per 32-column box (rows past S are clipped).
//
// C interface (loaded with ctypes): flash_attention_split_kv_tf32 launches
// the pre-pass, flash_attention_fwd_sm90_fp32 the attention kernel, each on
// the given stream.  Both return the cudaError_t of the launch as an int, 0
// on success; an unsupported case returns cudaErrorInvalidValue, a tensor
// map that the driver refuses 10000 + its CUresult.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int BM = 64;           // q rows per block: one consumer warpgroup
constexpr int BN = 64;           // kv rows per tile; the scratch's kv padding
constexpr int THREADS = 192;     // a consumer warpgroup + two producer warps
constexpr int CONSUMER_WARPS = 4;
constexpr int BOX = 32;          // fp32 columns in one 128-byte swizzled box row
constexpr int SPLIT_ROWS = 32;   // kv rows per pre-pass block
constexpr int SPLIT_THREADS = 256;
constexpr float NEG_INF = -1e30f;

// Shared-memory byte offsets of one block, from a 1024-aligned base.
template <int D>
struct Smem {
  static constexpr int STAGES = D == 64 ? 2 : 1;
  static constexpr int Q_BOX = BM * 128;             // 64 q rows x 32 columns
  static constexpr int K_BOX = BN * 128;             // 64 kv rows x 32 columns
  static constexpr int V_BOX = D * 128;              // D rows of v^T x 32 kv
  static constexpr int Q_PART = (D / BOX) * Q_BOX;   // q hi or q lo
  static constexpr int K_PART = (D / BOX) * K_BOX;   // a k tile's hi or lo
  static constexpr int V_PART = (BN / BOX) * V_BOX;  // a v^T tile's hi or lo
  static constexpr int Q = 0;                        // q hi, q lo
  static constexpr int K = Q + 2 * Q_PART;           // per stage: k hi, k lo
  static constexpr int V = K + STAGES * 2 * K_PART;  // per stage: v^T hi, v^T lo
  static constexpr int BAR = V + STAGES * 2 * V_PART;
  // barriers: q_full, then k_full, k_empty, v_full, v_empty per stage
  static constexpr int BYTES = BAR + (1 + 4 * STAGES) * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  hi.x = tf32_rna(x.x); lo.x = tf32_rna(x.x - hi.x);
  hi.y = tf32_rna(x.y); lo.y = tf32_rna(x.y - hi.y);
  hi.z = tf32_rna(x.z); lo.z = tf32_rna(x.z - hi.z);
  hi.w = tf32_rna(x.w); lo.w = tf32_rna(x.w - hi.w);
}

// kv position p of a group of 8 in the scratch's v^T holds kv row kv_order(p)
__device__ __forceinline__ int kv_order(int p) { return p < 4 ? 2 * p : 2 * (p - 4) + 1; }

// Pre-pass: k (B, S, Hkv, D) -> kx (2, B*Hkv, S_pad, D) and v -> vt (2,
// B*Hkv, D, S_pad), each [0] hi and [1] lo, rows past S zero.  One block
// per (kv head, 32 kv rows), 16-byte loads; v passes through shared
// memory to be transposed, and each warp writes 32 consecutive kv
// positions of one v^T row.
template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS)
split_kv_kernel(const float4* __restrict__ k, const float4* __restrict__ v,
                float* __restrict__ kx, float* __restrict__ vt, int S, int Hkv,
                int S_pad, size_t part) {
  constexpr int V4 = D / 4;
  __shared__ float tile[SPLIT_ROWS][D + 1];
  const int kvh = blockIdx.x;
  const int b = kvh / Hkv, hk = kvh - b * Hkv;
  const int s0 = blockIdx.y * SPLIT_ROWS;
  float4* kx_hi = reinterpret_cast<float4*>(kx);
  float4* kx_lo = reinterpret_cast<float4*>(kx + part);
  for (int i = threadIdx.x; i < SPLIT_ROWS * V4; i += SPLIT_THREADS) {
    const int r = i / V4, c = i - r * V4, s = s0 + r;
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (s < S) {
      const size_t src = (((size_t)b * S + s) * Hkv + hk) * V4 + c;
      kv = k[src];
      vv = v[src];
    }
    float4 hi, lo;
    split4(kv, hi, lo);
    const size_t dst = ((size_t)kvh * S_pad + s) * V4 + c;
    kx_hi[dst] = hi;
    kx_lo[dst] = lo;
    float* row = &tile[r][4 * c];
    row[0] = vv.x;
    row[1] = vv.y;
    row[2] = vv.z;
    row[3] = vv.w;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SPLIT_ROWS * D; i += SPLIT_THREADS) {
    const int d = i / SPLIT_ROWS, p = i - d * SPLIT_ROWS;
    const float x = tile[(p & ~7) | kv_order(p & 7)][d];
    const float hi = tf32_rna(x);
    const size_t dst = ((size_t)kvh * D + d) * S_pad + s0 + p;
    vt[dst] = hi;
    vt[part + dst] = tf32_rna(x - hi);
  }
}

// D[64 x 64] (+)= A[64 x 8] B[8 x 64] in TF32, both operands K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] += A[64 x 8] B[8 x 128] in TF32, A in registers, B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 8] B[8 x 64] in TF32, A in registers, B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to, int H, int Hkv, int S,
                      int causal, float scale_log2) {
  using L = Smem<D>;
  constexpr int STAGES = L::STAGES;
  constexpr int QBOXES = D / BOX;    // boxes across a q or k row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;      // 128-byte swizzle needs 1024
  uint8_t* smem = smem_raw + (base - raw);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = b * Hkv + h / (H / Hkv);           // kv head in the scratch
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest q tiles first
  const int kv_end = causal ? min(S, q0 + BM) : S;
  const int n_tiles = (kv_end + BN - 1) / BN;

  const uint32_t q_full = base + L::BAR;
  const uint32_t k_full = q_full + 8;
  const uint32_t k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES;
  const uint32_t v_empty = v_full + 8 * STAGES;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, CONSUMER_WARPS);
      mbar_init(v_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producers: thread 128 loads q and the k tiles, thread 160 the v^T tiles ----
    if (threadIdx.x == 128) {
      mbar_expect_tx(q_full, BM * D * 4);
#pragma unroll
      for (int c = 0; c < QBOXES; ++c)
        tma_load(base + L::Q + c * L::Q_BOX, &tq, q_full, c * BOX, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(k_empty + 8 * s, ((j / STAGES) - 1) & 1);
        mbar_expect_tx(k_full + 8 * s, 2 * L::K_PART);
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int c = 0; c < QBOXES; ++c)
            tma_load(base + L::K + (2 * s + part) * L::K_PART + c * L::K_BOX, &tk,
                     k_full + 8 * s, c * BOX, j * BN, kvh, part);
      }
    } else if (threadIdx.x == 160) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(v_empty + 8 * s, ((j / STAGES) - 1) & 1);
        mbar_expect_tx(v_full + 8 * s, 2 * L::V_PART);
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int c = 0; c < BN / BOX; ++c)
            tma_load(base + L::V + (2 * s + part) * L::V_PART + c * L::V_BOX, &tv,
                     v_full + 8 * s, j * BN + c * BOX, 0, kvh, part);
      }
    }
    return;
  }

  // ---- consumer warpgroup: q rows q0 .. q0 + 63 ----
  const int t = threadIdx.x;
  const int lane = t % 32;
  // accumulator layout of wgmma m64nN: this thread holds rows row0 and
  // row0 + 8, columns 8 * n + col0 + {0, 1} of each 8-column block n
  const int row0 = (t / 32) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int qpos0 = q0 + row0;
  const int qpos1 = qpos0 + 8;
  const uint32_t q_hi = base + L::Q;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;   // running max of the raw scores
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the running sum

  // split q in place: hi stays where TMA put it, lo goes to the same
  // offset of the second part (the split is elementwise, so the swizzle
  // carries over)
  mbar_wait(q_full, 0);
  {
    float4* hi = reinterpret_cast<float4*>(smem + L::Q);
    float4* lo = reinterpret_cast<float4*>(smem + L::Q + L::Q_PART);
#pragma unroll 4
    for (int i = t; i < L::Q_PART / 16; i += 128) split4(hi[i], hi[i], lo[i]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");

  // S = q k^T of tile j into sc: three products per 8 columns of D,
  // stepping 32 bytes inside a 128-byte box row and a box every four steps.
  // The descriptors are offsets from two base descriptors made opaque per
  // tile, so the compiler keeps none of them live across tiles.
  float sc[BN / 2];
  auto issue_s = [&](int j) {
    const int s = j % STAGES;
    uint64_t dq = smem_desc(q_hi, 16, 1024);
    uint64_t dk = smem_desc(base + L::K + 2 * s * L::K_PART, 16, 1024);
    asm volatile("" : "+l"(dq), "+l"(dk));
    mbar_wait(k_full + 8 * s, (j / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t qo = (kk / 4) * L::Q_BOX + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * L::K_BOX + (kk % 4) * 32;
      wgmma_tf32_ss_n64(sc, desc_at(dq, L::Q_PART + qo), desc_at(dk, ko), kk > 0);
      wgmma_tf32_ss_n64(sc, desc_at(dq, qo), desc_at(dk, L::K_PART + ko), 1);
      wgmma_tf32_ss_n64(sc, desc_at(dq, qo), desc_at(dk, ko), 1);
    }
    wgmma_commit();
  };
  // O += P v of tile j: P's hi and lo from registers, the accumulator's
  // columns {2t, 2t + 1} of each group of 8 read as the A fragment's
  // {t, t + 4}, which the scratch's kv order matches
  uint32_t ph[BN / 2], pl[BN / 2];
  auto issue_pv = [&](int j) {
    const int s = j % STAGES;
    uint64_t dv = smem_desc(base + L::V + 2 * s * L::V_PART, 16, 1024);
    asm volatile("" : "+l"(dv));
    mbar_wait(v_full + 8 * s, (j / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      const uint32_t vo = (kk / 4) * L::V_BOX + (kk % 4) * 32;
      const uint64_t dh = desc_at(dv, vo);
      const uint64_t dl = desc_at(dv, L::V_PART + vo);
      const int i = 4 * kk;
      if constexpr (D == 128) {
        wgmma_tf32_rs_n128(o, pl[i], pl[i + 2], pl[i + 1], pl[i + 3], dh);
        wgmma_tf32_rs_n128(o, ph[i], ph[i + 2], ph[i + 1], ph[i + 3], dl);
        wgmma_tf32_rs_n128(o, ph[i], ph[i + 2], ph[i + 1], ph[i + 3], dh);
      } else {
        wgmma_tf32_rs_n64(o, pl[i], pl[i + 2], pl[i + 1], pl[i + 3], dh);
        wgmma_tf32_rs_n64(o, ph[i], ph[i + 2], ph[i + 1], ph[i + 3], dl);
        wgmma_tf32_rs_n64(o, ph[i], ph[i + 2], ph[i + 1], ph[i + 3], dh);
      }
    }
    wgmma_commit();
  };
  // online softmax of tile j in place: sc becomes exp(S - m_new) in fp32;
  // the rescale factors of the two rows come back in alpha0, alpha1
  float alpha0, alpha1, rs0, rs1;
  auto softmax = [&](int j) {
    const int k0 = j * BN;
    if (k0 + BN > S || (causal && k0 + BN - 1 > q0)) {  // diagonal or ragged edge
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int kpos = k0 + (i / 4) * 8 + col0 + (i & 1);
        const int qpos = (i & 2) ? qpos1 : qpos0;
        if (kpos >= S || (causal && kpos > qpos)) sc[i] = NEG_INF;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, sc[i]);
      else mx0 = fmaxf(mx0, sc[i]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    alpha0 = exp2_approx((m0 - mx0) * scale_log2);
    alpha1 = exp2_approx((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float mb0 = mx0 * scale_log2, mb1 = mx1 * scale_log2;
    rs0 = rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      sc[i] = exp2_approx(fmaf(sc[i], scale_log2, (i & 2) ? -mb1 : -mb0));
      if (i & 2) rs1 += sc[i];
      else rs0 += sc[i];
    }
  };
  // P to its TF32 hi and lo; l sums the unsplit P
  auto split_p = [&]() {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const float hi = tf32_rna(sc[i]);
      ph[i] = __float_as_uint(hi);
      pl[i] = __float_as_uint(tf32_rna(sc[i] - hi));
    }
  };
  auto rescale = [&]() {
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? alpha1 : alpha0;
  };

  // Tile j's scores are computed while tile j - 1's P v runs: the two
  // groups are in flight together, and the softmax of j overlaps P v.
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  if (lane == 0) mbar_arrive(k_empty);
  softmax(0);
  rescale();
  split_p();
  for (int j = 1; j < n_tiles; ++j) {
    issue_s(j);
    issue_pv(j - 1);
    wgmma_wait<1>();                 // S of tile j is done, P v may run on
    fence_regs(sc);
    if (lane == 0) mbar_arrive(k_empty + 8 * (j % STAGES));
    softmax(j);
    wgmma_wait<0>();                 // P v of tile j - 1 is done
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    if (lane == 0) mbar_arrive(v_empty + 8 * ((j - 1) % STAGES));
    rescale();
    split_p();
  }
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(ph);
  fence_regs(pl);

  // o = acc / (l + 1e-30), through the q hi buffer (every product that
  // read it is done), swizzled as the TMA map expects
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / (l0 + 1e-30f);
  const float inv1 = 1.f / (l1 + 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    // columns 8n + col0 + {0, 1}: box n / 4, 16-byte chunk 2 (n % 4) + (lane % 4) / 2
    uint8_t* box = smem + L::Q + (n / 4) * L::Q_BOX + 8 * (lane % 2);
    const int chunk = 2 * (n % 4) + (lane % 4) / 2;
    const int swz = (chunk ^ (row0 % 8)) * 16;       // row0 + 8 has the same row % 8
    *reinterpret_cast<float2*>(box + row0 * 128 + swz) =
        make_float2(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    *reinterpret_cast<float2*>(box + (row0 + 8) * 128 + swz) =
        make_float2(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < QBOXES; ++c) tma_store(&to, q_hi + c * L::Q_BOX, c * BOX, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// A 4-d fp32 tensor map with 128-byte swizzle: dims and box innermost
// first, strides (bytes) of dims 1-3.
CUresult tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                    const cuuint64_t (&dims)[4], const cuuint32_t (&box)[4]) {
  const cuuint64_t strides[3] = {dims[0] * 4, dims[0] * dims[1] * 4,
                                 dims[0] * dims[1] * dims[2] * 4};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int s_pad(int S) { return (S + BN - 1) / BN * BN; }

template <int D>
int split_kv(const void* k, const void* v, float* scratch, int B, int Hkv, int S,
             cudaStream_t stream) {
  const int sp = s_pad(S);
  const size_t part = (size_t)B * Hkv * sp * D;
  split_kv_kernel<D><<<dim3(B * Hkv, sp / SPLIT_ROWS), SPLIT_THREADS, 0, stream>>>(
      static_cast<const float4*>(k), static_cast<const float4*>(v), scratch,
      scratch + 2 * part, S, Hkv, sp, part);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, void* o, const float* scratch, int B, int H, int Hkv, int S,
           int causal, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t sp = s_pad(S), kvh = (cuuint64_t)B * Hkv;
  const float* vt = scratch + 2 * kvh * sp * D;
  CUtensorMap tq, tk, tv, to;
  CUresult res;
  const cuuint64_t qdims[4] = {D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint32_t qbox[4] = {BOX, 1, BM, 1};
  const cuuint64_t kdims[4] = {D, sp, kvh, 2};
  const cuuint32_t kbox[4] = {BOX, BN, 1, 1};
  const cuuint64_t vdims[4] = {sp, D, kvh, 2};
  const cuuint32_t vbox[4] = {BOX, D, 1, 1};
  if ((res = tensor_map(encode, &tq, q, qdims, qbox)) != CUDA_SUCCESS ||
      (res = tensor_map(encode, &tk, scratch, kdims, kbox)) != CUDA_SUCCESS ||
      (res = tensor_map(encode, &tv, vt, vdims, vbox)) != CUDA_SUCCESS ||
      (res = tensor_map(encode, &to, o, qdims, qbox)) != CUDA_SUCCESS)
    return 10000 + (int)res;
  static unsigned long long configured = 0;
  cudaError_t err = allow_smem(flash_fwd_tf32_kernel<D>, Smem<D>::BYTES, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + BM - 1) / BM);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  flash_fwd_tf32_kernel<D><<<grid, THREADS, Smem<D>::BYTES, stream>>>(
      tq, tk, tv, to, H, Hkv, S, causal, scale_log2);
  return (int)cudaGetLastError();
}

// The cases both entry points refuse, given the scratch's float count.
bool unsupported(int B, int Hkv, int S, int H, long long scratch_floats, int head_dim) {
  return B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
         (head_dim != 64 && head_dim != 128) || s_pad(S) / SPLIT_ROWS > 65535 ||
         (long long)B * H > 0x7fffffffLL ||
         scratch_floats < 4LL * B * Hkv * s_pad(S) * head_dim;
}

}  // namespace

// The pre-pass: k, v (B, S, Hkv, D) fp32 into the scratch, 4 * B * Hkv *
// S_pad * head_dim floats (S_pad = S rounded up to 64): k hi, k lo, v^T
// hi, v^T lo, as the note at the top lays them out.
extern "C" int flash_attention_split_kv_tf32(const void* k, const void* v, void* scratch,
                                             long long scratch_floats, int B, int Hkv,
                                             int S, int head_dim, void* stream) {
  if (unsupported(B, Hkv, S, Hkv, scratch_floats, head_dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (head_dim == 64) return split_kv<64>(k, v, sc, B, Hkv, S, st);
  return split_kv<128>(k, v, sc, B, Hkv, S, st);
}

// The attention kernel: fp32 q (B, S, H, D), o like q, head_dim 64 or 128,
// reading k and v from the scratch that flash_attention_split_kv_tf32
// filled earlier on the same stream.
extern "C" int flash_attention_fwd_sm90_fp32(const void* q, void* o, const void* scratch,
                                             long long scratch_floats, int B, int H,
                                             int Hkv, int S, int head_dim, int causal,
                                             void* stream) {
  if (unsupported(B, Hkv, S, H, scratch_floats, head_dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scratch);
  if (head_dim == 64) return launch<64>(q, o, sc, B, H, Hkv, S, causal, st);
  return launch<128>(q, o, sc, B, H, Hkv, S, causal, st);
}
