// Flash attention for Hopper's tensor cores: bf16 wgmma on tiles that TMA
// brings into shared memory.  CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:62 flash_attention_bhsd
//   (body _flash_kernel :24), with the kv-head repeat of its GQA wrapper
//   src/repro/kernels/flash_attention/ops.py:13 flash_attention,
// for bf16 inputs.  float32 inputs keep the CUDA-core kernel of
// flash_attention.cu (see kernels/flash_attention/flash_attention.py).
//
// It computes what _flash_kernel computes: softmax(q k^T / sqrt(D), causal
// mask -1e30) v with the running max m, the running sum l and the
// accumulator in fp32, and writes acc / (l + 1e-30) in bf16.  One rounding
// more than the TPU kernel: the probabilities P enter the P.V product as
// bf16 (the tensor cores take bf16 operands), while l sums them in fp32.
//
// Layout: q, o are (B, S, H, D), k, v are (B, S, Hkv, D), contiguous; q head
// h reads kv head h / (H / Hkv) in place (GQA by index, no repeated copy).
//
// What bounds it on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s):
//   * serving prefill (B=4, S=512, H=12, Hkv=2, D=128, causal): 14.7 MB to
//     move (q, o 6.3 MB each, k, v 1.0 MB each) take 4.38 us, against 3.23
//     GFLOP on the causal triangle, 3.27 us: bytes bound, and at 192 blocks
//     for 132 SMs the latency of one block's chain (load q, k, v, four tile
//     steps, store o) matters as much.  The design reads q and each k, v
//     tile once per block by TMA, keeps scores and probabilities in
//     registers, and writes o once by TMA.
//   * a long prompt (B=1, S=8192, same heads): 206 GFLOP, 0.21 ms at the
//     bf16 peak, against 0.10 GB of bytes (0.03 ms): operations bound.  The
//     design keeps the tensor cores fed: both products are wgmma, a
//     producer warp keeps the next k, v tiles in flight while the two
//     consumer warpgroups compute, inside a warpgroup the softmax of one
//     tile runs while the tensor cores do the previous tile's P v, and the
//     two warpgroups overlap each other.
//
// Design:
//   * One block per (b * H + h, 128-row q tile), 384 threads: warpgroups 0
//     and 1 each own 64 q rows (wgmma's M); warpgroup 2 is the producer, of
//     which one thread issues every TMA load.  blockIdx.x is b * H + h and
//     q tiles run heaviest first (blockIdx.y counts down the causal
//     triangle), so the long blocks start first and the 6 q heads of a kv
//     head run side by side and share its tiles in L2.
//   * q is loaded once; k and v tiles of 128 rows pass through a 2-stage
//     ring in shared memory, each tile with its own full and empty
//     mbarrier, so S = q k^T starts as soon as k has landed.  At D=128:
//     q 32 KB + 2 x (k 32 KB + v 32 KB) = 160 KB.
//   * TMA with 128-byte swizzle: a box row is at most 128 bytes (64 bf16),
//     so a D=128 row comes as two 64-column boxes, 16 KB apart for a
//     128-row tile, and the wgmma descriptors step across them.  Each
//     tensor is viewed as the 4-d tensor (D, heads, S, B); rows past S load
//     as zeros and are never stored (a TMA store clips at the edge).
//   * S = q k^T: wgmma m64n128k16, both operands K-major in shared memory,
//     fp32 accumulator in registers.  Online softmax in registers, in the
//     exp2 domain (scale * log2 e folded into one FFMA), row max across the
//     4 threads that share a row; only tiles that cross the diagonal or the
//     ragged edge mask, with -1e30 as _flash_kernel.  The running sum stays
//     a per-thread partial until the end.
//   * P is rounded to bf16 in registers, where the accumulator's layout is
//     already wgmma's A-fragment layout, and O += P v runs as wgmma with A
//     from registers and v read as an MN-major (transposed) B operand.
//   * Each warpgroup keeps two product groups in flight: it issues S of
//     tile j, then P v of tile j - 1, waits for S alone, runs the softmax
//     of tile j in place in fp32, and only then waits for P v, rescales O
//     and packs the new P.  The accumulator registers are pinned around
//     every wait (fence_regs), so the compiler moves nothing across them.
//   * o = acc / (l + 1e-30) goes to bf16 through the warpgroup's own q
//     tile in shared memory (swizzled as the TMA map expects) and one TMA
//     store per 64-column box.
//   * The producer warpgroup gives up registers (setmaxnreg 24) to the
//     consumers (240).
//
// C interface (loaded with ctypes): flash_attention_fwd_sm90 returns the
// cudaError_t of the launch as an int, 0 on success; an unsupported case
// returns cudaErrorInvalidValue, and a tensor map that the driver refuses
// returns 10000 + its CUresult.  cuTensorMapEncodeTiled comes from the
// driver through cudaGetDriverEntryPoint, so the library links only the
// CUDA runtime.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // q rows per block: two consumer warpgroups
constexpr int WG_ROWS = 64;      // q rows per consumer warpgroup (wgmma M)
constexpr int BN = 128;          // kv rows per tile
constexpr int STAGES = 2;        // k, v ring depth
constexpr int THREADS = 384;     // 2 consumer warpgroups + 1 producer
constexpr int CONSUMER_WARPS = 8;
constexpr int BOX_COLS = 64;     // bf16 columns in one 128-byte swizzled box row
constexpr float NEG_INF = -1e30f;

// Shared-memory byte offsets of one block, from a 1024-aligned base.
template <int D>
struct Smem {
  static constexpr int CHUNKS = D / BOX_COLS;
  static constexpr int Q_BOX = WG_ROWS * 128;        // one warpgroup's 64 x 64 box
  static constexpr int Q_CHUNK = 2 * Q_BOX;          // both warpgroups' boxes
  static constexpr int KV_CHUNK = BN * 128;          // one 128 x 64 box
  static constexpr int Q = 0;
  static constexpr int K = Q + CHUNKS * Q_CHUNK;
  static constexpr int V = K + STAGES * CHUNKS * KV_CHUNK;
  static constexpr int BAR = V + STAGES * CHUNKS * KV_CHUNK;
  // barriers: q_full, k_full[2], k_empty[2], v_full[2], v_empty[2]
  static constexpr int BYTES = BAR + 16 * 8 + 1024;  // + alignment slack
  static constexpr uint32_t TILE_BYTES = BN * D * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (PTX ISA, "Matrix Descriptor").
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the registers of an in-flight wgmma accumulator, so the compiler
// moves no read or write of them across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both operands K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to, int H, int Hkv, int S,
                      int causal, float scale_log2) {
  using L = Smem<D>;
  constexpr int CHUNKS = L::CHUNKS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;      // 128-byte swizzle needs 1024
  uint8_t* smem = smem_raw + (base - raw);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest q tiles first
  const int kv_end = causal ? min(S, q0 + BM) : S;
  const int n_tiles = (kv_end + BN - 1) / BN;

  // barriers: q_full, then k_full, k_empty, v_full, v_empty, one per stage
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

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, BM * D * 2);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int w = 0; w < 2; ++w)
          tma_load(base + L::Q + c * L::Q_CHUNK + w * L::Q_BOX, &tq, q_full,
                   c * BOX_COLS, h, q0 + w * WG_ROWS, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t prev = ((j / STAGES) - 1) & 1;  // parity of the stage's last use
        if (j >= STAGES) mbar_wait(k_empty + 8 * s, prev);
        mbar_expect_tx(k_full + 8 * s, L::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c)
          tma_load(base + L::K + (s * CHUNKS + c) * L::KV_CHUNK, &tk, k_full + 8 * s,
                   c * BOX_COLS, hk, j * BN, b);
        if (j >= STAGES) mbar_wait(v_empty + 8 * s, prev);
        mbar_expect_tx(v_full + 8 * s, L::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c)
          tma_load(base + L::V + (s * CHUNKS + c) * L::KV_CHUNK, &tv, v_full + 8 * s,
                   c * BOX_COLS, hk, j * BN, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows qw .. qw + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    // accumulator layout of wgmma m64nN: this thread holds rows row0 and
    // row0 + 8, columns 8 * n + col0 + {0, 1} of each 8-column block n
    const int row0 = (t / 32) * 16 + lane / 4;
    const int col0 = 2 * (lane % 4);
    const int qw = q0 + wg * WG_ROWS;
    const int qpos0 = qw + row0;
    const int qpos1 = qpos0 + 8;
    const uint32_t q_tile = base + L::Q + wg * L::Q_BOX;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF;   // running max of the raw scores
    float l0 = 0.f, l1 = 0.f;           // this thread's share of the running sum
    mbar_wait(q_full, 0);

    // S = q k^T of tile j into sc: D / 16 products stepping across the
    // 64-column boxes; committed as one group
    float sc[BN / 2];
    auto issue_s = [&](int j) {
      const uint32_t k_tile = base + L::K + (j % STAGES) * CHUNKS * L::KV_CHUNK;
      mbar_wait(k_full + 8 * (j % STAGES), (j / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32;  // 16 bf16 inside a 128-byte row
        wgmma_ss_n128(sc, smem_desc(q_tile + (kk / 4) * L::Q_CHUNK + step, 16, 1024),
                      smem_desc(k_tile + (kk / 4) * L::KV_CHUNK + step, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P v of tile j: 8 products over its 128 kv rows, v MN-major
    uint32_t p[BN / 16][4];
    auto issue_pv = [&](int j) {
      const uint32_t v_tile = base + L::V + (j % STAGES) * CHUNKS * L::KV_CHUNK;
      mbar_wait(v_full + 8 * (j % STAGES), (j / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv = smem_desc(v_tile + kk * 16 * 128, L::KV_CHUNK, 1024);
        if constexpr (D == 128) wgmma_rs_n128(o, p[kk], dv);
        else wgmma_rs_n64(o, p[kk], dv);
      }
      wgmma_commit();
    };
    // online softmax of tile j in place: sc becomes exp(S - m_new) in fp32;
    // returns the rescale factors of the two rows through alpha0, alpha1
    float alpha0, alpha1, rs0, rs1;
    auto softmax = [&](int j) {
      const int k0 = j * BN;
      if (k0 + BN > S || (causal && k0 + BN - 1 > qw)) {  // diagonal or ragged edge
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
    // P to bf16: the accumulator's layout is wgmma's A-fragment layout
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    };
    auto rescale = [&]() {
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? alpha1 : alpha0;
    };
    auto fence_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(p[kk][r])::"memory");
    };

    // Tile j's scores are computed while tile j - 1's P v runs: the two
    // groups are in flight together, and the softmax of j overlaps P v.
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(k_empty);
    softmax(0);
    rescale();
    pack_p();
    for (int j = 1; j < n_tiles; ++j) {
      issue_s(j);
      issue_pv(j - 1);
      wgmma_wait<1>();                 // S of tile j is done, P v may run on
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_empty + 8 * (j % STAGES));
      softmax(j);
      wgmma_wait<0>();                 // P v of tile j - 1 is done
      fence_regs(o);
      fence_p();
      if (lane == 0) mbar_arrive(v_empty + 8 * ((j - 1) % STAGES));
      rescale();
      pack_p();
    }
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_p();
    if (lane == 0) mbar_arrive(v_empty + 8 * ((n_tiles - 1) % STAGES));

    // o = acc / (l + 1e-30) in bf16, through this warpgroup's q tile
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / (l0 + 1e-30f);
    const float inv1 = 1.f / (l1 + 1e-30f);
    uint8_t* out = smem + L::Q + wg * L::Q_BOX;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint8_t* box = out + (n / 8) * L::Q_CHUNK + 4 * (lane % 4);
      const int swz0 = ((n % 8) ^ (row0 % 8)) * 16;  // row0 + 8 has the same row % 8
      *reinterpret_cast<uint32_t*>(box + row0 * 128 + swz0) =
          pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      *reinterpret_cast<uint32_t*>(box + (row0 + 8) * 128 + swz0) =
          pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
        tma_store(&to, q_tile + c * L::Q_CHUNK, c * BOX_COLS, h, qw, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// cuTensorMapEncodeTiled, from the driver at run time.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The (B, S, heads, D) bf16 tensor at `ptr` as the 4-d tensor (D, heads,
// S, B), read and written in 64-column, 128-byte-swizzled boxes of `rows`.
CUresult tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int D,
                    int heads, int S, int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX_COLS, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
           int S, int causal, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to;
  CUresult res;
  if ((res = tensor_map(encode, &tq, q, D, H, S, B, WG_ROWS)) != CUDA_SUCCESS ||
      (res = tensor_map(encode, &tk, k, D, Hkv, S, B, BN)) != CUDA_SUCCESS ||
      (res = tensor_map(encode, &tv, v, D, Hkv, S, B, BN)) != CUDA_SUCCESS ||
      (res = tensor_map(encode, &to, o, D, H, S, B, WG_ROWS)) != CUDA_SUCCESS)
    return 10000 + (int)res;
  // the shared-memory limit is raised once per device (at most 64 devices)
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(configured >> dev & 1ull)) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) configured |= 1ull << dev;
  }
  const dim3 grid(B * H, (S + BM - 1) / BM);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  flash_fwd_sm90_kernel<D><<<grid, THREADS, Smem<D>::BYTES, stream>>>(
      tq, tk, tv, to, H, Hkv, S, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q (B, S, H, D), k, v (B, S, Hkv, D), o like q; head_dim 64 or 128.
// Returns the cudaError_t of the launch (see the note at the top).
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k, const void* v,
                                        void* o, int B, int H, int Hkv, int S,
                                        int head_dim, int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (S + BM - 1) / BM > 65535 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(q, k, v, o, B, H, Hkv, S, causal, st);
  if (head_dim == 128) return launch<128>(q, k, v, o, B, H, Hkv, S, causal, st);
  return (int)cudaErrorInvalidValue;
}
