// Flash attention (online softmax) for Hopper, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
//   (body _flash_kernel), together with the kv-head repeat of its GQA wrapper
//   src/repro/kernels/flash_attention/ops.py::flash_attention.
//
// It computes softmax(q k^T / sqrt(D) [+ causal mask of -1e30]) v with the
// running max m, running sum l and accumulator acc in fp32, and writes
// acc / (l + 1e-30) in q's dtype: the same function as _flash_kernel.
//
// Layout: q, o are (B, S, H, D) and k, v are (B, S, Hkv, D), contiguous, so
// q head h reads kv head h / (H / Hkv) directly: GQA by index, with no
// repeated copy of k and v.  The (BH, S, D) layout is the case H = Hkv = 1.
//
// What bounds it on the H100: at the serving shape (B=4, S=512, H=12,
// Hkv=2, D=128, bf16, causal) the function must move about 15 MB (q and o
// 6.3 MB each, k and v 1.0 MB each), 4.4 us at 3.35 TB/s, against about
// 3.2 GFLOP on the causal triangle, 3.3 us at the bf16 tensor-core peak:
// memory bound, with little room between the two.  The design keeps every
// intermediate (scores, probabilities, m, l, acc) on chip, reads each q tile
// once and each k, v tile once per q tile, and reads k, v at Hkv heads.
// This first version multiplies with plain fp32 FMA from shared memory, not
// with the tensor cores, so it runs far above that bound: mma/wgmma and TMA
// are the next step.
//
// Design, against the TPU kernel:
//   * One thread block per (b * H + h, 64-row q tile).  The kv axis, a
//     sequential grid axis on the TPU, is a loop inside the block.
//   * q is staged once in shared memory, k and v tiles of 32 rows per
//     iteration, all converted to fp32 (76 KB at D=128, so the dynamic
//     shared-memory limit is raised).
//   * 256 threads: 4 lanes per q row.  Each lane owns 8 of the 32 scores of
//     its row and D/4 of its output columns; row max and row sum are reduced
//     across the 4 lanes with warp shuffles, and the probabilities pass
//     through a small shared tile to the P.V product.
//   * Causal blocks loop only up to the diagonal, which replaces the
//     @pl.when skip of fully masked tiles; q tiles are issued heaviest first.
//   * Any S: fixed tiles, with the ragged edge masked (out-of-range keys get
//     -1e30, out-of-range q rows are computed and not stored), where the TPU
//     kernel shrinks its blocks to a divisor of S.
//
// C interface (loaded with ctypes): flash_attention_fwd returns the
// cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>
#include <cmath>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 32;        // kv rows per loop step
constexpr int THREADS = 256;  // 4 lanes per q row
constexpr int LANES = 4;      // lanes sharing one q row
constexpr int PAD = 4;        // fp32 row padding of the q, k, v tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// rows x D values of a (.., S, heads, D) tensor, starting at sequence row
// `row0`, into a shared fp32 tile of stride D + PAD; rows at or past S are 0.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int rows,
                                           int row0, int S, int64_t row_stride) {
  constexpr int V = D / 4;  // 4-wide vectors per row
  for (int e = threadIdx.x; e < rows * V; e += THREADS) {
    const int r = e / V;
    const int c = (e - r * V) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) val = load4(src + (int64_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * (D + PAD) + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int H, int Hkv, int S, int causal, float scale) {
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);     // BQ x (D + PAD)
  float* sK = sQ + BQ * (D + PAD);                   // BK x (D + PAD)
  float* sV = sK + BK * (D + PAD);                   // BK x (D + PAD)
  float* sP = sV + BK * (D + PAD);                   // BQ x (BK + 1)

  const int qt = gridDim.x - 1 - blockIdx.x;         // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;

  const int64_t q_row = (int64_t)H * D;              // stride of one sequence row
  const int64_t kv_row = (int64_t)Hkv * D;
  const T* qb = q + (int64_t)b * S * q_row + (int64_t)h * D;
  const T* kb = k + (int64_t)b * S * kv_row + (int64_t)hk * D;
  const T* vb = v + (int64_t)b * S * kv_row + (int64_t)hk * D;
  T* ob = o + (int64_t)b * S * q_row + (int64_t)h * D;

  const int r = threadIdx.x / LANES;                 // this lane's q row in the tile
  const int cl = threadIdx.x % LANES;                // lane within the row
  const int qpos = q0 + r;

  stage_tile<T, D>(sQ, qb, BQ, q0, S, q_row);

  constexpr int NS = BK / LANES;                     // scores per lane
  constexpr int NO = D / (4 * LANES);                // float4 outputs per lane
  float4 acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_run = NEG_INF;
  float l_run = 0.f;

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const float* qrow = sQ + r * (D + PAD);
  float* prow = sP + r * (BK + 1);

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                                 // previous tile consumed
    stage_tile<T, D>(sK, kb, BK, k0, S, kv_row);
    stage_tile<T, D>(sV, vb, BK, k0, S, kv_row);
    __syncthreads();

    // scores of columns cl, cl + 4, ..., cl + 28 of this row
    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(
            sK + (cl + LANES * j) * (D + PAD) + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int kpos = k0 + cl + LANES * j;
      s[j] *= scale;
      if (kpos >= S || (causal && kpos > qpos)) s[j] = NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }
    // the 4 lanes of a row are adjacent lanes of one warp
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_new = fmaxf(m_run, m_tile);
    const float alpha = expf(m_run - m_new);
    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p = expf(s[j] - m_new);
      l_tile += p;
      prow[cl + LANES * j] = p;
    }
    l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 1);
    l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 2);
    l_run = l_run * alpha + l_tile;
    m_run = m_new;
    __syncwarp();                                    // the row's p is in sP

    // acc = acc * alpha + p . v over this lane's columns 4*cl + 16*i
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
    }
    const int kv_rows = min(BK, kv_end - k0);
    for (int c = 0; c < kv_rows; ++c) {
      const float p = prow[c];
      const float* vrow = sV + c * (D + PAD) + 4 * cl;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(vrow + 16 * i);
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
  }

  if (qpos < S) {
    const float inv = 1.f / (l_run + 1e-30f);
    T* orow = ob + (int64_t)qpos * q_row + 4 * cl;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      store4(orow + 16 * i, make_float4(acc[i].x * inv, acc[i].y * inv,
                                        acc[i].z * inv, acc[i].w * inv));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int Hkv, int S, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + PAD) + (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, S, causal, (float)(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an unsupported case).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int Hkv, int S,
                                   int head_dim, int dtype, int causal,
                                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return (int)launch<float, 64>(q, k, v, o, B, H, Hkv, S, causal, st);
  if (dtype == 0 && head_dim == 128)
    return (int)launch<float, 128>(q, k, v, o, B, H, Hkv, S, causal, st);
  if (dtype == 1 && head_dim == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, o, B, H, Hkv, S, causal, st);
  if (dtype == 1 && head_dim == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, o, B, H, Hkv, S, causal, st);
  return (int)cudaErrorInvalidValue;
}
