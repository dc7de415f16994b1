// Single-query paged-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_paged_decode_kernel.
// One query per lane attends over that lane's block table into a paged
// K/V pool:
//
//   q            [B, H, D]        bf16 or f32
//   k_pool/v_pool [NB, BS, KH, D] same dtype as q
//   block_tables [B, MB] int32    physical block of each logical block
//   ctx_lens     [B] int32        tokens in the pool, the current one included
//   out          [B, H, D]        q's dtype
//
// with query head h = kv * q_per_kv + i reading kv head kv (GQA), positions
// >= ctx_len masked to NEG_INF = -1e30, an online softmax in f32, and the
// normaliser clamped to 1e-30 at the end.  A lane with ctx_len = 0 reads
// nothing and writes zeros, as the TPU kernel does (every block gated
// off); the engine never sends 0 (padding lanes get ctx_len = 1).
//
// Design.  The TPU grid (lane, kv_block) runs in order on one core and
// carries m/l/acc in VMEM from step to step; here blocks run in parallel
// and in no order, so one thread block owns one (lane, kv_head) pair and
// loops over the lane's context itself, reading its own table entries
// (scalar prefetch has no counterpart).  The context is walked in tiles
// of kTile positions that may straddle pool blocks: each warp takes some
// positions of the tile, loads the K row (coalesced along D), scores it
// against the q_per_kv query heads held pre-scaled in shared memory, and
// stages the V row in shared memory.  One thread per query head then folds
// the tile into the running max/sum, and every thread updates its own
// slice of the [q_per_kv, D] accumulator, also in shared memory.  Table
// entries past the context are never read; positions past ctx_len inside
// the last tile are masked.
//
// Bound.  Decode reads every K and V row of the context once:
// sum over lanes of ctx_len * KH * D * 2 * sizeof(dtype) bytes, over the
// H100's 3.35 TB/s.  The arithmetic (4 * ctx_len * H * D flops per lane)
// is far below the card's rate, so the kernel is bound by bytes.
//
// What this simple design leaves on the table (later work):
//   * one block per (lane, kv_head) gives B * KH blocks: with few lanes or
//     long contexts the card is under-filled; split-K (flash-decoding)
//     over the context with a second reduction pass fixes that;
//   * loads are synchronous and at most 4-16 bytes a thread; cp.async or
//     TMA with a ring of tiles would keep more bytes in flight;
//   * the accumulator and scores live in shared memory rather than
//     registers, and the per-head softmax step runs on q_per_kv threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;           // context positions per tile
constexpr float kNegInf = -1e30f;   // finite, as in the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ ctx_lens, T* __restrict__ out, int n_heads,
    int kv_heads, int block_size, int max_blocks, float scale) {
  constexpr int kPerLane = D / 32;
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int qpk = n_heads / kv_heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float smem[];
  float* q_s = smem;                  // [qpk, D], pre-scaled
  float* acc_s = q_s + qpk * D;       // [qpk, D]
  float* v_s = acc_s + qpk * D;       // [kTile, D]
  float* p_s = v_s + kTile * D;       // [qpk, kTile] scores, then probs
  float* m_s = p_s + qpk * kTile;     // [qpk] running max
  float* l_s = m_s + qpk;             // [qpk] running sum
  float* alpha_s = l_s + qpk;         // [qpk] rescale of this tile

  const size_t head0 = ((size_t)b * n_heads + (size_t)kv * qpk) * D;
  for (int e = tid; e < qpk * D; e += kThreads) {
    q_s[e] = to_f32(q[head0 + e]) * scale;
    acc_s[e] = 0.f;
  }
  for (int i = tid; i < qpk; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  // The TPU kernel sweeps the MB table entries only: never read past them.
  const int ctx = min(ctx_lens[b], max_blocks * block_size);
  const int32_t* table = block_tables + (size_t)b * max_blocks;
  const size_t row_stride = (size_t)kv_heads * D;           // one position
  const size_t block_stride = (size_t)block_size * row_stride;

  for (int base = 0; base < ctx; base += kTile) {
    // 1. Scores of this tile's positions, and their V rows into smem.
    for (int p = warp; p < kTile; p += kWarps) {
      const int pos = base + p;
      if (pos < ctx) {
        const size_t off = (size_t)table[pos / block_size] * block_stride +
                           (size_t)(pos % block_size) * row_stride +
                           (size_t)kv * D;
        float kr[kPerLane];
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          kr[j] = to_f32(k_pool[off + lane + 32 * j]);
          v_s[p * D + lane + 32 * j] = to_f32(v_pool[off + lane + 32 * j]);
        }
        for (int i = 0; i < qpk; ++i) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < kPerLane; ++j)
            s += q_s[i * D + lane + 32 * j] * kr[j];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          if (lane == 0) p_s[i * kTile + p] = s;
        }
      } else {
        // Masked: probability exactly 0, and a zero V row so that
        // 0 * (stale shared memory) can never turn into NaN.
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) v_s[p * D + lane + 32 * j] = 0.f;
        for (int i = lane; i < qpk; i += 32) p_s[i * kTile + p] = kNegInf;
      }
    }
    __syncthreads();

    // 2. Online softmax, one thread per query head.
    for (int i = tid; i < qpk; i += kThreads) {
      float* row = p_s + i * kTile;
      float m_new = m_s[i];
      for (int p = 0; p < kTile; ++p) m_new = fmaxf(m_new, row[p]);
      float sum = 0.f;
      for (int p = 0; p < kTile; ++p) {
        const float e = expf(row[p] - m_new);
        row[p] = e;
        sum += e;
      }
      const float alpha = expf(m_s[i] - m_new);
      alpha_s[i] = alpha;
      m_s[i] = m_new;
      l_s[i] = l_s[i] * alpha + sum;
    }
    __syncthreads();

    // 3. acc = acc * alpha + P V, each thread on its own accumulator slots.
    for (int e = tid; e < qpk * D; e += kThreads) {
      const int i = e / D;
      const int d = e % D;
      const float* prow = p_s + i * kTile;
      float a = acc_s[e] * alpha_s[i];
#pragma unroll 8
      for (int p = 0; p < kTile; ++p) a += prow[p] * v_s[p * D + d];
      acc_s[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < qpk * D; e += kThreads)
    out[head0 + e] = from_f32<T>(acc_s[e] / fmaxf(l_s[e / D], 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_tables, const void* ctx_lens, void* out,
                   int batch, int n_heads, int kv_heads, int block_size,
                   int max_blocks, float scale, cudaStream_t stream) {
  const int qpk = n_heads / kv_heads;
  const size_t smem =
      sizeof(float) * (2 * (size_t)qpk * D + (size_t)kTile * D +
                       (size_t)qpk * kTile + 3 * (size_t)qpk);
  auto kernel = paged_decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(kv_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(ctx_lens), static_cast<T*>(out), n_heads,
      kv_heads, block_size, max_blocks, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int head_dim, const void* q, const void* k_pool,
                       const void* v_pool, const void* block_tables,
                       const void* ctx_lens, void* out, int batch,
                       int n_heads, int kv_heads, int block_size,
                       int max_blocks, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, block_tables, ctx_lens, out,
                           batch, n_heads, kv_heads, block_size, max_blocks,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, block_tables, ctx_lens, out,
                            batch, n_heads, kv_heads, block_size, max_blocks,
                            scale, stream);
    case 256:
      return launch<T, 256>(q, k_pool, v_pool, block_tables, ctx_lens, out,
                            batch, n_heads, kv_heads, block_size, max_blocks,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* ctx_lens, void* out, int batch,
    int n_heads, int kv_heads, int head_dim, int block_size, int max_blocks,
    float scale, int dtype, void* stream) {
  if (batch == 0) return cudaSuccess;
  if (kv_heads <= 0 || n_heads % kv_heads != 0 || batch > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(head_dim, q, k_pool, v_pool, block_tables,
                             ctx_lens, out, batch, n_heads, kv_heads,
                             block_size, max_blocks, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(head_dim, q, k_pool, v_pool,
                                     block_tables, ctx_lens, out, batch,
                                     n_heads, kv_heads, block_size,
                                     max_blocks, scale, s);
  return cudaErrorInvalidValue;
}
