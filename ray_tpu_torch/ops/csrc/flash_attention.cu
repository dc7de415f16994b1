// Flash attention forward and backward for Hopper (sm_90a).
//
//   K1 replaces ray_tpu/ops/attention.py:_flash_kernel
//   K2 replaces ray_tpu/ops/attention.py:_flash_dq_kernel
//   K3 replaces ray_tpu/ops/attention.py:_flash_dkv_kernel
// Each has two designs, chosen by (dtype, D) alike for all three
// (`use_mma`):
//   bf16, D 64/128: flash_fwd_mma_kernel, flash_dq_mma_kernel and
//     flash_dkv_mma_kernel on the tensor cores;
//   f32, and bf16 at D 256: flash_fwd_kernel, flash_dq_kernel and
//     flash_dkv_kernel on the CUDA cores, in f32.
// `flash_attention_design` tells the caller which one a call runs; a
// launch that fails returns its error and is never retried on the other.
//
// Layout.  q, k, v, out and dout are contiguous [B, L, H, D] (the model's
// own layout), read in place: the row of (b, l, h) starts at
// ((b * L + l) * H + h) * D, so the TPU path's head folding (three
// transposes each way) has no counterpart here.  lse and delta are f32
// [B, H, Lq], LSE in natural log.  bf16 or f32 in; outputs in the input
// dtype.
//
// Semantics (those of the Pallas kernels):
//   s = (q * scale) . k, masked to NEG_INF = -1e30 where kv >= Lk or, when
//   causal, where the q position < the kv position (top-left alignment:
//   the wrapper sends only square causal calls);
//   K1: online softmax; O = acc / max(l, 1e-30), LSE = m + log(max(l, 1e-30));
//   K2: delta = rowsum(dO * O) (written out for K3), P = exp(s - LSE),
//       dS = P * (dO . V - delta), dq = dS K * scale;
//   K3: dv = P^T dO, dk = dS^T Q * scale.
// A masked entry gets P = 0 exactly.  Every kernel owns its output tile
// and loops over the other axis itself, so no output needs atomics and
// the result is deterministic, as the TPU's split into a dq pass and a
// dk/dv pass is:
//   K1, K2: one block per (q tile of 64 rows, batch*head); the loop walks
//     kv tiles, only up to the diagonal when causal.  The grid's x index
//     runs from the last q tile down, so the longest causal blocks start
//     first and the short ones fill the tail.
//   K3: one block per (kv tile, batch*head); the loop walks q tiles from
//     the diagonal on.
// A ragged last tile is zero-filled and masked; rows past a length are
// never written, so no length has to be a multiple of a tile.
//
// Bound at the GPT-2 train shape (B 24, L 1024, H 12, D 64, causal, bf16),
// counting each operand once and the visible pairs only: K1 moves 151 MB
// (0.045 ms at 3.35 TB/s) and does 38.7 GFLOP (0.039 ms at 989 TFLOP/s);
// K2 moves 229 MB (0.068 ms; it reads O and dO) and does 58 GFLOP (0.059
// ms); K3 moves 229 MB (0.068 ms) and does 77.4 GFLOP (0.078 ms).  K1 and
// K2 are bound by bytes, K3 by operations.  The CUDA cores' f32 peak (67
// TFLOP/s) is a fifteenth of the bf16 tensor cores', which is why bf16
// runs the mma kernels.
//
// ---- The tensor-core kernels (bf16, D 64 and 128) ----
//
// FlashAttention-2 form, mma.sync m16n8k16 bf16 -> f32:
//   128 threads = 4 warps per block, each warp owning 16 rows of the
//   block's 64-row tile (K1, K2: q rows; K3: kv rows).  Operands come from
//   shared memory through ldmatrix (.trans for the B operand of P V,
//   dS K, P^T dO and dS^T Q).  Tiles sit in shared memory as bf16 rows
//   whose 16-byte chunks are XOR-swizzled by (row & 7), so the 8 rows an
//   ldmatrix reads fall in 8 different bank groups.  The streamed tiles
//   (K1, K2: K and V; K3: Q, dO, LSE and delta) fill a two-stage ring
//   with cp.async (16 bytes a thread, zero-filled past a length) while
//   the other stage computes.
//   K1: Q is loaded once into registers as A fragments.  S = Q K^T
//     accumulates in f32; the online softmax runs on the accumulator
//     fragments (row max and sum over a quad, two __shfl_xor_sync), with
//     scale * log2(e) folded into one multiply and exp2f.  l sums the f32
//     P; the A operand of P V is P rounded to bf16, built in registers:
//     the m16n8 accumulators of two neighbouring n-tiles are the A
//     fragment of one k16 step, so P never goes through shared memory.
//   K2: the same walk as K1, with Q and dO as the A operands (held in
//     registers at D 64, read from shared memory at D 128 to keep the
//     registers for the 64 dQ sums).  Before the loop, while Q, dO and
//     the first K/V tile land, each quad sums delta = rowsum(dO * O) for
//     its two rows from global memory and writes it once.  Per kv tile:
//     S = Q K^T and dP = dO V^T; P = exp2(S scale log2(e) - LSE log2(e))
//     and dS = P (dP - delta) in f32 on the fragments; dQ += dS K with dS
//     rounded to bf16 in registers and K the B operand through
//     ldmatrix.trans, as K1 reads V.  dq is scaled once at the end.
//   K3: one block per (64 kv rows, batch*head) walks the q tiles from the
//     diagonal on.  K and V are A fragments (held in registers at D 64,
//     read from shared memory at D 128 to keep the registers for the dK
//     and dV sums).  S^T = K Q^T and dP^T = V dO^T; P^T = exp(S^T scale -
//     LSE) in f32, indexed by column; dS^T = P^T (dP^T - delta); then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to bf16 in
//     registers; dk is scaled once at the end.
//   The causal and ragged masks apply only on the diagonal tile and on a
//   tile that crosses a length.
// Precision: P (K1, K3) and dS (K2, K3) are rounded to bf16 (unit
// roundoff 2^-9) before the products that take them, as the JAX package's
// reference_attention rounds its probabilities to v's dtype before P V;
// sums, m, l, LSE and delta stay f32.  The outputs then differ from the
// f32 plain versions by up to about one bf16 ulp of each row's largest
// value (TENSOR_CORE_TOLERANCE in ops/attention.py).
//
// ---- The f32 kernels (f32 calls; bf16 at D 256) ----
//
// All arithmetic in f32 (as the Pallas kernels upcast every block), which
// keeps them within f32 rounding of their plain versions, as the f32
// calls need.  256 threads form a 16 x 16 grid: thread (ty, tx) owns rows
// ty + 16 i of the block's tile and columns tx + 16 j, so a row's 16
// owners are one half-warp and row max and row sum are four xor shuffles.
// Tiles are staged in shared memory as f32 with rows padded to D + 1
// floats, so the 16 different rows a half-warp reads at one column fall
// in 16 banks; every product is an fmaf loop (2 FMAs per shared load).
// Shared memory per block, 66-206 KB by kernel and D, always takes the
// opt-in above 48 KB (cudaFuncSetAttribute).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kBQ = 64;            // q rows per block in K1 and K2
constexpr float kNegInf = -1e30f;  // finite, as in the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Four consecutive elements as f32 (16-byte / 8-byte aligned loads).
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(u.x << 16);  // bf16 is the high half of an f32
  x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16);
  x[3] = __uint_as_float(u.y & 0xffff0000u);
}

// Rows [row0, row0 + n) of one (batch, head) slice, `stride` elements
// apart, into shared memory [n][D + 1] as f32 times `mul`; rows at or past
// `len` are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int n, int len, int stride,
                                          float mul) {
  constexpr int kVec = D / 4;
  for (int e = threadIdx.x; e < n * kVec; e += kThreads) {
    const int r = e / kVec;
    const int c = (e - r * kVec) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < len) load4(src + (size_t)(row0 + r) * stride + c, x);
    float* d = dst + r * (D + 1) + c;
    d[0] = x[0] * mul;
    d[1] = x[1] * mul;
    d[2] = x[2] * mul;
    d[3] = x[3] * mul;
  }
}

// Reductions over the 16 lanes of a half-warp (one tile row's owners).
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ bool visible(int qp, int kp, int kv_len,
                                        int causal) {
  return kp < kv_len && (!causal || qp >= kp);
}

// ---------------------------------------------------------------- K1

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int heads, int q_len, int kv_len, float scale, int causal) {
  constexpr int LD = D + 1, LP = BK + 1;
  constexpr int RQ = kBQ / 16, CK = BK / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [kBQ][LD], pre-scaled
  float* ks = qs + kBQ * LD;     // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][LD]
  float* ps = vs + BK * LD;      // [kBQ][LP]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int stride = heads * D;
  const size_t q_base = ((size_t)b * q_len * heads + h) * D;
  const size_t kv_base = ((size_t)b * kv_len * heads + h) * D;

  load_rows<T, D>(qs, q + q_base, q0, kBQ, q_len, stride, scale);
  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(kv_len, q0 + kBQ) : kv_len;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the last tile's reads of ks/vs/ps are done
    load_rows<T, D>(ks, k + kv_base, k0, BK, kv_len, stride, 1.f);
    load_rows<T, D>(vs, v + kv_base, k0, BK, kv_len, stride, 1.f);
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RQ], c[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) c[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    // Online softmax: each row's max and sum over its 16 owners.
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        if (!visible(qp, k0 + tx + 16 * j, kv_len, causal)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = visible(qp, k0 + tx + 16 * j, kv_len, causal)
                            ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V.  Rows of the tile past kv_len have P = 0 and V = 0.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[RQ], w[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) w[j] = vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= q_len) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* row = out + q_base + (size_t)qp * stride;
#pragma unroll
    for (int j = 0; j < CD; ++j) store(row + tx + 16 * j, acc[i][j] / l_safe);
    if (tx == 0) lse[(size_t)bh * q_len + qp] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------- K2

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ out,
    const T* __restrict__ dout, const float* __restrict__ lse,
    T* __restrict__ dq, float* __restrict__ delta, int heads, int q_len,
    int kv_len, float scale, int causal) {
  constexpr int LD = D + 1, LP = BK + 1;
  constexpr int RQ = kBQ / 16, CK = BK / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [kBQ][LD], pre-scaled
  float* dos = qs + kBQ * LD;    // [kBQ][LD]
  float* ks = dos + kBQ * LD;    // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][LD]
  float* dss = vs + BK * LD;     // [kBQ][LP]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int stride = heads * D;
  const size_t q_base = ((size_t)b * q_len * heads + h) * D;
  const size_t kv_base = ((size_t)b * kv_len * heads + h) * D;

  load_rows<T, D>(qs, q + q_base, q0, kBQ, q_len, stride, scale);
  load_rows<T, D>(dos, dout + q_base, q0, kBQ, q_len, stride, 1.f);
  __syncthreads();

  // delta = rowsum(dO * O), once for the block's rows; K3 reads it back.
  float lse_r[RQ], delta_r[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty + 16 * i;
    float part = 0.f;
    if (qp < q_len) {
      const T* orow = out + q_base + (size_t)qp * stride;
#pragma unroll
      for (int j = 0; j < CD; ++j)
        part += dos[(ty + 16 * i) * LD + tx + 16 * j] *
                to_f32(orow[tx + 16 * j]);
    }
    delta_r[i] = sum16(part);
    lse_r[i] = qp < q_len ? lse[(size_t)bh * q_len + qp] : 0.f;
    if (tx == 0 && qp < q_len) delta[(size_t)bh * q_len + qp] = delta_r[i];
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(kv_len, q0 + kBQ) : kv_len;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    load_rows<T, D>(ks, k + kv_base, k0, BK, kv_len, stride, 1.f);
    load_rows<T, D>(vs, v + kv_base, k0, BK, kv_len, stride, 1.f);
    __syncthreads();

    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[RQ], g[RQ], kk[CK], vv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        a[i] = qs[(ty + 16 * i) * LD + d];
        g[i] = dos[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        kk[j] = ks[(tx + 16 * j) * LD + d];
        vv[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = visible(qp, k0 + tx + 16 * j, kv_len, causal)
                            ? expf(s[i][j] - lse_r[i]) : 0.f;
        dss[(ty + 16 * i) * LP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[RQ], kk[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) ds[i] = dss[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) kk[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(ds[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= q_len) continue;
    T* row = dq + q_base + (size_t)qp * stride;
#pragma unroll
    for (int j = 0; j < CD; ++j) store(row + tx + 16 * j, acc[i][j] * scale);
  }
}

// ---------------------------------------------------------------- K3

template <typename T, int D, int BKV, int BQ>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int heads, int q_len,
    int kv_len, float scale, int causal) {
  constexpr int LD = D + 1, LP = BQ + 1;
  constexpr int RK = BKV / 16, CQ = BQ / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;              // [BKV][LD]
  float* vs = ks + BKV * LD;     // [BKV][LD]
  float* qs = vs + BKV * LD;     // [BQ][LD], pre-scaled
  float* dos = qs + BQ * LD;     // [BQ][LD]
  float* pt = dos + BQ * LD;     // [BKV][LP]  P^T
  float* dst = pt + BKV * LP;    // [BKV][LP]  dS^T
  float* lse_s = dst + BKV * LP; // [BQ]
  float* delta_s = lse_s + BQ;   // [BQ]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BKV;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int stride = heads * D;
  const size_t q_base = ((size_t)b * q_len * heads + h) * D;
  const size_t kv_base = ((size_t)b * kv_len * heads + h) * D;

  load_rows<T, D>(ks, k + kv_base, k0, BKV, kv_len, stride, 1.f);
  load_rows<T, D>(vs, v + kv_base, k0, BKV, kv_len, stride, 1.f);
  float acc_k[RK][CD], acc_v[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // Causal: q tiles that end before this kv tile starts see none of it.
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < q_len; q0 += BQ) {
    __syncthreads();
    load_rows<T, D>(qs, q + q_base, q0, BQ, q_len, stride, scale);
    load_rows<T, D>(dos, dout + q_base, q0, BQ, q_len, stride, 1.f);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool in = q0 + r < q_len;
      lse_s[r] = in ? lse[(size_t)bh * q_len + q0 + r] : 0.f;
      delta_s[r] = in ? delta[(size_t)bh * q_len + q0 + r] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T for this thread's kv rows x q columns.
    float s[RK][CQ], dp[RK][CQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kk[RK], vv[RK], a[CQ], g[CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        kk[i] = ks[(ty + 16 * i) * LD + d];
        vv[i] = vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CQ; ++j) {
        a[j] = qs[(tx + 16 * j) * LD + d];
        g[j] = dos[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          s[i][j] = fmaf(kk[i], a[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], g[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int kp = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CQ; ++j) {
        const int c = tx + 16 * j;
        const int qp = q0 + c;
        const float p = qp < q_len && visible(qp, kp, kv_len, causal)
                            ? expf(s[i][j] - lse_s[c]) : 0.f;
        pt[(ty + 16 * i) * LP + c] = p;
        dst[(ty + 16 * i) * LP + c] = p * (dp[i][j] - delta_s[c]);
      }
    }
    __syncthreads();

    // dv += P^T dO;  dk += dS^T (Q * scale).
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float p[RK], ds[RK], g[CD], a[CD];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        p[i] = pt[(ty + 16 * i) * LP + r];
        ds[i] = dst[(ty + 16 * i) * LP + r];
      }
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        g[j] = dos[r * LD + tx + 16 * j];
        a[j] = qs[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          acc_v[i][j] = fmaf(p[i], g[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(ds[i], a[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= kv_len) continue;
    const size_t off = kv_base + (size_t)kp * stride;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      store(dk + off + tx + 16 * j, acc_k[i][j]);
      store(dv + off + tx + 16 * j, acc_v[i][j]);
    }
  }
}

// ------------------------------------------- tensor-core (bf16) helpers

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps, 16 tile rows each
constexpr int kTile = 64;         // rows of every tile of K1 and K3
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Element offset of (row, col) in a [rows][D] bf16 tile whose 16-byte
// chunks are XOR-swizzled by row; col is a multiple of 8.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  return row * D + (((col >> 3) ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !pred (src stays a valid
// address either way).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane i gives the address of row (i & 7) of
// matrix i >> 3 and receives, in register j, its two elements of
// matrix j (transposed with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] b[16x8]: bf16 operands, f32 sums.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment addresses in a swizzled [rows][D] tile, for a warp's lane:
//   a_frag: the A operand (16 x 16 at row0, col0) of a row-major tile,
//     and with ldsm_x4_t the B operands of two n-tiles (cols col0 and
//     col0 + 8) over k rows row0 .. row0 + 15;
//   b_frag: the B operands of two n-tiles (rows row0 and row0 + 8 of a
//     tile stored [n][k]) over k cols col0 .. col0 + 15.
template <int D>
__device__ __forceinline__ const bf16* a_frag(const bf16* tile, int row0,
                                              int col0, int lane) {
  return tile + swz<D>(row0 + (lane & 15), col0 + (lane >> 4) * 8);
}
template <int D>
__device__ __forceinline__ const bf16* b_frag(const bf16* tile, int row0,
                                              int col0, int lane) {
  return tile + swz<D>(row0 + (lane & 7) + (lane >> 4) * 8,
                       col0 + ((lane >> 3) & 1) * 8);
}

// The A fragment of one k16 step from the f32 accumulators of two
// neighbouring n-tiles (rows g and g + 8, cols 2t, 2t + 1 of each),
// rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0,
                                         const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Rows [row0, row0 + kTile) of one (batch, head) slice into a swizzled
// tile with cp.async; rows at or past `len` are zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int len, int stride) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kMmaThreads; ++i) {
    const int e = threadIdx.x + i * kMmaThreads;
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool in = row0 + r < len;
    cp_async16(dst + swz<D>(r, c),
               src + (size_t)(in ? row0 + r : 0) * stride + c, in);
  }
}

// x = A B^T for a warp's 16 rows x kTile columns (kTile / 8 n-tiles):
// A [16 x D] is `af` (fragments in registers) when kRegs, else read from
// rows row_w .. row_w + 15 of `a_tile`; B is the [kTile x D] tile.
template <int D, bool kRegs>
__device__ __forceinline__ void gemm_abt(float (*x)[4],
                                         const uint32_t (*af)[4],
                                         const bf16* a_tile,
                                         const bf16* b_tile, int row_w,
                                         int lane) {
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    uint32_t a[4];
    if constexpr (kRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = af[j][e];
    } else {
      ldsm_x4(a, a_frag<D>(a_tile, row_w, 16 * j, lane));
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; n += 2) {
      uint32_t bb[4];
      ldsm_x4(bb, b_frag<D>(b_tile, 8 * n, 16 * j, lane));
      mma(x[n], a, bb[0], bb[1]);
      mma(x[n + 1], a, bb[2], bb[3]);
    }
  }
}

// acc [16 x D] += x y for a warp: x [16 x kTile] f32 fragments rounded
// to bf16 in registers, y the [kTile x D] tile.
template <int D>
__device__ __forceinline__ void gemm_acc(float (*acc)[4],
                                         const float (*x)[4], const bf16* y,
                                         int lane) {
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j) {
    uint32_t xa[4];
    acc_to_a(xa, x[2 * j], x[2 * j + 1]);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t bb[4];
      ldsm_x4_t(bb, a_frag<D>(y, 16 * j, 8 * n, lane));
      mma(acc[n], xa, bb[0], bb[1]);
      mma(acc[n + 1], xa, bb[2], bb[3]);
    }
  }
}

// ------------------------------------------------------------ K1 (mma)

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int heads, int q_len, int kv_len, float scale,
    int causal) {
  constexpr int KD = D / 16;     // k16 steps over the head dim
  constexpr int NS = kTile / 8;  // n-tiles of S (kv columns)
  constexpr int NO = D / 8;      // n-tiles of O (head-dim columns)
  constexpr int TILE = kTile * D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [TILE]
  bf16* ks = qs + TILE;                          // [2][TILE] ring
  bf16* vs = ks + 2 * TILE;                      // [2][TILE] ring
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_w = warp * 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest first
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int stride = heads * D;
  const size_t q_base = ((size_t)b * q_len * heads + h) * D;
  const size_t kv_base = ((size_t)b * kv_len * heads + h) * D;
  const int kv_end = causal ? min(kv_len, q0 + kTile) : kv_len;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  const float sl2 = scale * kLog2e;

  load_tile<D>(qs, q + q_base, q0, q_len, stride);
  cp_async_commit();
  load_tile<D>(ks, k + kv_base, 0, kv_len, stride);
  load_tile<D>(vs, v + kv_base, 0, kv_len, stride);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; K/V tile 0 may still be in flight
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j)
    ldsm_x4(qf[j], a_frag<D>(qs, row_w, 16 * j, lane));

  float acc[NO][4], m[2], l[2];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = -CUDART_INF_F;  // running max of S * scale * log2(e)
    l[r] = 0.f;            // this thread's part of the row sum
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTile, st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D>(ks + (st ^ 1) * TILE, k + kv_base, k0 + kTile, kv_len,
                   stride);
      load_tile<D>(vs + (st ^ 1) * TILE, v + kv_base, k0 + kTile, kv_len,
                   stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + st * TILE;
    const bf16* vt = vs + st * TILE;

    // S = Q K^T for the warp's 16 rows x 64 kv columns.
    float s[NS][4];
    gemm_abt<D, true>(s, qf, qs, kt, row_w, lane);

    // Element e of n-tile n is (row g + 8 (e >> 1), col 8 n + 2 t + (e & 1)).
    if ((causal && k0 + kTile > q0) || k0 + kTile > kv_len) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = q0 + row_w + g + (e >> 1) * 8;
          const int kp = k0 + 8 * n + 2 * t + (e & 1);
          if (kp >= kv_len || (causal && kp > qp)) s[n][e] = -CUDART_INF_F;
        }
    }

    // Online softmax on the fragments; a row's 4 owners are one quad.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * sl2);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(fmaf(s[n][2 * r + c], sl2, -m_use));
          s[n][2 * r + c] = p;
          sum += p;
        }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    gemm_acc<D>(acc, s, vt, lane);  // acc += P V, P rounded to bf16
    __syncthreads();  // every warp is done with stage st before its refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qp = q0 + row_w + g + 8 * r;
    if (qp >= q_len) continue;
    const float l_safe = fmaxf(sum, 1e-30f);
    const float inv = 1.f / l_safe;
    bf16* row = out + q_base + (size_t)qp * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    if (t == 0)
      lse[(size_t)bh * q_len + qp] =
          m[r] == -CUDART_INF_F ? kNegInf : m[r] * kLn2 + logf(l_safe);
  }
}

// ------------------------------------------------------------ K2 (mma)

// The f32 sum of the products of two rows' 8 bf16 elements (16 bytes).
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), s);
    s = fmaf(__uint_as_float(x[i] & 0xffff0000u),
             __uint_as_float(y[i] & 0xffff0000u), s);
  }
  return s;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ out,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    bf16* __restrict__ dq, float* __restrict__ delta, int heads, int q_len,
    int kv_len, float scale, int causal) {
  constexpr int KD = D / 16;     // k16 steps over the head dim
  constexpr int NS = kTile / 8;  // n-tiles of S and dP (kv columns)
  constexpr int NO = D / 8;      // n-tiles of dQ (head-dim columns)
  constexpr int TILE = kTile * D;
  constexpr bool kQRegs = D <= 64;  // Q, dO fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [TILE]
  bf16* dos = qs + TILE;                         // [TILE]
  bf16* ks = dos + TILE;                         // [2][TILE] ring
  bf16* vs = ks + 2 * TILE;                      // [2][TILE] ring
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_w = warp * 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest first
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int stride = heads * D;
  const size_t q_base = ((size_t)b * q_len * heads + h) * D;
  const size_t kv_base = ((size_t)b * kv_len * heads + h) * D;
  const int kv_end = causal ? min(kv_len, q0 + kTile) : kv_len;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  const float sl2 = scale * kLog2e;

  load_tile<D>(qs, q + q_base, q0, q_len, stride);
  load_tile<D>(dos, dout + q_base, q0, q_len, stride);
  cp_async_commit();
  load_tile<D>(ks, k + kv_base, 0, kv_len, stride);
  load_tile<D>(vs, v + kv_base, 0, kv_len, stride);
  cp_async_commit();

  // While those land: delta = rowsum(dO * O) and LSE * log2(e) for the
  // thread's rows g and g + 8, a row's 4 owners (one quad) taking every
  // fourth 16-byte chunk of it.  delta is written once, for K3.
  float lse_l2[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + row_w + g + 8 * r;
    const bool in = qp < q_len;
    float part = 0.f;
    if (in) {
      const size_t row = q_base + (size_t)qp * stride;
#pragma unroll
      for (int c = t; c < D / 8; c += 4)
        part += dot8(*reinterpret_cast<const uint4*>(out + row + 8 * c),
                     *reinterpret_cast<const uint4*>(dout + row + 8 * c));
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    delta_r[r] = part;
    lse_l2[r] = in ? lse[(size_t)bh * q_len + qp] * kLog2e : 0.f;
    if (in && t == 0) delta[(size_t)bh * q_len + qp] = part;
  }

  cp_async_wait<1>();  // Q and dO have landed; K/V tile 0 may be in flight
  __syncthreads();
  uint32_t qf[kQRegs ? KD : 1][4], dof[kQRegs ? KD : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      ldsm_x4(qf[j], a_frag<D>(qs, row_w, 16 * j, lane));
      ldsm_x4(dof[j], a_frag<D>(dos, row_w, 16 * j, lane));
    }
  }
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTile, st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D>(ks + (st ^ 1) * TILE, k + kv_base, k0 + kTile, kv_len,
                   stride);
      load_tile<D>(vs + (st ^ 1) * TILE, v + kv_base, k0 + kTile, kv_len,
                   stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + st * TILE;
    const bf16* vt = vs + st * TILE;

    // P = exp(S * scale - LSE), S = Q K^T for the warp's 16 q rows x 64 kv
    // columns; element e of n-tile n is (q row g + 8 (e >> 1), kv col
    // 8 n + 2 t + (e & 1)).
    float s[NS][4];
    gemm_abt<D, kQRegs>(s, qf, qs, kt, row_w, lane);
    const bool masked = (causal && k0 + kTile > q0) || k0 + kTile > kv_len;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], sl2, -lse_l2[e >> 1]));
        if (masked) {
          const int qp = q0 + row_w + g + (e >> 1) * 8;
          const int kp = k0 + 8 * n + 2 * t + (e & 1);
          if (kp >= kv_len || (causal && kp > qp)) p = 0.f;
        }
        s[n][e] = p;
      }

    // dS = P (dP - delta), dP = dO V^T; then dQ += dS K.
    float dp[NS][4];
    gemm_abt<D, kQRegs>(dp, dof, dos, vt, row_w, lane);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - delta_r[e >> 1];
    gemm_acc<D>(acc, s, kt, lane);  // dS rounded to bf16
    __syncthreads();  // every warp is done with stage st before its refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + row_w + g + 8 * r;
    if (qp >= q_len) continue;
    bf16* row = dq + q_base + (size_t)qp * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

// ------------------------------------------------------------ K3 (mma)

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int q_len,
    int kv_len, float scale, int causal) {
  constexpr int KD = D / 16;     // k16 steps over the head dim
  constexpr int NS = kTile / 8;  // n-tiles of S^T (q columns)
  constexpr int NO = D / 8;      // n-tiles of dK, dV (head-dim columns)
  constexpr int TILE = kTile * D;
  constexpr bool kKVRegs = D <= 64;  // K, V fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [TILE]
  bf16* vs = ks + TILE;                          // [TILE]
  bf16* qs = vs + TILE;                          // [2][TILE] ring
  bf16* dos = qs + 2 * TILE;                     // [2][TILE] ring
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TILE);  // [2][kTile]
  float* delta_s = lse_s + 2 * kTile;                       // [2][kTile]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_w = warp * 16;
  const int k0 = blockIdx.x * kTile;  // block 0 has the most q tiles
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int stride = heads * D;
  const size_t q_base = ((size_t)b * q_len * heads + h) * D;
  const size_t kv_base = ((size_t)b * kv_len * heads + h) * D;
  const float* lse_bh = lse + (size_t)bh * q_len;
  const float* delta_bh = delta + (size_t)bh * q_len;
  // Causal: q tiles that end before this kv tile starts see none of it.
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = (q_len - q_begin + kTile - 1) / kTile;
  const float sl2 = scale * kLog2e;

  auto load_q_stage = [&](int st, int q0) {
    load_tile<D>(qs + st * TILE, q + q_base, q0, q_len, stride);
    load_tile<D>(dos + st * TILE, dout + q_base, q0, q_len, stride);
    const int r = threadIdx.x & (kTile - 1);
    const bool in = q0 + r < q_len;
    const float* src = threadIdx.x < kTile ? lse_bh : delta_bh;
    float* dst = threadIdx.x < kTile ? lse_s : delta_s;
    cp_async4(dst + st * kTile + r, src + (in ? q0 + r : 0), in);
  };
  load_tile<D>(ks, k + kv_base, k0, kv_len, stride);
  load_tile<D>(vs, v + kv_base, k0, kv_len, stride);
  load_q_stage(0, q_begin);
  cp_async_commit();

  uint32_t kf[kKVRegs ? KD : 1][4], vf[kKVRegs ? KD : 1][4];
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * kTile, st = it & 1;
    if (it + 1 < n_tiles) {
      load_q_stage(st ^ 1, q0 + kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kKVRegs) {
      if (it == 0) {
#pragma unroll
        for (int j = 0; j < KD; ++j) {
          ldsm_x4(kf[j], a_frag<D>(ks, row_w, 16 * j, lane));
          ldsm_x4(vf[j], a_frag<D>(vs, row_w, 16 * j, lane));
        }
      }
    }
    const bf16* qt = qs + st * TILE;
    const bf16* dot = dos + st * TILE;
    const float* ls = lse_s + st * kTile;
    const float* dls = delta_s + st * kTile;

    // P^T = exp(S^T * scale - LSE), S^T = K Q^T for the warp's 16 kv rows
    // x 64 q columns; element e of n-tile n is (kv row g + 8 (e >> 1),
    // q col 8 n + 2 t + (e & 1)).
    float s[NS][4];
    gemm_abt<D, kKVRegs>(s, kf, ks, qt, row_w, lane);
    const bool masked = (causal && q0 < k0 + kTile) || q0 + kTile > q_len;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int c = 8 * n + 2 * t;
      const float2 lv = *reinterpret_cast<const float2*>(ls + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse_l2 = ((e & 1) ? lv.y : lv.x) * kLog2e;
        float p = exp2f(fmaf(s[n][e], sl2, -lse_l2));
        if (masked) {
          const int qp = q0 + c + (e & 1);
          const int kp = k0 + row_w + g + (e >> 1) * 8;
          if (qp >= q_len || (causal && qp < kp)) p = 0.f;
        }
        s[n][e] = p;
      }
    }
    gemm_acc<D>(dv_acc, s, dot, lane);  // dV += P^T dO

    // dS^T = P^T (dP^T - delta), dP^T = V dO^T.
    float dp[NS][4];
    gemm_abt<D, kKVRegs>(dp, vf, vs, dot, row_w, lane);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 dl = *reinterpret_cast<const float2*>(dls + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] *= dp[n][e] - ((e & 1) ? dl.y : dl.x);
    }
    gemm_acc<D>(dk_acc, s, qt, lane);  // dK += dS^T Q
    __syncthreads();  // every warp is done with stage st before its refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + row_w + g + 8 * r;
    if (kp >= kv_len) continue;
    const size_t off = kv_base + (size_t)kp * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
          pack_bf16(dk_acc[j][2 * r] * scale, dk_acc[j][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
          pack_bf16(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- launch

struct Shape {
  int batch, heads, q_len, kv_len;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// kv tile of K1/K2 and both tiles of K3: 64, or 32 at D = 256 so that the
// tiles fit in shared memory and the accumulators in registers.
template <int D>
constexpr int tile() { return D == 256 ? 32 : 64; }

// K1, K2 and K3 run on the tensor cores for bf16 at D 64 and 128.  At
// D 256 K3's dK and dV sums alone would take 256 registers a thread at
// 64-row tiles, so bf16 there keeps the f32 kernels, all three alike.
template <typename T, int D>
constexpr bool use_mma() {
  return std::is_same<T, bf16>::value && D <= 128;
}

template <typename T, int D>
struct Forward {
  static cudaError_t run(const Shape& p, const void* q, const void* k,
                         const void* v, void* out, void* lse) {
    dim3 grid((p.q_len + kBQ - 1) / kBQ, p.batch * p.heads);
    if constexpr (use_mma<T, D>()) {
      const size_t smem = sizeof(bf16) * 5 * kTile * D;
      auto kernel = flash_fwd_mma_kernel<D>;
      cudaError_t err = opt_in(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kMmaThreads, smem, p.stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(out),
          static_cast<float*>(lse), p.heads, p.q_len, p.kv_len, p.scale,
          p.causal);
      return cudaGetLastError();
    } else {
      constexpr int BK = tile<D>();
      const size_t smem =
          sizeof(float) * ((size_t)(kBQ + 2 * BK) * (D + 1) +
                           (size_t)kBQ * (BK + 1));
      auto kernel = flash_fwd_kernel<T, D, BK>;
      cudaError_t err = opt_in(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, p.stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out),
          static_cast<float*>(lse), p.heads, p.q_len, p.kv_len, p.scale,
          p.causal);
      return cudaGetLastError();
    }
  }
};

template <typename T, int D>
struct Dq {
  static cudaError_t run(const Shape& p, const void* q, const void* k,
                         const void* v, const void* out, const void* dout,
                         const void* lse, void* dq, void* delta) {
    dim3 grid((p.q_len + kBQ - 1) / kBQ, p.batch * p.heads);
    if constexpr (use_mma<T, D>()) {
      const size_t smem = sizeof(bf16) * 6 * kTile * D;
      auto kernel = flash_dq_mma_kernel<D>;
      cudaError_t err = opt_in(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kMmaThreads, smem, p.stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(out),
          static_cast<const bf16*>(dout), static_cast<const float*>(lse),
          static_cast<bf16*>(dq), static_cast<float*>(delta), p.heads,
          p.q_len, p.kv_len, p.scale, p.causal);
      return cudaGetLastError();
    } else {
      constexpr int BK = tile<D>();
      const size_t smem =
          sizeof(float) * ((size_t)(2 * kBQ + 2 * BK) * (D + 1) +
                           (size_t)kBQ * (BK + 1));
      auto kernel = flash_dq_kernel<T, D, BK>;
      cudaError_t err = opt_in(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, p.stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(out),
          static_cast<const T*>(dout), static_cast<const float*>(lse),
          static_cast<T*>(dq), static_cast<float*>(delta), p.heads, p.q_len,
          p.kv_len, p.scale, p.causal);
      return cudaGetLastError();
    }
  }
};

template <typename T, int D>
struct Dkv {
  static cudaError_t run(const Shape& p, const void* q, const void* k,
                         const void* v, const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv) {
    if constexpr (use_mma<T, D>()) {
      const size_t smem =
          sizeof(bf16) * 6 * kTile * D + sizeof(float) * 4 * kTile;
      auto kernel = flash_dkv_mma_kernel<D>;
      cudaError_t err = opt_in(kernel, smem);
      if (err != cudaSuccess) return err;
      dim3 grid((p.kv_len + kTile - 1) / kTile, p.batch * p.heads);
      kernel<<<grid, kMmaThreads, smem, p.stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), p.heads, p.q_len,
          p.kv_len, p.scale, p.causal);
      return cudaGetLastError();
    } else {
      constexpr int BKV = tile<D>(), BQ = tile<D>();
      const size_t smem =
          sizeof(float) * ((size_t)(2 * BKV + 2 * BQ) * (D + 1) +
                           2 * (size_t)BKV * (BQ + 1) + 2 * (size_t)BQ);
      auto kernel = flash_dkv_kernel<T, D, BKV, BQ>;
      cudaError_t err = opt_in(kernel, smem);
      if (err != cudaSuccess) return err;
      dim3 grid((p.kv_len + BKV - 1) / BKV, p.batch * p.heads);
      kernel<<<grid, kThreads, smem, p.stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dk), static_cast<T*>(dv), p.heads, p.q_len,
          p.kv_len, p.scale, p.causal);
      return cudaGetLastError();
    }
  }
};

// Kernel<T, D>::run(args...) for dtype 0 = float32 or 1 = bfloat16 and
// head_dim 64, 128 or 256: the one place that maps the two to a kernel.
template <template <typename, int> class Kernel, typename... Args>
cudaError_t by_type(int dtype, int head_dim, Args... args) {
#define RAY_TPU_FLASH_D(T)                                      \
  switch (head_dim) {                                           \
    case 64: return Kernel<T, 64>::run(args...);                \
    case 128: return Kernel<T, 128>::run(args...);              \
    case 256: return Kernel<T, 256>::run(args...);              \
    default: return cudaErrorInvalidValue;                      \
  }
  if (dtype == 0) RAY_TPU_FLASH_D(float)
  if (dtype == 1) RAY_TPU_FLASH_D(__nv_bfloat16)
#undef RAY_TPU_FLASH_D
  return cudaErrorInvalidValue;
}

template <template <typename, int> class Kernel, typename... Args>
cudaError_t dispatch(int dtype, int head_dim, const Shape& p, Args... args) {
  if (p.batch * p.heads == 0 || p.q_len == 0) return cudaSuccess;
  if (p.batch < 0 || p.heads < 0 || p.q_len < 0 || p.kv_len <= 0 ||
      p.batch * p.heads > 65535 || (p.causal && p.q_len != p.kv_len))
    return cudaErrorInvalidValue;
  return by_type<Kernel>(dtype, head_dim, p, args...);
}

// Reports use_mma<T, D>() through the same mapping as the launches.
template <typename T, int D>
struct Design {
  static cudaError_t run(int* tensor_cores) {
    *tensor_cores = use_mma<T, D>() ? 1 : 0;
    return cudaSuccess;
  }
};

}  // namespace

// Each entry point launches one kernel on `stream` and returns the
// launch's cudaError_t (0 = cudaSuccess).

extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int heads, int q_len, int kv_len, int head_dim, float scale,
    int causal, int dtype, void* stream) {
  const Shape p{batch, heads, q_len, kv_len, scale, causal,
                static_cast<cudaStream_t>(stream)};
  return dispatch<Forward>(dtype, head_dim, p, q, k, v, out, lse);
}

extern "C" int flash_attention_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* delta, int batch,
    int heads, int q_len, int kv_len, int head_dim, float scale, int causal,
    int dtype, void* stream) {
  const Shape p{batch, heads, q_len, kv_len, scale, causal,
                static_cast<cudaStream_t>(stream)};
  return dispatch<Dq>(dtype, head_dim, p, q, k, v, out, dout, lse, dq, delta);
}

extern "C" int flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int heads, int q_len, int kv_len, int head_dim, float scale, int causal,
    int dtype, void* stream) {
  const Shape p{batch, heads, q_len, kv_len, scale, causal,
                static_cast<cudaStream_t>(stream)};
  return dispatch<Dkv>(dtype, head_dim, p, q, k, v, dout, lse, delta, dk, dv);
}

// Which design K1, K2 and K3 run for (dtype, head_dim): 1 = the
// tensor-core kernels (bf16 mma.sync), 0 = the f32 CUDA-core kernels,
// -1 = no kernel takes the pair.  The three always share one design.
extern "C" int flash_attention_design(int dtype, int head_dim) {
  int tensor_cores = 0;
  return by_type<Design>(dtype, head_dim, &tensor_cores) == cudaSuccess
             ? tensor_cores
             : -1;
}
