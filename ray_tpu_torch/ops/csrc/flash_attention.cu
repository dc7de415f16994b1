// Flash attention forward and backward for Hopper (sm_90a): three kernels.
//
//   K1 flash_fwd_kernel  replaces ray_tpu/ops/attention.py:_flash_kernel
//   K2 flash_dq_kernel   replaces ray_tpu/ops/attention.py:_flash_dq_kernel
//   K3 flash_dkv_kernel  replaces ray_tpu/ops/attention.py:_flash_dkv_kernel
//
// Layout.  q, k, v, out and dout are contiguous [B, L, H, D] (the model's
// own layout), read in place: the row of (b, l, h) starts at
// ((b * L + l) * H + h) * D, so the TPU path's head folding (three
// transposes each way) has no counterpart here.  lse and delta are f32
// [B, H, Lq].  bf16 or f32 in; all arithmetic in f32 (as the Pallas
// kernels upcast every block); outputs in the input dtype.
//
// Semantics (those of the Pallas kernels):
//   s = (q * scale) . k, masked to NEG_INF = -1e30 where kv >= Lk or, when
//   causal, where the q position < the kv position (top-left alignment:
//   the wrapper sends only square causal calls);
//   K1: online softmax; O = acc / max(l, 1e-30), LSE = m + log(max(l, 1e-30));
//   K2: delta = rowsum(dO * O) (written out for K3), P = exp(s - LSE),
//       dS = P * (dO . V - delta), dq = dS K * scale;
//   K3: dv = P^T dO, dk = dS^T Q * scale.
// A masked entry gets P = 0 exactly, as exp(-1e30 - m) is in f32.
//
// Design.  The TPU grid (bh, q_block, kv_block) runs in order on one core
// and carries m/l/acc in VMEM from step to step.  Here blocks run in
// parallel in no order, so each block owns its output tile and loops over
// the other axis itself:
//   K1, K2: one block per (q tile of 64 rows, batch*head); the loop walks
//     kv tiles, only up to the diagonal when causal.  The grid's x index
//     runs from the last q tile down, so the longest causal blocks start
//     first and the short ones fill the tail.
//   K3: one block per (kv tile, batch*head); the loop walks q tiles from
//     the diagonal on, accumulating dk and dv in registers, each written
//     once.  No atomics anywhere: the result is deterministic, as the
//     TPU's split into a dq pass and a dk/dv pass is.
// 256 threads form a 16 x 16 grid: thread (ty, tx) owns rows ty + 16 i of
// the block's tile and columns tx + 16 j, so a row's 16 owners are one
// half-warp and row max and row sum are four xor shuffles.  Tiles are
// staged in shared memory as f32 with rows padded to D + 1 floats, so the
// 16 different rows a half-warp reads at one column fall in 16 banks.  A
// ragged last tile is zero-filled and masked; rows past a length are
// never written, so no length has to be a multiple of a tile.
// Shared memory per block, 66-206 KB by kernel and D, always takes the
// opt-in above 48 KB (cudaFuncSetAttribute).
//
// Bound.  At the GPT-2 train shape (B 24, L 1024, H 12, D 64, causal,
// bf16) each kernel reads and writes ~150-230 MB, 0.05-0.07 ms at
// 3.35 TB/s, and does 39-77 GFLOP, 0.04-0.08 ms on the bf16 tensor
// cores: K1 and K2 are bound by bytes, K3 (which reads delta, not O)
// by operations, each at 0.05-0.08 ms.  This first version does its
// products on the CUDA cores in f32 (67 TFLOP/s peak, 2 FMAs per shared
// load), so it is bound by operations on the CUDA cores instead; the step
// to the bound is bf16 tensor-core products (mma.sync, then wgmma with
// TMA-fed tiles), left to a later change.  Keeping P in f32 is what keeps
// the kernels within f32 rounding of their plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T, int D>
struct Forward {
  static cudaError_t run(const Shape& p, const void* q, const void* k,
                         const void* v, void* out, void* lse) {
    constexpr int BK = tile<D>();
    const size_t smem =
        sizeof(float) * ((size_t)(kBQ + 2 * BK) * (D + 1) +
                         (size_t)kBQ * (BK + 1));
    auto kernel = flash_fwd_kernel<T, D, BK>;
    cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.q_len + kBQ - 1) / kBQ, p.batch * p.heads);
    kernel<<<grid, kThreads, smem, p.stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), p.heads, p.q_len, p.kv_len, p.scale,
        p.causal);
    return cudaGetLastError();
  }
};

template <typename T, int D>
struct Dq {
  static cudaError_t run(const Shape& p, const void* q, const void* k,
                         const void* v, const void* out, const void* dout,
                         const void* lse, void* dq, void* delta) {
    constexpr int BK = tile<D>();
    const size_t smem =
        sizeof(float) * ((size_t)(2 * kBQ + 2 * BK) * (D + 1) +
                         (size_t)kBQ * (BK + 1));
    auto kernel = flash_dq_kernel<T, D, BK>;
    cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.q_len + kBQ - 1) / kBQ, p.batch * p.heads);
    kernel<<<grid, kThreads, smem, p.stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(out),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<T*>(dq), static_cast<float*>(delta), p.heads, p.q_len,
        p.kv_len, p.scale, p.causal);
    return cudaGetLastError();
  }
};

template <typename T, int D>
struct Dkv {
  static cudaError_t run(const Shape& p, const void* q, const void* k,
                         const void* v, const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv) {
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
        static_cast<T*>(dk), static_cast<T*>(dv), p.heads, p.q_len, p.kv_len,
        p.scale, p.causal);
    return cudaGetLastError();
  }
};

// dtype 0 = float32, 1 = bfloat16; head_dim 64, 128 or 256.
template <template <typename, int> class Kernel, typename... Args>
cudaError_t dispatch(int dtype, int head_dim, const Shape& p, Args... args) {
  if (p.batch * p.heads == 0 || p.q_len == 0) return cudaSuccess;
  if (p.batch < 0 || p.heads < 0 || p.q_len < 0 || p.kv_len <= 0 ||
      p.batch * p.heads > 65535 || (p.causal && p.q_len != p.kv_len))
    return cudaErrorInvalidValue;
#define RAY_TPU_FLASH_D(T)                                      \
  switch (head_dim) {                                           \
    case 64: return Kernel<T, 64>::run(p, args...);             \
    case 128: return Kernel<T, 128>::run(p, args...);           \
    case 256: return Kernel<T, 256>::run(p, args...);           \
    default: return cudaErrorInvalidValue;                      \
  }
  if (dtype == 0) RAY_TPU_FLASH_D(float)
  if (dtype == 1) RAY_TPU_FLASH_D(__nv_bfloat16)
#undef RAY_TPU_FLASH_D
  return cudaErrorInvalidValue;
}

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
