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
// off); the engine never sends 0 (padding lanes get ctx_len = 1).  Table
// entries past the context are never read.
//
// Design: split-context ("flash-decoding"), two kernels from one entry
// point.  The TPU grid (lane, kv_block) runs in order on one core and
// carries m/l/acc in VMEM from step to step; here the context is cut
// into splits of `split_len` positions that run in parallel:
//   1. paged_decode_split_kernel: one block per (kv head, lane, split)
//      (and per group of QH <= 8 of the kv head's query heads, when
//      q_per_kv > 8 or is odd).  The split count is fixed by the table
//      width (max_blocks * block_size), not by ctx_lens, so the host
//      never blocks on the device; a split that starts at or past its
//      lane's context writes an empty partial (m = -inf, l = 0) and stops.
//      Inside a split a group of up to 32 neighbouring threads owns one
//      position's row at a time and reads it in 16-byte loads (bf16 at
//      D 64: a 128-byte row is 8 threads, so a warp reads 4 positions per
//      load; f32 at D 256, a 1 KB row, is one warp with two loads a
//      thread).  Each group walks every (groups)-th position of the
//      split, up to 4 positions per step, all loads of a step issued
//      before any is used.  The QH query heads' q, pre-scaled by
//      scale * log2(e), the online softmax (m, l) and the [QH, D]
//      accumulator live in registers, each thread holding its own slice
//      of D; a score is reduced over the group by xor shuffles.  At the
//      end the groups merge once through shared memory, and the split
//      writes its partial (m in log2 units, l, unnormalised acc) in f32.
//   2. paged_decode_merge_kernel: one block per (query head, lane) folds
//      the lane's partials by their LSE weights, in split order (so the
//      result is deterministic), and writes acc / max(l, 1e-30).
// The wrapper allocates the partials; the kernels allocate nothing.
//
// Sliding window (window > 0, the window layers of a model that mixes
// window and full attention): the query at ctx_len - 1 sees positions
// p > ctx_len - 1 - window only.  The launch then counts its splits from
// the lane's first visible position rounded down to a split, base =
// floor(max(ctx_len - window, 0) / split_len) * split_len, and runs only
// the ceil((window + split_len - 1) / split_len) splits that can hold a
// visible position (fewer where the table is narrower), so a step reads
// min(ctx_len, window) positions a lane and launches no block for the
// rest of the table.  The windowed launches are kernels of their own
// names, paged_decode_window_split_kernel and
// paged_decode_window_merge_kernel, which a device trace can select;
// without a window the two kernels above run as before, to the bit.
//
// Bound.  Decode reads every K and V row of the context once:
// sum over lanes of ctx_len * KH * D * 2 * sizeof(dtype) bytes, over the
// H100's 3.35 TB/s.  The arithmetic (4 * ctx_len * H * D flops per lane)
// is far below the card's rate, so the kernel is bound by bytes.  The
// partials add 4 * (D + 2) bytes per (lane, head, split) each way, small
// beside the K/V rows at the splits used.
//
// What this design leaves on the table (later work): the block-table
// lookups and address arithmetic sit on the load path of each position
// (TMA or a cp.async ring with prefetched block numbers would take them
// off); the merge is a second launch, where a last-block-done counter
// could fold it into the first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;
constexpr int kMergeThreads = 64;
constexpr float kNegInf = -1e30f;   // finite, as in the reference
constexpr float kLog2e = 1.4426950408889634f;

// 16 bytes of a row as f32: 4 floats or 8 bf16 (bf16 is the high half of
// an f32).
__device__ __forceinline__ void unpack(const uint4& u, float* x, float) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* x,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// How a block's threads share the rows of (T, D): a row is kRowVecs
// 16-byte vectors; a group of kGroup <= 32 neighbouring threads owns one
// position's row, thread j of it vectors j, j + kGroup, ... (kVecs of
// them, kElems elements).
template <typename T, int D>
struct Geometry {
  static constexpr int kEv = 16 / sizeof(T);  // elements per vector
  static constexpr int kRowVecs = D / kEv;
  static constexpr int kGroup = kRowVecs < 32 ? kRowVecs : 32;
  static constexpr int kVecs = kRowVecs / kGroup;
  static constexpr int kElems = kVecs * kEv;
  static constexpr int kGroups = kThreads / kGroup;
};

// One split of one lane's context for QH query heads of one kv head; with
// kWindow the splits count from the lane's window base and positions at
// or before ctx_len - 1 - window are not read.
template <typename T, int D, int QH, bool kWindow>
__device__ __forceinline__ void decode_split(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ ctx_lens, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int n_heads, int kv_heads, int block_size,
    int max_blocks, int split_len, float scale, int window) {
  using G = Geometry<T, D>;
  constexpr int E = G::kElems, EV = G::kEv;
  // Positions per group in flight at a time: 4 rows of one load a
  // thread, fewer where a row takes two loads or several heads' q and
  // acc already hold the registers (at 4, f32 with QH 2 spills).
  constexpr int U = (QH >= 2 ? 2 : 4) / G::kVecs;
  __shared__ __align__(16) float acc_s[G::kGroups][QH][D];
  __shared__ float m_s[G::kGroups][QH], l_s[G::kGroups][QH];
  __shared__ float w_s[G::kGroups][QH], ml_s[QH][2];

  const int qpk = n_heads / kv_heads;
  const int n_hg = qpk / QH;  // head groups per kv head
  const int kv = blockIdx.x / n_hg;
  const int h0 = kv * qpk + (blockIdx.x - kv * n_hg) * QH;
  const int b = blockIdx.y;
  const int split = blockIdx.z, n_splits = gridDim.z;
  const int grp = threadIdx.x / G::kGroup, j = threadIdx.x % G::kGroup;
  // Head h0 + i's partial of this split is number part + i * n_splits.
  const size_t part = ((size_t)b * n_heads + h0) * n_splits + split;

  const int ctx = min(ctx_lens[b], max_blocks * block_size);
  // The lane's first visible position and the first position of split 0.
  const int lo = kWindow ? max(ctx - window, 0) : 0;
  const int lane_base = kWindow ? lo / split_len * split_len : 0;
  const int first = lane_base + split * split_len;
  const int start = kWindow ? max(first, lo) : first;
  if (start >= ctx || (kWindow && first + split_len <= lo)) {
    if (threadIdx.x < QH) {
      float* ml = part_ml + 2 * (part + (size_t)threadIdx.x * n_splits);
      ml[0] = -CUDART_INF_F;
      ml[1] = 0.f;
    }
    return;
  }
  const int n = min(first + split_len, ctx) - start;

  // q of the QH heads, this thread's elements, times scale * log2(e).
  float qr[QH][E], m[QH], l[QH], acc[QH][E];
#pragma unroll
  for (int i = 0; i < QH; ++i) {
    const T* row = q + ((size_t)b * n_heads + h0 + i) * D;
#pragma unroll
    for (int v = 0; v < G::kVecs; ++v)
      unpack(*reinterpret_cast<const uint4*>(row + (v * G::kGroup + j) * EV),
             qr[i] + v * EV, T());
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[i][e] *= scale * kLog2e;
      acc[i][e] = 0.f;
    }
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  const int32_t* table = block_tables + (size_t)b * max_blocks;
  const size_t row_stride = (size_t)kv_heads * D;  // one position
  const size_t block_stride = (size_t)block_size * row_stride;
  const T* k_head = k_pool + (size_t)kv * D;
  const T* v_head = v_pool + (size_t)kv * D;

  // Every thread runs every step (the shuffles need the whole warp);
  // positions past the split are masked.
  for (int base = 0; base < n; base += G::kGroups * U) {
    uint4 kr[U][G::kVecs], vr[U][G::kVecs];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * G::kGroups + grp;
      ok[u] = i < n;
      if (ok[u]) {
        const int pos = start + i;
        const int blk = pos / block_size;
        const size_t off = (size_t)__ldg(table + blk) * block_stride +
                           (size_t)(pos - blk * block_size) * row_stride;
        const uint4* kp = reinterpret_cast<const uint4*>(k_head + off);
        const uint4* vp = reinterpret_cast<const uint4*>(v_head + off);
#pragma unroll
        for (int v = 0; v < G::kVecs; ++v) {
          kr[u][v] = __ldg(kp + v * G::kGroup + j);
          vr[u][v] = __ldg(vp + v * G::kGroup + j);
        }
      } else {
#pragma unroll
        for (int v = 0; v < G::kVecs; ++v)
          kr[u][v] = vr[u][v] = make_uint4(0u, 0u, 0u, 0u);
      }
    }

    // Scores of the U positions for each head, reduced over the group.
    float s[U][QH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
#pragma unroll
      for (int v = 0; v < G::kVecs; ++v) unpack(kr[u][v], kf + v * EV, T());
#pragma unroll
      for (int i = 0; i < QH; ++i) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(qr[i][e], kf[e], x);
#pragma unroll
        for (int o = G::kGroup / 2; o > 0; o >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, o);
        s[u][i] = ok[u] ? x : kNegInf;
      }
    }

    // Online softmax over the step's positions, then acc += P V.
    float vf[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int v = 0; v < G::kVecs; ++v) unpack(vr[u][v], vf[u] + v * EV, T());
#pragma unroll
    for (int i = 0; i < QH; ++i) {
      float mx = m[i];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][i]);
      const float alpha = exp2f(m[i] - mx);
      m[i] = mx;
      float p[U], sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = ok[u] ? exp2f(s[u][i] - mx) : 0.f;
        sum += p[u];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[i][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][e], a);
        acc[i][e] = a;
      }
    }
  }

  // Merge the groups: each group's (m, l, acc) into shared memory, then
  // the weights exp2(m_g - M), then every (head, d) of the split.
#pragma unroll
  for (int i = 0; i < QH; ++i) {
    if (j == 0) {
      m_s[grp][i] = m[i];
      l_s[grp][i] = l[i];
    }
#pragma unroll
    for (int v = 0; v < G::kVecs; ++v)
#pragma unroll
      for (int c = 0; c < EV; c += 4)
        *reinterpret_cast<float4*>(&acc_s[grp][i][(v * G::kGroup + j) * EV +
                                                  c]) =
            make_float4(acc[i][v * EV + c], acc[i][v * EV + c + 1],
                        acc[i][v * EV + c + 2], acc[i][v * EV + c + 3]);
  }
  __syncthreads();
  if (threadIdx.x < QH) {
    const int i = threadIdx.x;
    float mx = kNegInf;
    for (int g = 0; g < G::kGroups; ++g) mx = fmaxf(mx, m_s[g][i]);
    float sum = 0.f;
    for (int g = 0; g < G::kGroups; ++g) {
      w_s[g][i] = exp2f(m_s[g][i] - mx);
      sum += w_s[g][i] * l_s[g][i];
    }
    ml_s[i][0] = mx;
    ml_s[i][1] = sum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < QH * D; e += kThreads) {
    const int i = e / D, d = e - i * D;
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < G::kGroups; ++g) a = fmaf(w_s[g][i], acc_s[g][i][d], a);
    part_acc[(part + (size_t)i * n_splits) * D + d] = a;
  }
  if (threadIdx.x < QH) {
    float* ml = part_ml + 2 * (part + (size_t)threadIdx.x * n_splits);
    ml[0] = ml_s[threadIdx.x][0];
    ml[1] = ml_s[threadIdx.x][1];
  }
}

template <typename T, int D, int QH>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ ctx_lens, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int n_heads, int kv_heads, int block_size,
    int max_blocks, int split_len, float scale) {
  decode_split<T, D, QH, false>(q, k_pool, v_pool, block_tables, ctx_lens,
                                part_ml, part_acc, n_heads, kv_heads,
                                block_size, max_blocks, split_len, scale, 0);
}

template <typename T, int D, int QH>
__global__ void __launch_bounds__(kThreads) paged_decode_window_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ ctx_lens, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int n_heads, int kv_heads, int block_size,
    int max_blocks, int split_len, float scale, int window) {
  decode_split<T, D, QH, true>(q, k_pool, v_pool, block_tables, ctx_lens,
                               part_ml, part_acc, n_heads, kv_heads,
                               block_size, max_blocks, split_len, scale,
                               window);
}

// One block per (query head, lane): the lane's partials, in split order.
// An empty split (m = -inf) has weight 0 and its acc is never read; a
// lane with no context at all (every split empty) writes zeros.
template <typename T>
__device__ __forceinline__ void decode_merge(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    T* __restrict__ out, int n_splits, int head_dim) {
  const size_t bh = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const float* ml = part_ml + 2 * bh * n_splits;
  const float* acc = part_acc + bh * n_splits * head_dim;
  float mx = -CUDART_INF_F;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  const float m_use = mx == -CUDART_INF_F ? 0.f : mx;
  float sum = 0.f;
  for (int s = 0; s < n_splits; ++s)
    sum += exp2f(ml[2 * s] - m_use) * ml[2 * s + 1];
  const float l_safe = fmaxf(sum, 1e-30f);
  for (int d = threadIdx.x; d < head_dim; d += kMergeThreads) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s)
      if (ml[2 * s] != -CUDART_INF_F)
        a = fmaf(exp2f(ml[2 * s] - m_use), acc[(size_t)s * head_dim + d], a);
    store(out + bh * head_dim + d, a / l_safe);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMergeThreads) paged_decode_merge_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    T* __restrict__ out, int n_splits, int head_dim) {
  decode_merge<T>(part_ml, part_acc, out, n_splits, head_dim);
}

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    paged_decode_window_merge_kernel(const float* __restrict__ part_ml,
                                     const float* __restrict__ part_acc,
                                     T* __restrict__ out, int n_splits,
                                     int head_dim) {
  decode_merge<T>(part_ml, part_acc, out, n_splits, head_dim);
}

struct Args {
  const void *q, *k_pool, *v_pool, *block_tables, *ctx_lens;
  void *out, *part_ml, *part_acc;
  int batch, n_heads, kv_heads, head_dim, block_size, max_blocks, split_len,
      n_splits;
  float scale;
  int window;  // 0: no window
  cudaStream_t stream;
};

template <typename T, int D, int QH>
cudaError_t launch_split(const Args& a) {
  dim3 grid(a.kv_heads * (a.n_heads / a.kv_heads / QH), a.batch, a.n_splits);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k_pool);
  const T* v = static_cast<const T*>(a.v_pool);
  const auto* tables = static_cast<const int32_t*>(a.block_tables);
  const auto* ctx = static_cast<const int32_t*>(a.ctx_lens);
  auto* ml = static_cast<float*>(a.part_ml);
  auto* acc = static_cast<float*>(a.part_acc);
  if (a.window > 0)
    paged_decode_window_split_kernel<T, D, QH>
        <<<grid, kThreads, 0, a.stream>>>(
            q, k, v, tables, ctx, ml, acc, a.n_heads, a.kv_heads,
            a.block_size, a.max_blocks, a.split_len, a.scale, a.window);
  else
    paged_decode_split_kernel<T, D, QH><<<grid, kThreads, 0, a.stream>>>(
        q, k, v, tables, ctx, ml, acc, a.n_heads, a.kv_heads, a.block_size,
        a.max_blocks, a.split_len, a.scale);
  return cudaGetLastError();
}

// QH: the most query heads of one kv head a block takes, 8, 4, 2 or 1,
// whichever is the largest to divide q_per_kv.
template <typename T, int D>
cudaError_t launch_split_qh(const Args& a) {
  const int qpk = a.n_heads / a.kv_heads;
  if (qpk % 8 == 0) return launch_split<T, D, 8>(a);
  if (qpk % 4 == 0) return launch_split<T, D, 4>(a);
  if (qpk % 2 == 0) return launch_split<T, D, 2>(a);
  return launch_split<T, D, 1>(a);
}

template <typename T>
cudaError_t launch(const Args& a) {
  if (a.n_splits > 0) {
    cudaError_t err;
    switch (a.head_dim) {
      case 64: err = launch_split_qh<T, 64>(a); break;
      case 128: err = launch_split_qh<T, 128>(a); break;
      case 256: err = launch_split_qh<T, 256>(a); break;
      default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
  }
  dim3 grid(a.n_heads, a.batch);
  const auto* ml = static_cast<const float*>(a.part_ml);
  const auto* acc = static_cast<const float*>(a.part_acc);
  if (a.window > 0)
    paged_decode_window_merge_kernel<T><<<grid, kMergeThreads, 0, a.stream>>>(
        ml, acc, static_cast<T*>(a.out), a.n_splits, a.head_dim);
  else
    paged_decode_merge_kernel<T><<<grid, kMergeThreads, 0, a.stream>>>(
        ml, acc, static_cast<T*>(a.out), a.n_splits, a.head_dim);
  return cudaGetLastError();
}

}  // namespace

// part_ml [B, H, n_splits, 2] and part_acc [B, H, n_splits, D], f32, are
// the caller's scratch; n_splits must be ceil(max_blocks * block_size /
// split_len), and with a window (window > 0) the least of that and
// ceil((window + split_len - 1) / split_len).  dtype: 0 = float32,
// 1 = bfloat16.  Launches both kernels on `stream`; returns the first
// failing launch's cudaError_t.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* ctx_lens, void* out,
    void* part_ml, void* part_acc, int batch, int n_heads, int kv_heads,
    int head_dim, int block_size, int max_blocks, int split_len,
    int n_splits, float scale, int dtype, int window, void* stream) {
  if (batch == 0) return cudaSuccess;
  const long long width = (long long)max_blocks * block_size;
  long long want = split_len > 0 ? (width + split_len - 1) / split_len : -1;
  if (window > 0 && split_len > 0)
    want = std::min(want, ((long long)window + 2 * split_len - 2) /
                              split_len);  // ceil((window + split_len - 1) / split_len)
  if ((head_dim != 64 && head_dim != 128 && head_dim != 256) ||
      kv_heads <= 0 || n_heads % kv_heads != 0 || batch > 65535 ||
      n_heads > 65535 || block_size <= 0 || max_blocks < 0 ||
      split_len <= 0 || window < 0 || n_splits > 65535 || n_splits != want)
    return cudaErrorInvalidValue;
  const Args a{q,          k_pool,    v_pool,     block_tables, ctx_lens,
               out,        part_ml,   part_acc,   batch,        n_heads,
               kv_heads,   head_dim,  block_size, max_blocks,   split_len,
               n_splits,   scale,     window,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch<float>(a);
  if (dtype == 1) return launch<__nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}
