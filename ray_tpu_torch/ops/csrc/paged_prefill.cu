// Paged chunked-prefill attention for Hopper (sm_90a): K5.
//
// Replaces no TPU kernel.  The JAX package sends every multi-token
// (T > 1) paged-attention call to its masked-dense path
// (ray_tpu/ops/attention.py:paged_attention_reference): gather every
// lane's whole block table, attend over all of it, mask.  On the card
// that path copied all lanes' K/V over the whole table to f32 in every
// layer and ran f32 products on the CUDA cores.  This kernel computes
// the same function from each lane's own visible context:
//
//   q             [B, T, H, D]     bf16
//   k_pool/v_pool [NB, BS, KH, D]  bf16; query head h = kv * q_per_kv + i
//                                  reads kv head kv (GQA)
//   block_tables  [B, MB] int32    physical block of each logical block
//   ctx_lens      [B] int32        tokens in the pool, this chunk's included
//   q_positions   [B, T] int64     each query's absolute position
//   out           [B, T, H, D]     bf16
//
// Query (b, t) sees key position p iff p <= q_positions[b, t],
// p < ctx_lens[b] and p < MB * BS; scores, the softmax and the sums are
// f32.  A row that sees no key writes zeros, as K4 does for ctx_len = 0
// (the plain version gives a uniform average over the table there; the
// engine never sends such a row).  Table entries past a lane's last
// visible key are never read.
//
// Sliding window (window > 0, the window layers of a model that mixes
// window and full attention): query (b, t) also needs p > q_positions[b,
// t] - window.  The splits then count from the lane's window base, its
// first query's first visible key rounded down to a split (the queries of
// a lane ascend by one from its first, as every caller sends them), and
// only the ceil((window + split_len + T - 2) / split_len) splits that can
// hold a visible key are launched (fewer where the table is narrower); a
// block reads from the first key that one of its rows sees.  A row whose
// keys lie in one split is written there; the others are merged over the
// splits they reach.  The windowed launches are kernels of their own
// names, paged_prefill_window_split_kernel and
// paged_prefill_window_merge_kernel, which a device trace can select;
// without a window the two kernels below run as before, to the bit.
//
// Bound.  The work is each visible K and V row read once: sum over lanes
// of min(ctx_len, max_t q_position + 1) * KH * D * 2 * 2 bytes over the
// H100's 3.35 TB/s, beside q and out.  Per row of K/V the kernel does
// 6 * D flops for each of the T * q_per_kv query rows that read it (Q K^T
// once, P V twice, below): at T 32, q_per_kv 1 that is ~48 flops a byte,
// far below the ~295 at which the tensor cores, not the memory, would
// bound it.  So the design spends its effort on reading each byte once
// and keeping loads in flight:
//   1. paged_prefill_split_kernel: one block per (kv head, row block of
//      64 query rows, lane, context split of PREFILL_SPLIT_LEN positions).
//      A block's rows are the lane's T x q_per_kv queries of one kv head,
//      row r = t * q_per_kv + i, so a K/V row fetched once serves every
//      query that reads it (the row blocks of one kv head sit next to each
//      other in the grid and share the rest through L2).  The split count
//      is fixed by the table's width, as K4's, so the host never waits on
//      the device.  A block first reads its rows' limits
//      min(ctx_len, q_position + 1); a split that starts at or past all of
//      them exits before any load (the riders of a prefill dispatch,
//      ctx_len 1, and the unused width of the table cost nothing).  The
//      split's physical row numbers are looked up from the table once, into
//      shared memory, before the first tile; then the block walks its keys
//      in tiles of 64 (32 at D 256), each K and V row in 16-byte cp.async
//      loads into a two-stage ring in shared memory, the next tile in
//      flight while this one computes.  Q K^T runs on the tensor cores
//      (mma.sync m16n8k16 bf16 -> f32, K1's fragments: ldmatrix from
//      XOR-swizzled tiles), each warp 16 query rows; scores are scaled by
//      scale * log2(e) in f32 after the product (q is not pre-scaled in
//      bf16, which would round it), masked per row, and folded by an
//      online softmax in f32.  P V keeps P at f32 accuracy, as the plain
//      version's f32 P: P = hi + lo with hi = bf16(P), lo = bf16(P - hi),
//      two mma per tile, nearly free in a kernel bound by bytes.  A warp
//      whose 16 rows are all padding (T * q_per_kv < 64) loads but skips
//      the products.  A row whose limit lies in split 0 (a rider, a short
//      context, a row that sees no key) is done there: split 0 writes its
//      output, acc / max(l, 1e-30) in bf16, zeros where it sees no key.
//      Every other row that sees the split writes its partial: m (log2
//      units), l and the unnormalised acc, in f32.  A block of a split
//      past its lane's ctx_len exits on reading it.
//   2. paged_prefill_merge_kernel: one warp per output row whose limit
//      reaches past split 0 folds the splits it reaches, in split order
//      (the result is deterministic), and writes acc / max(l, 1e-30) in
//      bf16.  Not launched when the table fits in one split.
// The wrapper allocates the partials; the kernels allocate nothing.
//
// What this design leaves on the table (later work).  At the serve
// cell's prefill dispatch (32 lanes, T 32, 32 heads of 128) it takes
// 0.129 ms a layer, 42% of its bytes bound, on an H100: every block of a
// split past its lane's context still starts, holding its shared memory,
// before it exits; a block keeps one tile in flight; a row block's Q is
// read again by every split; the merge is a second launch and its
// partials a round trip through L2, where a last-block counter could
// fold it into the first.  At D 256 the split kernel takes all 255
// registers and spills 32 bytes.  wgmma and TMA would cut the issue
// slots of the loads and products, which matter only once the loads are
// no longer the limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // 4 warps, 16 query rows each
constexpr int kRows = 64;       // query rows per block
constexpr int kMergeThreads = 256;  // 8 warps, a row at a time each
constexpr int kMergeRowsPerWarp = 8;
constexpr float kLog2e = 1.4426950408889634f;

// Keys per tile: 64, or 32 at D 256 so that the tiles fit in shared
// memory and the [16 x D] accumulators in registers.
template <int D>
__host__ __device__ constexpr int key_tile() {
  return D == 256 ? 32 : 64;
}

// ---- tensor-core helpers (as in flash_attention.cu; each kernel source
// compiles on its own, with a plain C interface)

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

// The A fragments of one k16 step of P V from the f32 probabilities of
// two neighbouring n-tiles (rows g and g + 8, cols 2t, 2t + 1 of each):
// hi = bf16(P) and lo = bf16(P - hi), so hi + lo carries P to about
// 2^-17 of itself.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}
__device__ __forceinline__ void probs_to_a(uint32_t* hi, uint32_t* lo,
                                           const float* c0,
                                           const float* c1) {
  split_bf16(c0[0], c0[1], hi + 0, lo + 0);
  split_bf16(c0[2], c0[3], hi + 1, lo + 1);
  split_bf16(c1[0], c1[1], hi + 2, lo + 2);
  split_bf16(c1[2], c1[3], hi + 3, lo + 3);
}

// One tile of KT key positions from `first` on, K and V rows of this
// block's kv head, into stage buffers with cp.async; positions at or
// past `end` are zeros.  rows_s holds the pool row of each position of
// the split, from `start` on.
template <int D, int KT>
__device__ __forceinline__ void load_kv(bf16* kd, bf16* vd,
                                        const bf16* k_head,
                                        const bf16* v_head,
                                        const int* rows_s, int start,
                                        int first, int end,
                                        size_t row_stride) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < KT * kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const int pos = first + r;
    const bool in = pos < end;
    const size_t off =
        in ? (size_t)rows_s[pos - start] * row_stride + c : 0;
    cp_async16(kd + swz<D>(r, c), k_head + off, in);
    cp_async16(vd + swz<D>(r, c), v_head + off, in);
  }
}

// A row's keys are [lo, lim): lo = max(q_position - window + 1, 0) with a
// window, else 0; lim = min(ctx_len, width, q_position + 1), at least 0.
// Split s of a lane covers [base + s * split_len, base + (s + 1) *
// split_len), base 0 without a window and with one the lane's first
// query's lo rounded down to a split (a lane's queries ascend from its
// first).  A row reads splits s_lo .. s_hi; a row that sees no key (lim
// <= lo) is split 0's alone.
__device__ __forceinline__ void row_splits(int lo, int lim, int base,
                                           int split_len, int* s_lo,
                                           int* s_hi) {
  if (lim <= lo) {
    *s_lo = *s_hi = 0;
    return;
  }
  *s_lo = (lo - base) / split_len;
  *s_hi = (lim - 1 - base) / split_len;
}

__device__ __forceinline__ int window_base(const int64_t* q_positions_b,
                                           int window, int split_len) {
  const long long lo = max((long long)q_positions_b[0] - window + 1, 0LL);
  return (int)(lo / split_len) * split_len;
}

template <int D, bool kWindow>
__device__ __forceinline__ void prefill_split(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ ctx_lens,
    const int64_t* __restrict__ q_positions, bf16* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc, int q_len,
    int n_heads, int kv_heads, int block_size, int max_blocks,
    int split_len, float scale, int window) {
  constexpr int KT = key_tile<D>();
  constexpr int KD = D / 16;   // k16 steps of Q K^T
  constexpr int NS = KT / 8;   // n-tiles of S (keys)
  constexpr int NO = D / 8;    // n-tiles of O (head-dim columns)
  constexpr int TILE = KT * D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);              // [kRows][D]
  bf16* ks = qs + kRows * D;                                 // [2][TILE]
  bf16* vs = ks + 2 * TILE;                                  // [2][TILE]
  int* rows_s = reinterpret_cast<int*>(vs + 2 * TILE);       // [split_len]
  __shared__ int lim_s[kRows], lo_s[kRows];
  __shared__ int hi_s, lo_min_s;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_w = warp * 16;
  const int qpk = n_heads / kv_heads;
  const int n_rows = q_len * qpk;                  // this kv head's rows
  const int n_rb = (n_rows + kRows - 1) / kRows;
  const int kv = blockIdx.x / n_rb;
  const int r0 = (blockIdx.x - kv * n_rb) * kRows;
  const int b = blockIdx.y;
  const int split = blockIdx.z, n_splits = gridDim.z;
  const int width = max_blocks * block_size;
  const int base =
      kWindow ? window_base(q_positions + (size_t)b * q_len, window,
                            split_len)
              : 0;
  const int first = base + split * split_len;  // the split's first key
  const int cap = min(ctx_lens[b], width);
  if (split > 0 && first >= cap) return;  // past the lane's context

  // Each row's keys [lo, lim); the block reads keys [lo_min, hi) of the
  // split, those of the rows that see it.
  if (threadIdx.x == 0) {
    hi_s = 0;
    lo_min_s = INT32_MAX;
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int r = r0 + threadIdx.x;
    int lim = 0, lo = 0;
    if (r < n_rows) {
      const long long qp =
          (long long)q_positions[(size_t)b * q_len + r / qpk];
      lim = (int)max(min((long long)cap, qp + 1), 0LL);
      if (kWindow) lo = (int)min(max(qp - window + 1, 0LL), (long long)lim);
    }
    lim_s[threadIdx.x] = lim;
    lo_s[threadIdx.x] = lo;
    if (lim > first && lo < first + split_len && lo < lim) {
      atomicMax(&hi_s, lim);
      if (kWindow) atomicMin(&lo_min_s, lo);
    }
  }
  __syncthreads();
  const int hi = hi_s;
  const size_t q_stride = (size_t)n_heads * D;  // one (b, t) of q and out
  if (hi <= first) {  // no row of this block sees this split
    if (split == 0) {   // rows that see no key at all: zeros
      bf16* out_b = out + (size_t)b * q_len * q_stride + (size_t)kv * D *
                              (n_heads / kv_heads);
      for (int e = threadIdx.x; e < kRows * D / 2; e += kThreads) {
        const int rl = e / (D / 2), r = r0 + rl;
        if (r < n_rows && (!kWindow || lim_s[rl] <= lo_s[rl]))
          reinterpret_cast<uint32_t*>(
              out_b + (size_t)(r / (n_heads / kv_heads)) * q_stride +
              (size_t)(r % (n_heads / kv_heads)) * D)[e % (D / 2)] = 0u;
      }
    }
    return;
  }
  const int start = kWindow ? max(first, lo_min_s) : first;
  const int end = min(first + split_len, hi);
  const int n_tiles = (end - start + KT - 1) / KT;

  // Q rows of the block: row r is (t, i) = (r / qpk, r % qpk), at
  // q[b, t, kv * qpk + i]; rows past the last are zeros.
  constexpr int kChunks = D / 8;
  const bf16* q_b = q + (size_t)b * q_len * q_stride + (size_t)kv * qpk * D;
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const int rr = r0 + r;
    const bool in = rr < n_rows;
    const bf16* src =
        in ? q_b + (size_t)(rr / qpk) * q_stride + (size_t)(rr % qpk) * D + c
           : q;
    cp_async16(qs + swz<D>(r, c), src, in);
  }
  cp_async_commit();

  // The split's pool rows, looked up from the table once.
  const int32_t* table = block_tables + (size_t)b * max_blocks;
  for (int i = threadIdx.x; i < end - start; i += kThreads) {
    const int pos = start + i;
    const int blk = pos / block_size;
    rows_s[i] = __ldg(table + blk) * block_size + (pos - blk * block_size);
  }
  __syncthreads();

  const size_t row_stride = (size_t)kv_heads * D;  // one pool row
  const bf16* k_head = k_pool + (size_t)kv * D;
  const bf16* v_head = v_pool + (size_t)kv * D;
  load_kv<D, KT>(ks, vs, k_head, v_head, rows_s, start, start, end,
                 row_stride);
  cp_async_commit();

  // A warp whose rows are all padding loads but computes nothing.
  const bool active = r0 + row_w < n_rows;
  const int lim[2] = {min(lim_s[row_w + g], end),
                      min(lim_s[row_w + g + 8], end)};
  const int lo[2] = {lo_s[row_w + g], lo_s[row_w + g + 8]};
  const float sl2 = scale * kLog2e;
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
    const int st = it & 1;
    const int k0 = start + it * KT;
    if (it + 1 < n_tiles) {
      load_kv<D, KT>(ks + (st ^ 1) * TILE, vs + (st ^ 1) * TILE, k_head,
                     v_head, rows_s, start, k0 + KT, end, row_stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const bf16* kt = ks + st * TILE;
      const bf16* vt = vs + st * TILE;

      // S = Q K^T for the warp's 16 rows x KT keys.
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < KD; ++j) {
        uint32_t a[4];
        ldsm_x4(a, a_frag<D>(qs, row_w, 16 * j, lane));
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          uint32_t bb[4];
          ldsm_x4(bb, b_frag<D>(kt, 8 * n, 16 * j, lane));
          mma(s[n], a, bb[0], bb[1]);
          mma(s[n + 1], a, bb[2], bb[3]);
        }
      }

      // Element e of n-tile n is (row g + 8 (e >> 1), key 8 n + 2 t +
      // (e & 1)); a key at or past the row's limit is masked.
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          if (key >= lim[e >> 1] || (kWindow && key < lo[e >> 1]))
            s[n][e] = -CUDART_INF_F;
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

      // acc += P V, P as hi + lo (two products a k16 step).
#pragma unroll
      for (int j = 0; j < KT / 16; ++j) {
        uint32_t ph[4], pl[4];
        probs_to_a(ph, pl, s[2 * j], s[2 * j + 1]);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t bb[4];
          ldsm_x4_t(bb, a_frag<D>(vt, 16 * j, 8 * n, lane));
          mma(acc[n], ph, bb[0], bb[1]);
          mma(acc[n], pl, bb[0], bb[1]);
          mma(acc[n + 1], ph, bb[2], bb[3]);
          mma(acc[n + 1], pl, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }
  if (!active) return;

  // A row whose keys lie in one split is done there: that split writes
  // its output (split 0 the zeros of a row that sees no key).  Every other
  // row that sees this split writes its partial (the merge reads no
  // other): m, the quad's l, and the unnormalised acc.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int rl = row_w + g + 8 * r;
    const int rr = r0 + rl;
    if (rr >= n_rows) continue;
    const size_t o =
        ((size_t)b * q_len + rr / qpk) * n_heads + kv * qpk + rr % qpk;
    int s_lo, s_hi;
    row_splits(lo_s[rl], lim_s[rl], base, split_len, &s_lo, &s_hi);
    if (s_lo == s_hi) {
      if (split != s_lo) continue;
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      bf16* row = out + o * D + 2 * t;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
      continue;
    }
    if (split < s_lo || split > s_hi) continue;
    const size_t p = o * n_splits + split;
    float* dst = part_acc + p * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    if (t == 0) {
      part_ml[2 * p] = m[r];
      part_ml[2 * p + 1] = sum;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ ctx_lens,
    const int64_t* __restrict__ q_positions, bf16* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc, int q_len,
    int n_heads, int kv_heads, int block_size, int max_blocks,
    int split_len, float scale) {
  prefill_split<D, false>(q, k_pool, v_pool, block_tables, ctx_lens,
                          q_positions, out, part_ml, part_acc, q_len,
                          n_heads, kv_heads, block_size, max_blocks,
                          split_len, scale, 0);
}

template <int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_window_split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ ctx_lens,
    const int64_t* __restrict__ q_positions, bf16* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc, int q_len,
    int n_heads, int kv_heads, int block_size, int max_blocks,
    int split_len, float scale, int window) {
  prefill_split<D, true>(q, k_pool, v_pool, block_tables, ctx_lens,
                         q_positions, out, part_ml, part_acc, q_len, n_heads,
                         kv_heads, block_size, max_blocks, split_len, scale,
                         window);
}

// The output rows (b, t, h) whose keys reach past one split, one warp a
// row, lane j holding elements [j * D / 32, (j + 1) * D / 32): the row's
// splits up to its limit, in split order.  Every split read holds the
// row's key at its start, so its m is finite.  Rows that split 0 wrote
// are skipped.
template <int D>
__device__ __forceinline__ void merge_row(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    bf16* __restrict__ out, int o, int s0, int n, int n_splits, int lane) {
  constexpr int E = D / 32;
  const float* ml = part_ml + ((size_t)o * n_splits + s0) * 2;
  const float* acc = part_acc + ((size_t)o * n_splits + s0) * D + lane * E;
  float mx = -CUDART_INF_F;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, ml[2 * s]);
  float sum = 0.f, a[E];
#pragma unroll
  for (int e = 0; e < E; ++e) a[e] = 0.f;
  for (int s = 0; s < n; ++s) {
    const float w = exp2f(ml[2 * s] - mx);
    sum = fmaf(w, ml[2 * s + 1], sum);
    const float* src = acc + (size_t)s * D;
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      const float2 x = *reinterpret_cast<const float2*>(src + e);
      a[e] = fmaf(w, x.x, a[e]);
      a[e + 1] = fmaf(w, x.y, a[e + 1]);
    }
  }
  const float inv = 1.f / fmaxf(sum, 1e-30f);
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + (size_t)o * D + lane * E);
#pragma unroll
  for (int e = 0; e < E; e += 2)
    dst[e / 2] = pack_bf16(a[e] * inv, a[e + 1] * inv);
}

template <int D, bool kWindow>
__device__ __forceinline__ void prefill_merge(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    const int32_t* __restrict__ ctx_lens,
    const int64_t* __restrict__ q_positions, bf16* __restrict__ out,
    int n_out_rows, int q_len, int n_heads, int width, int split_len,
    int n_splits, int window) {
  const int lane = threadIdx.x & 31;
  const int step = gridDim.x * (kMergeThreads / 32);
  for (int o = blockIdx.x * (kMergeThreads / 32) + (threadIdx.x >> 5);
       o < n_out_rows; o += step) {
    const int bt = o / n_heads, b = bt / q_len;
    const long long cap = min(ctx_lens[b], width);
    const long long qp = q_positions[bt];
    const long long lim = max(min(cap, qp + 1), 0LL);
    if (!kWindow) {
      if (lim > split_len)
        merge_row<D>(part_ml, part_acc, out, o, 0,
                     (int)((lim + split_len - 1) / split_len), n_splits,
                     lane);
      continue;
    }
    const int lo = (int)min(max(qp - window + 1, 0LL), lim);
    int s_lo, s_hi;
    row_splits(lo, (int)lim,
               window_base(q_positions + (size_t)b * q_len, window,
                           split_len),
               split_len, &s_lo, &s_hi);
    s_hi = min(s_hi, n_splits - 1);  // rows past the launch's span
    if (s_hi > s_lo)
      merge_row<D>(part_ml, part_acc, out, o, s_lo, s_hi - s_lo + 1,
                   n_splits, lane);
  }
}

template <int D>
__global__ void __launch_bounds__(kMergeThreads) paged_prefill_merge_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    const int32_t* __restrict__ ctx_lens,
    const int64_t* __restrict__ q_positions, bf16* __restrict__ out,
    int n_out_rows, int q_len, int n_heads, int width, int split_len,
    int n_splits) {
  prefill_merge<D, false>(part_ml, part_acc, ctx_lens, q_positions, out,
                          n_out_rows, q_len, n_heads, width, split_len,
                          n_splits, 0);
}

template <int D>
__global__ void __launch_bounds__(kMergeThreads)
    paged_prefill_window_merge_kernel(
        const float* __restrict__ part_ml, const float* __restrict__ part_acc,
        const int32_t* __restrict__ ctx_lens,
        const int64_t* __restrict__ q_positions, bf16* __restrict__ out,
        int n_out_rows, int q_len, int n_heads, int width, int split_len,
        int n_splits, int window) {
  prefill_merge<D, true>(part_ml, part_acc, ctx_lens, q_positions, out,
                         n_out_rows, q_len, n_heads, width, split_len,
                         n_splits, window);
}

struct Args {
  const void *q, *k_pool, *v_pool, *block_tables, *ctx_lens, *q_positions;
  void *out, *part_ml, *part_acc;
  int batch, q_len, n_heads, kv_heads, block_size, max_blocks, split_len,
      n_splits;
  float scale;
  int window;  // 0: no window
  cudaStream_t stream;
};

template <int D>
cudaError_t launch(const Args& a) {
  constexpr int KT = key_tile<D>();
  const int n_rows = a.q_len * (a.n_heads / a.kv_heads);
  const int n_rb = (n_rows + kRows - 1) / kRows;
  const auto* ctx = static_cast<const int32_t*>(a.ctx_lens);
  const auto* qpos = static_cast<const int64_t*>(a.q_positions);
  if (a.n_splits == 0)  // a table of no blocks: every row sees no key
    return cudaMemsetAsync(
        a.out, 0, sizeof(bf16) * D * (size_t)a.batch * a.q_len * a.n_heads,
        a.stream);
  const size_t smem = sizeof(bf16) * (size_t)(kRows + 4 * KT) * D +
                      sizeof(int) * (size_t)a.split_len;
  auto kernel = paged_prefill_split_kernel<D>;
  auto window_kernel = paged_prefill_window_split_kernel<D>;
  cudaError_t err = a.window > 0
      ? cudaFuncSetAttribute(window_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem)
      : cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.kv_heads * n_rb, a.batch, a.n_splits);
  const auto* q = static_cast<const bf16*>(a.q);
  const auto* k = static_cast<const bf16*>(a.k_pool);
  const auto* v = static_cast<const bf16*>(a.v_pool);
  const auto* tables = static_cast<const int32_t*>(a.block_tables);
  auto* out = static_cast<bf16*>(a.out);
  auto* ml = static_cast<float*>(a.part_ml);
  auto* acc = static_cast<float*>(a.part_acc);
  if (a.window > 0)
    window_kernel<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, tables, ctx, qpos, out, ml, acc, a.q_len, a.n_heads,
        a.kv_heads, a.block_size, a.max_blocks, a.split_len, a.scale,
        a.window);
  else
    kernel<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, tables, ctx, qpos, out, ml, acc, a.q_len, a.n_heads,
        a.kv_heads, a.block_size, a.max_blocks, a.split_len, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.n_splits < 2) return cudaSuccess;  // split 0 wrote every row
  const int out_rows = a.batch * a.q_len * a.n_heads;
  constexpr int kRowsPerBlock = kMergeThreads / 32 * kMergeRowsPerWarp;
  const int blocks = (out_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int width = a.max_blocks * a.block_size;
  if (a.window > 0)
    paged_prefill_window_merge_kernel<D><<<blocks, kMergeThreads, 0,
                                           a.stream>>>(
        ml, acc, ctx, qpos, out, out_rows, a.q_len, a.n_heads, width,
        a.split_len, a.n_splits, a.window);
  else
    paged_prefill_merge_kernel<D><<<blocks, kMergeThreads, 0, a.stream>>>(
        ml, acc, ctx, qpos, out, out_rows, a.q_len, a.n_heads, width,
        a.split_len, a.n_splits);
  return cudaGetLastError();
}

}  // namespace

// The table's width splits into n_splits = ceil(max_blocks * block_size /
// split_len) spans of split_len positions, and with a window (window > 0)
// into the least of that and ceil((window + split_len + q_len - 2) /
// split_len) spans from each lane's window base (`row_splits`); part_ml
// [B * T * H, n_splits, 2] and part_acc [B * T * H, n_splits, D], f32, are
// the caller's scratch for them.  bf16 only.  Launches both kernels on
// `stream`; returns the first failing launch's cudaError_t.
extern "C" int paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* ctx_lens, const void* q_positions,
    void* out, void* part_ml, void* part_acc, int batch, int q_len,
    int n_heads, int kv_heads, int head_dim, int block_size, int max_blocks,
    int split_len, float scale, int window, void* stream) {
  if (batch == 0 || q_len == 0) return cudaSuccess;
  const long long width = (long long)max_blocks * block_size;
  if (kv_heads <= 0 || n_heads % kv_heads != 0 || batch > 65535 ||
      q_len < 0 || block_size <= 0 || max_blocks < 0 || width > INT32_MAX ||
      split_len <= 0 || window < 0 ||
      (width + split_len - 1) / split_len > 65535 ||
      (long long)batch * q_len * n_heads > INT32_MAX)
    return cudaErrorInvalidValue;
  long long n_splits = (width + split_len - 1) / split_len;
  if (window > 0)
    n_splits = std::min(n_splits, ((long long)window + 2 * split_len +
                                   q_len - 3) / split_len);
  const Args a{q,        k_pool,   v_pool,       block_tables,
               ctx_lens, q_positions, out,       part_ml,
               part_acc, batch,    q_len,        n_heads,
               kv_heads, block_size, max_blocks, split_len,
               (int)n_splits, scale, window,
               static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 64: return launch<64>(a);
    case 128: return launch<128>(a);
    case 256: return launch<256>(a);
    default: return cudaErrorInvalidValue;
  }
}
