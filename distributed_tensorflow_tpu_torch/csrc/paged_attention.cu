// Paged attention straight off the KV page pool, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of distributed_tensorflow_tpu/ops/pallas/
// paged_attention.py (`_paged_attention`, body `_make_paged_kernel`),
// both entries: decode (s=1 per slot row, per-column valid plane) and the
// prefill window (one row, `sq` queries, causal `col <= pos + j` computed
// here, never materialised), each over a pool in q's type or over the
// int8 pool with its f32 k_scale/v_scale planes (the `quantized` path,
// paged_attention.py:92-118).
//
// Layouts (the JAX package's, unchanged):
//   q         [B, sq, h, hd]            bf16 or f32, hd 32, 64 or 128
//   k/v pool  [L, NP, pg, kvh, hd]      q's type, or int8 (the int8 branch)
//   k/v scale [L, NP, pg, kvh, 1] f32   int8 branch only; NULL otherwise
//   page_tab  [B, P] int32              row b's logical page j -> pool page
//   valid     [B, P * pg] uint8 (bool)  decode only; NULL for the window
//   out       [B, sq, h, hd]            q's type
//
// What bounds it on the H100: bytes.  Per (row, kv head) it must read
// each needed K/V column once (2 hd bytes per column per leaf in bf16,
// hd + 4 in int8) and does 4 hd flops per query per column, far below the
// 295 flops per byte where the tensor cores would bind.  The TPU walks the
// (B, P) grid in order and carries the online-softmax state from one grid
// step to the next; here the design is about keeping enough of the card
// busy on rows that are few and long, and about the instructions each
// column costs:
//
// * Split-K across blocks (flash-decoding).  The grid is (B * kvh,
//   q-blocks, splits).  The row's columns are cut into sub-tiles of 32,
//   and split s walks a contiguous share of `per` sub-tiles, leaving an
//   f32 partial (m, l, acc) per query in a workspace.  The split count is
//   worked out by the host from shapes alone (never from the valid
//   plane: no device->host read, so the launch can be captured in a CUDA
//   graph).  The partials are merged in the same launch: each block
//   publishes its partial, `__threadfence()`s and takes a ticket from a
//   per-(row, kv head, q-block) counter; the last to arrive merges all
//   splits, writes the output and puts the counter back to 0 for the
//   next launch.  The merge keeps the Pallas guards: -inf init with the
//   isfinite shift, and a split with no active sub-tile has m = -inf and
//   weight 0.
// * The row-global rule "a decode row with no valid column attends every
//   column uniformly" is decided once per row: a split flags whether its
//   share held a valid column; the merging block sees every flag, and
//   when none is set it walks the whole row itself with every column at
//   the finite -1e9 (the rare path: the engine's rows always hold their
//   own column).  Since masks are finite, a column masked for a query
//   inside a split still gives that split a finite m near -1e9, and the
//   merge weighs it exp(-1e9 - m) = 0 next to any split with a real
//   logit, exactly as the sequential walk would.
// * Activity scan.  A decode block reads only its share of the valid
//   plane, 16 bytes a thread, into one 32-bit column mask per sub-tile,
//   then one warp compacts the active sub-tiles with ballots and popc
//   prefix sums.  The inner loop takes each column's valid bit from that
//   mask, never from device memory.
// * Copies.  K/V columns are gathered by cp.async through the page table;
//   each thread loads the page id of its next sub-tile one sub-tile ahead,
//   so a copy never waits on a table load of its own iteration.
// * Two bodies.  `paged_cc_kernel` runs on the CUDA cores (every f32
//   call, and decode over an int8 pool): 4 warps take the block's
//   sub-tiles in turn, one column per lane, each warp with a private
//   cp.async ring of unpadded, XOR-swizzled rows (3 stages where a block
//   still fits three times an SM, else 2) and 1, 4 or 8 query vectors a
//   block; the dot products run chunk-outer, query-inner, so each K
//   chunk is widened once (int8 without I2F, see hopper.cuh).
//   `paged_tc_kernel` runs both matrix products on the tensor cores
//   (mma.sync.m16n8k16, bf16 in, f32 accumulate) and is taken for every
//   bf16 window and for bf16 decode over a bf16 pool: one block holds
//   all sq * group query vectors of a (row, kv head), up to 128, one m16
//   tile a warp (a window block at least 4 warps, the spare ones copying
//   and widening), so K/V are read once per kv head.  Its warps share a
//   3-stage block-wide ring of padded bf16 tiles (K by ldmatrix, V by
//   ldmatrix.trans).  An int8 stage is widened to bf16 once per sub-tile
//   by the whole block into one more tile pair (every int8 value is
//   exact in bf16): each of the block's warps reads all of K and V, so
//   widening at each warp's fragment load would repeat the work up to 8
//   times.
//
// The int8 branch folds the scales rather than multiplying each element:
// the k scale into the logit, `s = (q . k_int8) * k_scale * scale`, and
// the v scale into the softmax weight that multiplies V, `acc += (p *
// v_scale) * v_int8`, while l takes p alone.  That equals the Pallas
// `q . (k * k_scale)` and `p . (v * v_scale)` up to f32 rounding order
// (and, on the tensor cores, the bf16 rounding of p as an operand).
// Cells never written have scale 0 and dequantize to 0; they are masked.
//
// Page size: any page_size >= 1.  The kernel gathers per column, so
// there is no tiling rule like Mosaic's multiple-of-8 sublane rule.
// Concurrency: launches that share a workspace and its counters must be
// ordered; the wrapper keeps one pair per (device, stream).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kSub = 32;               // columns of a sub-tile
constexpr float kNegInf = -1e9f;       // ops.attention.NEG_INF
constexpr int kCcWarps = 4;
constexpr int kCcThreads = kCcWarps * 32;
constexpr int kCcQB = 8;               // query vectors of a CUDA-core block
constexpr int kTcQB = 128;             // query vectors of a tensor-core block
constexpr int kTcMaxThreads = kTcQB / 16 * 32;
constexpr int kTcStages = 3;
constexpr int kWsExtra = 4;            // a partial row: acc[hd], m, l, flag, pad

// ------------------------------------------------------------ loads

__device__ __forceinline__ void unpack16(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float* f, bf16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float* f, int8_t) {
  i8x4_to_f32(u.x, f);
  i8x4_to_f32(u.y, f + 4);
  i8x4_to_f32(u.z, f + 8);
  i8x4_to_f32(u.w, f + 12);
}

// N consecutive elements of KT at p (N * sizeof(KT) in {1, 2, 4, 8, 16}
// bytes, aligned) -> N floats.  N is HD / 32, the dims a lane owns in
// P V: 1 at head dim 32, where a bf16 lane reads one element and an int8
// lane one byte.
template <int N>
__device__ __forceinline__ void load_dims(const float* p, float* f) {
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = p[i];
}
template <int N>
__device__ __forceinline__ void load_dims(const bf16* p, float* f) {
  if constexpr (N == 1) {
    f[0] = __bfloat162float(*p);
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const uint32_t x = w[i];
      f[2 * i] = __uint_as_float(x << 16);
      f[2 * i + 1] = __uint_as_float(x & 0xffff0000u);
    }
  }
}
template <int N>
__device__ __forceinline__ void load_dims(const int8_t* p, float* f) {
  if constexpr (N == 4) {
    i8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), f);
  } else if constexpr (N == 2) {
    float t[4];
    i8x4_to_f32(*reinterpret_cast<const uint16_t*>(p), t);
    f[0] = t[0];
    f[1] = t[1];
  } else {
    f[0] = (float)*p;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// ------------------------------------------------- shared block logic

struct Geo {   // what every block of a launch shares
  int sq, h, kvh, num_pages, page_size, pages_per_row, layer, pos, n_cols,
      per;
  float scale;
};

// Decode: the active sub-tiles of share [t0, t1) of row `vrow`, in column
// order: act[i] the sub-tile, amask[i] its 32-bit column mask.  Returns
// their count (the same in every thread).  `amask` doubles as the scratch
// of the raw masks (compaction runs in place, never ahead of its reads).
__device__ int scan_share(const uint8_t* __restrict__ vrow, int view_len,
                          int t0, int t1, int* act, uint32_t* amask) {
  __shared__ int s_count;
  const int n = t1 - t0;
  const int c0 = t0 * kSub;
  uint16_t* half = reinterpret_cast<uint16_t*>(amask);
  const bool vec = view_len % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(vrow) & 15) == 0;
  for (int it = threadIdx.x; it < 2 * n; it += blockDim.x) {
    const int col = c0 + it * 16;
    uint32_t bits = 0;
    if (vec) {
      if (col < view_len) {
        const uint4 u = *reinterpret_cast<const uint4*>(vrow + col);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 16; ++i)
          bits |= (uint32_t)(((w[i >> 2] >> (8 * (i & 3))) & 0xffu) != 0) << i;
      }
    } else {
      for (int i = 0; i < 16 && col + i < view_len; ++i)
        bits |= (uint32_t)(vrow[col + i] != 0) << i;
    }
    half[it] = (uint16_t)bits;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < n; base += 32) {
      const uint32_t m = base + lane < n ? amask[base + lane] : 0u;
      const unsigned ball = __ballot_sync(kFull, m != 0);
      __syncwarp();              // every lane read before any lane writes
      if (m != 0) {
        const int at = count + __popc(ball & ((1u << lane) - 1));
        act[at] = t0 + base + lane;
        amask[at] = m;
      }
      count += __popc(ball);
      __syncwarp();
    }
    if (lane == 0) s_count = count;
  }
  __syncthreads();
  return s_count;
}

// pool cell (token slot, kv head) of logical column `col` on page `page`
__device__ __forceinline__ int64_t pool_cell(const Geo& a, int page, int col,
                                             int g) {
  return (((int64_t)a.layer * a.num_pages + page) * a.page_size +
          col % a.page_size) * a.kvh + g;
}

__device__ __forceinline__ int page_of(const Geo& a,
                                       const int32_t* __restrict__ tab,
                                       int b, int col, int view_len) {
  return col < view_len ? tab[(int64_t)b * a.pages_per_row + col / a.page_size]
                        : 0;
}

// Publish this block's partial, take a ticket; true in the last block of
// the (row, kv head, q-block) to arrive, which then owns the merge.
__device__ bool arrive_last(int* tickets, int n_split) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(tickets + blockIdx.x * gridDim.y + blockIdx.y, 1);
    s_last = t == n_split - 1;
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// true when some split of this (row, kv head, q-block) flagged an active
// sub-tile (read by the merging block)
__device__ bool any_flag(const float* ws_blk, int n_split, int QB, int HD) {
  int f = 0;
  for (int s = threadIdx.x; s < n_split; s += blockDim.x)
    f |= __ldcg(ws_blk + ((size_t)s * QB) * (HD + kWsExtra) + HD + 2) != 0.f;
  return __syncthreads_or(f);
}

// The merge of all splits' partials into out, by the last block.
// scratch: 2 * nq * n_split floats of shared memory.  Every load of a
// pass is issued before any is used (at most kMaxSplits splits), so the
// merge costs a few L2 round trips, not one per split.
constexpr int kMaxSplits = 16;

template <typename T, int HD>
__device__ void merge_splits(const float* ws_blk, int n_split, int QB, int nq,
                             int qbase, int b, int g, const Geo& a,
                             float* scratch, T* __restrict__ out) {
  constexpr int RS = HD + kWsExtra;
  const int group = a.h / a.kvh;
  float* ms = scratch;                       // [qi][s]: m, or -inf unflagged
  float* ls = scratch + nq * n_split;        // [qi][s]: l, then the weight
  for (int idx = threadIdx.x; idx < nq * n_split; idx += blockDim.x) {
    const int qi = idx / n_split, s = idx % n_split;
    const float* r = ws_blk + ((size_t)s * QB + qi) * RS + HD;
    const float m = __ldcg(r), l = __ldcg(r + 1), flag = __ldcg(r + 2);
    ms[idx] = flag != 0.f ? m : -INFINITY;
    ls[idx] = l;
  }
  __syncthreads();
  for (int qi = threadIdx.x; qi < nq; qi += blockDim.x) {
    float m_tot = -INFINITY;
    for (int s = 0; s < n_split; ++s) m_tot = fmaxf(m_tot, ms[qi * n_split + s]);
    const float shift = isfinite(m_tot) ? m_tot : 0.f;
    float l_tot = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float m = ms[qi * n_split + s];
      const float f = isfinite(m) ? expf(m - shift) : 0.f;
      l_tot += f * ls[qi * n_split + s];
      ms[qi * n_split + s] = f;
    }
    const float inv = 1.f / (l_tot == 0.f ? 1.f : l_tot);
    for (int s = 0; s < n_split; ++s) ls[qi * n_split + s] = ms[qi * n_split + s] * inv;
  }
  __syncthreads();
  constexpr int V = HD / 4;             // float4s of a row
  // items a thread at most: a tensor-core block has a warp per 16 queries,
  // a CUDA-core block 128 threads for at most 8 (HD / 64 items)
  constexpr int KMAX = HD / 8;
  const int total = nq * V, nt = blockDim.x;
  const int K = (total - (int)threadIdx.x + nt - 1) / nt;   // this thread's
  auto row = [&](int s, int qi) {
    return reinterpret_cast<const float4*>(ws_blk + ((size_t)s * QB + qi) * RS);
  };
  auto store = [&](int idx, const float4& acc) {
    const int qi = idx / V, d4 = idx % V;
    const int qq = qbase + qi, j = qq / group, gi = qq % group;
    T* o = out + (((int64_t)b * a.sq + j) * a.h + g * group + gi) * HD + 4 * d4;
    o[0] = from_float<T>(acc.x);
    o[1] = from_float<T>(acc.y);
    o[2] = from_float<T>(acc.z);
    o[3] = from_float<T>(acc.w);
  };
  if (K <= 2) {
    // few items: each item's splits loaded at once
    for (int k = 0; k < K; ++k) {
      const int idx = threadIdx.x + k * nt, qi = idx / V, d4 = idx % V;
      float4 x[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < n_split) x[s] = __ldcg(row(s, qi) + d4);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < n_split) {
          const float w = ls[qi * n_split + s];
          if (w != 0.f) {                 // an unflagged split may be stale
            acc.x += w * x[s].x;
            acc.y += w * x[s].y;
            acc.z += w * x[s].z;
            acc.w += w * x[s].w;
          }
        }
      store(idx, acc);
    }
  } else {
    // many items (a large window block): split by split, every item's
    // load of the split in flight at once
    float4 acc[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_split; ++s) {
      float4 x[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < K) {
          const int idx = threadIdx.x + k * nt;
          x[k] = __ldcg(row(s, idx / V) + idx % V);
        }
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < K) {
          const float w = ls[(threadIdx.x + k * nt) / V * n_split + s];
          if (w != 0.f) {
            acc[k].x += w * x[k].x;
            acc[k].y += w * x[k].y;
            acc[k].z += w * x[k].z;
            acc[k].w += w * x[k].w;
          }
        }
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k < K) store(threadIdx.x + k * nt, acc[k]);
  }
}

// ------------------------------------------------ CUDA-core body

template <typename KT, int HD, int NQ>
struct CcShape {
  static constexpr bool kQuant = sizeof(KT) == 1;
  static constexpr int kVec = 16 / sizeof(KT);       // elements per 16 bytes
  static constexpr int kChunks = HD / kVec;          // 16-byte chunks a column
  static constexpr int kRow = HD * sizeof(KT);       // smem row bytes, unpadded
  static constexpr int kDpl = HD / 32;               // dims per lane in P V
  static constexpr int kKV = 2 * 32 * kRow;          // K and V of a sub-tile
  static constexpr int kStage = kKV + (kQuant ? 2 * 32 * 4 : 0);
  static constexpr int kFixed = 4 * (NQ * HD + kCcWarps * 32 * NQ);
  // 3 stages a warp where a block still fits three times an SM, else 2:
  // warps an SM hide more of the walk's latency than a deeper ring
  static constexpr int kStages =
      kFixed + kCcWarps * 3 * kStage <= 72 * 1024 ? 3 : 2;
  static constexpr int kMerge = 4 * kCcWarps * NQ * (HD + 2);
  static constexpr int kRing = kCcWarps * kStages * kStage > kMerge
                                   ? kCcWarps * kStages * kStage : kMerge;
  static size_t smem(int per) { return kFixed + kRing + 8 * (size_t)per; }
  // byte offset of 16-byte chunk c of row r: chunks are XOR-swizzled by
  // the row, so the 8 lanes of an LDS.128 phase reading one chunk of 8
  // rows, or one row, fall in 8 distinct bank groups without padding.
  // The swizzle stays inside the row's kRow / 16 chunks: 8 or more (r &
  // 7), 4 (a row of 64 bytes: (r >> 1) & 3), 2 (the 32-byte int8 row of
  // head dim 32: (r >> 2) & 1, rows 4..7 take the other half of each
  // bank pair)
  static __device__ __forceinline__ int swz(int r) {
    return kRow >= 128 ? (r & 7) : kRow == 64 ? ((r >> 1) & 3)
                                               : ((r >> 2) & 1);
  }
  static __device__ __forceinline__ int chunk(int r, int c) {
    return r * kRow + 16 * (c ^ swz(r));
  }
};

// NQ: the query vectors a block computes (1, 4 or 8; rows past the
// block's own are zeros), a constant so every per-query loop unrolls and
// the queries' reductions interleave
template <typename T, typename KT, int HD, bool kWindow, int NQ>
__global__ void __launch_bounds__(kCcThreads) paged_cc_kernel(
    const T* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ page_tab,
    const uint8_t* __restrict__ valid, T* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ tickets, const Geo a) {
  using S = CcShape<KT, HD, NQ>;
  constexpr int NS = S::kStages;
  const int b = blockIdx.x / a.kvh, g = blockIdx.x % a.kvh;
  const int group = a.h / a.kvh;
  const int qbase = blockIdx.y * kCcQB;
  const int nq = min(kCcQB, a.sq * group - qbase);
  const int split = blockIdx.z, n_split = gridDim.z;
  const int view_len = a.pages_per_row * a.page_size;
  const int n_row = (view_len + kSub - 1) / kSub;
  const int n_part = (a.n_cols + kSub - 1) / kSub;
  const int t0 = split * a.per, t1 = min(t0 + a.per, n_part);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);           // [NQ][HD]
  float* p_s = q_s + NQ * HD;                            // [warp][32][NQ]
  unsigned char* ring = reinterpret_cast<unsigned char*>(p_s + kCcWarps * 32 * NQ);
  float* acc_s = reinterpret_cast<float*>(ring);         // after the walk
  float* m_s = acc_s + kCcWarps * NQ * HD;
  float* l_s = m_s + kCcWarps * NQ;
  int* act = reinterpret_cast<int*>(ring + S::kRing);
  uint32_t* amask = reinterpret_cast<uint32_t*>(act + a.per);

  // query qi of this block is query qbase + qi of the pair: window row
  // j = (qbase + qi) / group, q head g * group + (qbase + qi) % group
  for (int idx = tid; idx < NQ * HD; idx += kCcThreads) {
    const int qi = idx / HD, d = idx % HD;
    float v = 0.f;
    if (qi < nq) {
      const int qq = qbase + qi, j = qq / group, gi = qq % group;
      v = to_float(q[(((int64_t)b * a.sq + j) * a.h + g * group + gi) * HD + d]);
    }
    q_s[idx] = v;
  }

  int n_act;
  if (kWindow) {
    // the block's last query row attends up to pos + j_max
    const int j_max = (qbase + nq - 1) / group;
    n_act = max(0, min(t1, (a.pos + j_max) / kSub + 1) - t0);
  } else {
    n_act = scan_share(valid + (int64_t)b * view_len, view_len, t0, t1, act,
                       amask);
  }
  __syncthreads();

  const int64_t kv_elems = HD;
  float* my_p = p_s + warp * 32 * NQ;

  // Walk n sub-tiles: sub-tile i is al[i] (mask ml[i]) or, without a list,
  // tbase + i (mask 0: every column at -1e9, the no-valid-column row; the
  // window has no valid plane).  Leaves each warp's (m, l, acc) in
  // m_s/l_s/acc_s.
  auto walk = [&](int n, const int* al, const uint32_t* ml, int tbase) {
    unsigned char* mine = ring + warp * NS * S::kStage;
    auto tile_of = [&](int i) { return al ? al[i] : tbase + i; };
    int pnext = warp < n ? page_of(a, page_tab, b, tile_of(warp) * kSub + lane,
                                   view_len)
                         : 0;
    // lane `lane` copies column 32 * t + lane of sub-tile i = warp + 4 k
    auto issue = [&](int i, int st) {
      const int col = tile_of(i) * kSub + lane;
      const int page = pnext;
      if (i + kCcWarps < n)
        pnext = page_of(a, page_tab, b, tile_of(i + kCcWarps) * kSub + lane,
                        view_len);
      unsigned char* stage = mine + st * S::kStage;
      const uint32_t ks = smem_u32(stage);
      const uint32_t vs = ks + 32 * S::kRow;
      const bool ok = col < view_len;
      const int64_t cell = ok ? pool_cell(a, page, col, g) : 0;
      const KT* kp = k_pool + cell * kv_elems;
      const KT* vp = v_pool + cell * kv_elems;
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c) {
        cp_async16(ks + S::chunk(lane, c), kp + c * S::kVec, ok ? 16 : 0);
        cp_async16(vs + S::chunk(lane, c), vp + c * S::kVec, ok ? 16 : 0);
      }
      if constexpr (S::kQuant) {
        const uint32_t sc = smem_u32(stage + S::kKV);
        cp_async4(sc + 4 * lane, k_scale + cell, ok ? 4 : 0);
        cp_async4(sc + 128 + 4 * lane, v_scale + cell, ok ? 4 : 0);
      }
    };

    float m[NQ], l[NQ], acc[NQ][S::kDpl];
#pragma unroll
    for (int qi = 0; qi < NQ; ++qi) {
      m[qi] = -INFINITY;
      l[qi] = 0.f;
#pragma unroll
      for (int e = 0; e < S::kDpl; ++e) acc[qi][e] = 0.f;
    }
    const int n_mine = n > warp ? (n - warp + kCcWarps - 1) / kCcWarps : 0;
#pragma unroll
    for (int k = 0; k < NS - 1; ++k) {
      if (k < n_mine) issue(warp + kCcWarps * k, k);
      cp_async_commit();
    }
    for (int k = 0; k < n_mine; ++k) {
      const int st = k % NS;
      if (k + NS - 1 < n_mine)
        issue(warp + kCcWarps * (k + NS - 1), (k + NS - 1) % NS);
      cp_async_commit();
      cp_async_wait<NS - 1>();    // this stage has landed (for this lane)
      __syncwarp();               // ... and for every lane of the warp

      const int i = warp + kCcWarps * k;
      const int col = tile_of(i) * kSub + lane;
      const bool exists = col < view_len;
      float valid_add = 0.f;
      if (!kWindow)
        valid_add = ((al ? ml[i] : 0u) >> lane) & 1u ? 0.f : kNegInf;
      const unsigned char* stage = mine + st * S::kStage;
      const unsigned char* kbase = stage;
      const unsigned char* vbase = stage + 32 * S::kRow;
      float k_sc = 1.f, v_sc = 1.f;
      if constexpr (S::kQuant) {
        const float* scl = reinterpret_cast<const float*>(stage + S::kKV);
        k_sc = scl[lane];
        v_sc = scl[32 + lane];
      }
      // q . k: each 16-byte chunk of this lane's column widened once
      float s[NQ];
#pragma unroll
      for (int qi = 0; qi < NQ; ++qi) s[qi] = 0.f;
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c) {
        float kf[S::kVec];
        unpack16(*reinterpret_cast<const uint4*>(kbase + S::chunk(lane, c)),
                 kf, KT());
#pragma unroll
        for (int qi = 0; qi < NQ; ++qi) {
          const float4* qv =
              reinterpret_cast<const float4*>(q_s + qi * HD + c * S::kVec);
#pragma unroll
          for (int v4 = 0; v4 < S::kVec / 4; ++v4) {
            const float4 x = qv[v4];
            s[qi] = fmaf(x.x, kf[4 * v4], s[qi]);
            s[qi] = fmaf(x.y, kf[4 * v4 + 1], s[qi]);
            s[qi] = fmaf(x.z, kf[4 * v4 + 2], s[qi]);
            s[qi] = fmaf(x.w, kf[4 * v4 + 3], s[qi]);
          }
        }
      }
#pragma unroll
      for (int qi = 0; qi < NQ; ++qi) {
        float x = s[qi];
        if constexpr (S::kQuant) x = x * k_sc;
        x = x * a.scale;
        x = x + valid_add;
        if (kWindow) {
          const int j = (qbase + qi) / group;
          x = x + (col <= a.pos + j ? 0.f : kNegInf);
        }
        if (!exists) x = -INFINITY;
        const float m_new = fmaxf(m[qi], warp_max(x));
        const float shift = isfinite(m_new) ? m_new : 0.f;
        const float p = exists ? expf(x - shift) : 0.f;
        const float alpha = isfinite(m[qi]) ? expf(m[qi] - shift) : 0.f;
        l[qi] = alpha * l[qi] + warp_sum(p);
        m[qi] = m_new;
#pragma unroll
        for (int e = 0; e < S::kDpl; ++e) acc[qi][e] *= alpha;
        my_p[lane * NQ + qi] = S::kQuant ? p * v_sc : p;
      }
      __syncwarp();
      // P V: lane owns dims lane * kDpl ..; p of column c for all queries
      // by two broadcast float4 loads
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        float vv[S::kDpl];
        // this lane's dims lane * kDpl .. of row c: chunk vb / 16, byte
        // vb % 16 within it
        constexpr int kVb = S::kDpl * sizeof(KT);
        load_dims<S::kDpl>(reinterpret_cast<const KT*>(
                               vbase + S::chunk(c, lane * kVb / 16) +
                               lane * kVb % 16),
                           vv);
        float pc[NQ];
        if constexpr (NQ == 1) {
          pc[0] = my_p[c];
        } else {
          const float4* pv = reinterpret_cast<const float4*>(my_p + c * NQ);
#pragma unroll
          for (int v4 = 0; v4 < NQ / 4; ++v4) {
            const float4 x = pv[v4];
            pc[4 * v4] = x.x;
            pc[4 * v4 + 1] = x.y;
            pc[4 * v4 + 2] = x.z;
            pc[4 * v4 + 3] = x.w;
          }
        }
#pragma unroll
        for (int qi = 0; qi < NQ; ++qi) {
#pragma unroll
          for (int e = 0; e < S::kDpl; ++e)
            acc[qi][e] = fmaf(pc[qi], vv[e], acc[qi][e]);
        }
      }
      __syncwarp();               // stage and p are rewritten next
    }
    cp_async_wait<0>();
    __syncthreads();              // the ring becomes the merge area
#pragma unroll
    for (int qi = 0; qi < NQ; ++qi) {
#pragma unroll
      for (int e = 0; e < S::kDpl; ++e)
        acc_s[(warp * NQ + qi) * HD + lane * S::kDpl + e] = acc[qi][e];
      if (lane == 0) {
        m_s[warp * NQ + qi] = m[qi];
        l_s[warp * NQ + qi] = l[qi];
      }
    }
    __syncthreads();
  };

  // the block's (m, l, acc) of query qi, dim d, from its warps' states
  auto combine = [&](int qi, int d, float& m_tot, float& l_tot, float& acc_d) {
    m_tot = -INFINITY;
#pragma unroll
    for (int w = 0; w < kCcWarps; ++w) m_tot = fmaxf(m_tot, m_s[w * NQ + qi]);
    const float shift = isfinite(m_tot) ? m_tot : 0.f;
    l_tot = 0.f;
    acc_d = 0.f;
#pragma unroll
    for (int w = 0; w < kCcWarps; ++w) {
      const float mw = m_s[w * NQ + qi];
      const float f = isfinite(mw) ? expf(mw - shift) : 0.f;
      l_tot += f * l_s[w * NQ + qi];
      acc_d += f * acc_s[(w * NQ + qi) * HD + d];
    }
  };
  auto finalize = [&]() {
    for (int idx = tid; idx < nq * HD; idx += kCcThreads) {
      const int qi = idx / HD, d = idx % HD;
      float m_tot, l_tot, x;
      combine(qi, d, m_tot, l_tot, x);
      const int qq = qbase + qi, j = qq / group, gi = qq % group;
      out[(((int64_t)b * a.sq + j) * a.h + g * group + gi) * HD + d] =
          from_float<T>(x / (l_tot == 0.f ? 1.f : l_tot));
    }
  };

  if (n_split == 1) {
    // one split: a decode row with no valid column attends every column
    if (!kWindow && n_act == 0) walk(n_row, nullptr, nullptr, 0);
    else if (kWindow) walk(n_act, nullptr, nullptr, t0);
    else walk(n_act, act, amask, 0);
    finalize();
    return;
  }
  if (kWindow) walk(n_act, nullptr, nullptr, t0);
  else walk(n_act, act, amask, 0);

  constexpr int RS = HD + kWsExtra;
  float* ws_blk = ws + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) *
                           n_split * kCcQB * RS;
  float* mine = ws_blk + (size_t)split * kCcQB * RS;
  for (int idx = tid; idx < nq * HD; idx += kCcThreads) {
    const int qi = idx / HD, d = idx % HD;
    float m_tot, l_tot, x;
    combine(qi, d, m_tot, l_tot, x);
    mine[qi * RS + d] = x;
    if (d == 0) {
      mine[qi * RS + HD] = m_tot;
      mine[qi * RS + HD + 1] = l_tot;
      mine[qi * RS + HD + 2] = n_act > 0 ? 1.f : 0.f;
    }
  }
  if (!arrive_last(tickets, n_split)) return;
  if (!kWindow && !any_flag(ws_blk, n_split, kCcQB, HD)) {
    walk(n_row, nullptr, nullptr, 0);       // no valid column in the row
    finalize();
  } else {
    merge_splits<T, HD>(ws_blk, n_split, kCcQB, nq, qbase, b, g, a,
                        reinterpret_cast<float*>(ring), out);
  }
  if (tid == 0) tickets[blockIdx.x * gridDim.y + blockIdx.y] = 0;
}

// ---------------------------------------------- tensor-core body (bf16 q)

template <typename KT, int HD>
struct TcShape {
  static constexpr bool kQuant = sizeof(KT) == 1;
  static constexpr int kLd = HD + 8;                  // bf16 a padded row
  static constexpr int kTile = 32 * kLd * 2;          // a bf16 K or V tile
  static constexpr int kRawRow = kQuant ? HD + 16 : kLd * 2;
  static constexpr int kRawTile = 32 * kRawRow;
  static constexpr int kRawChunks = HD * (int)sizeof(KT) / 16;
  static constexpr int kStage = 2 * kRawTile + (kQuant ? 2 * 32 * 4 : 0);
  // the ring doubles as the merge's scratch (2 floats a query a split),
  // which at head dim 32 is larger than the ring's three stages
  static constexpr int kMerge = 2 * 4 * kTcQB * kMaxSplits;
  static constexpr int kRing = kTcStages * kStage > kMerge
                                   ? kTcStages * kStage : kMerge;
  static constexpr int kConv = kQuant ? 2 * kTile : 0;
  static size_t smem(int per) { return kRing + kConv + 8 * (size_t)per; }
};

template <typename KT, int HD, bool kWindow>
__global__ void __launch_bounds__(kTcMaxThreads) paged_tc_kernel(
    const bf16* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ page_tab,
    const uint8_t* __restrict__ valid, bf16* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ tickets, const Geo a) {
  using S = TcShape<KT, HD>;
  constexpr int NS = kTcStages;
  const int b = blockIdx.x / a.kvh, g = blockIdx.x % a.kvh;
  const int group = a.h / a.kvh;
  const int qbase = blockIdx.y * kTcQB;
  const int nq = min(kTcQB, a.sq * group - qbase);
  const int split = blockIdx.z, n_split = gridDim.z;
  const int view_len = a.pages_per_row * a.page_size;
  const int n_row = (view_len + kSub - 1) / kSub;
  const int n_part = (a.n_cols + kSub - 1) / kSub;
  const int t0 = split * a.per, t1 = min(t0 + a.per, n_part);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const bool busy = warp * 16 < nq;            // this warp has queries

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* conv = smem + S::kRing;        // int8: widened K, V tiles
  int* act = reinterpret_cast<int*>(conv + S::kConv);
  uint32_t* amask = reinterpret_cast<uint32_t*>(act + a.per);

  // Q as mma A fragments: rows warp * 16 + gid (+ 8) of the block
  uint32_t qf[HD / 16][4];
  int jrow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = warp * 16 + gid + 8 * hr;
    const int qq = qbase + r, j = qq / group, gi = qq % group;
    jrow[hr] = j;
    const bf16* qp = q + (((int64_t)b * a.sq + j) * a.h + g * group + gi) * HD;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int d = kk * 16 + 2 * tig;
      qf[kk][hr] = r < nq ? *reinterpret_cast<const uint32_t*>(qp + d) : 0u;
      qf[kk][2 + hr] =
          r < nq ? *reinterpret_cast<const uint32_t*>(qp + d + 8) : 0u;
    }
  }

  int n_act;
  if (kWindow) {
    const int j_max = (qbase + nq - 1) / group;
    n_act = max(0, min(t1, (a.pos + j_max) / kSub + 1) - t0);
  } else {
    n_act = scan_share(valid + (int64_t)b * view_len, view_len, t0, t1, act,
                       amask);
  }

  float o[HD / 8][4], m[2], l[2];

  auto walk = [&](int n, const int* al, const uint32_t* ml, int tbase) {
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    auto tile_of = [&](int i) { return al ? al[i] : tbase + i; };
    // each thread copies column `cc` of every sub-tile: chunks
    // warp, warp + nw, ... of its K and V rows (and, warp 0, its scales)
    const int cc = lane;
    int pnext = n > 0 ? page_of(a, page_tab, b, tile_of(0) * kSub + cc,
                                view_len)
                      : 0;
    auto issue = [&](int i, int st) {
      const int col = tile_of(i) * kSub + cc;
      const int page = pnext;
      if (i + 1 < n)
        pnext = page_of(a, page_tab, b, tile_of(i + 1) * kSub + cc, view_len);
      unsigned char* stage = ring + st * S::kStage;
      const uint32_t ks = smem_u32(stage + cc * S::kRawRow);
      const uint32_t vs = ks + S::kRawTile;
      const bool ok = col < view_len;
      const int64_t cell = ok ? pool_cell(a, page, col, g) : 0;
      const KT* kp = k_pool + cell * HD;
      const KT* vp = v_pool + cell * HD;
      constexpr int kVec = 16 / sizeof(KT);
      for (int c = warp; c < S::kRawChunks; c += nw) {
        cp_async16(ks + 16 * c, kp + c * kVec, ok ? 16 : 0);
        cp_async16(vs + 16 * c, vp + c * kVec, ok ? 16 : 0);
      }
      if constexpr (S::kQuant) {
        if (warp == 0) {
          const uint32_t sc = smem_u32(stage + 2 * S::kRawTile);
          cp_async4(sc + 4 * cc, k_scale + cell, ok ? 4 : 0);
          cp_async4(sc + 128 + 4 * cc, v_scale + cell, ok ? 4 : 0);
        }
      }
    };
#pragma unroll
    for (int k = 0; k < NS - 1; ++k) {
      if (k < n) issue(k, k);
      cp_async_commit();
    }
    for (int k = 0; k < n; ++k) {
      cp_async_wait<NS - 2>();    // sub-tile k landed for this thread
      __syncthreads();            // ... for all; sub-tile k - 1 is done with
      if (k + NS - 1 < n) issue(k + NS - 1, (k + NS - 1) % NS);
      cp_async_commit();
      const unsigned char* stage = ring + (k % NS) * S::kStage;
      const float* scl = reinterpret_cast<const float*>(stage + 2 * S::kRawTile);
      uint32_t kt, vt;
      if constexpr (S::kQuant) {
        // widen the stage's int8 K and V to bf16 once, for every warp
        constexpr int kPerRow = HD / 16;
        for (int it = tid; it < 2 * 32 * kPerRow; it += blockDim.x) {
          const int leaf = it / (32 * kPerRow), rem = it % (32 * kPerRow);
          const int c = rem / kPerRow, ch = rem % kPerRow;
          const uint4 u = *reinterpret_cast<const uint4*>(
              stage + leaf * S::kRawTile + c * S::kRawRow + 16 * ch);
          float f[16];
          unpack16(u, f, int8_t());
          uint4* dst = reinterpret_cast<uint4*>(conv + leaf * S::kTile +
                                                c * S::kLd * 2 + 32 * ch);
          dst[0] = make_uint4(exact_bf16x2(f[0], f[1]), exact_bf16x2(f[2], f[3]),
                              exact_bf16x2(f[4], f[5]), exact_bf16x2(f[6], f[7]));
          dst[1] = make_uint4(exact_bf16x2(f[8], f[9]),
                              exact_bf16x2(f[10], f[11]),
                              exact_bf16x2(f[12], f[13]),
                              exact_bf16x2(f[14], f[15]));
        }
        __syncthreads();
        kt = smem_u32(conv);
        vt = kt + S::kTile;
      } else {
        kt = smem_u32(stage);
        vt = kt + S::kRawTile;
      }
      if (!busy) continue;

      // S = Q K^T over the sub-tile's 32 columns (4 n-tiles of 8)
      float s[4][4];
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n8][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                               (S::kLd * 2) +
                      (kk * 2 + ((lane >> 3) & 1)) * 16);
          mma16816(s[2 * np], qf[kk], kb[0], kb[1]);
          mma16816(s[2 * np + 1], qf[kk], kb[2], kb[3]);
        }
      // element (n8, e): column n8 * 8 + 2 tig + (e & 1), row gid + 8 (e / 2)
      const int t = tile_of(k);
      const uint32_t bits = kWindow ? 0u : (al ? ml[k] : 0u);
      float pv[4][4];
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n8 * 8 + 2 * tig + (e & 1);
          const int col = t * kSub + c;
          float x = s[n8][e];
          if constexpr (S::kQuant) x = x * scl[c];
          x = x * a.scale;
          if (kWindow) x = x + (col <= a.pos + jrow[e >> 1] ? 0.f : kNegInf);
          else x = x + ((bits >> c) & 1u ? 0.f : kNegInf);
          s[n8][e] = col < view_len ? x : -INFINITY;
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8)
          mx = fmaxf(mx, fmaxf(s[n8][2 * hr], s[n8][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
        const float shift = isfinite(m_new) ? m_new : 0.f;
        const float corr = isfinite(m[hr]) ? __expf(m[hr] - shift) : 0.f;
        float ps = 0.f;
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            const float p = __expf(s[n8][e] - shift);   // exp(-inf) = 0
            ps += p;
            if constexpr (S::kQuant)
              pv[n8][e] = p * scl[32 + n8 * 8 + 2 * tig + (e & 1)];
            else
              pv[n8][e] = p;
          }
        l[hr] = l[hr] * corr + ps;
        m[hr] = m_new;
#pragma unroll
        for (int nd = 0; nd < HD / 8; ++nd) {
          o[nd][2 * hr] *= corr;
          o[nd][2 * hr + 1] *= corr;
        }
      }
      // O += P V: P rounded to bf16 as the A operand, V by ldmatrix.trans
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t pa[4] = {pack_bf16(pv[2 * j][0], pv[2 * j][1]),
                                pack_bf16(pv[2 * j][2], pv[2 * j][3]),
                                pack_bf16(pv[2 * j + 1][0], pv[2 * j + 1][1]),
                                pack_bf16(pv[2 * j + 1][2], pv[2 * j + 1][3])};
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vt + (j * 16 + (lane & 7) +
                                  (((lane >> 3) & 1) << 3)) * (S::kLd * 2) +
                                (dp * 2 + (lane >> 4)) * 16);
          mma16816(o[2 * dp], pa, vb[0], vb[1]);
          mma16816(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(kFull, l[hr], 1);
      l[hr] += __shfl_xor_sync(kFull, l[hr], 2);
    }
  };

  auto finalize = [&]() {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = warp * 16 + gid + 8 * hr;
      if (r >= nq) continue;
      const int qq = qbase + r, j = qq / group, gi = qq % group;
      bf16* op = out + (((int64_t)b * a.sq + j) * a.h + g * group + gi) * HD;
      const float inv = 1.f / (l[hr] == 0.f ? 1.f : l[hr]);
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd)
        *reinterpret_cast<uint32_t*>(op + nd * 8 + 2 * tig) =
            pack_bf16(o[nd][2 * hr] * inv, o[nd][2 * hr + 1] * inv);
    }
  };

  if (n_split == 1) {
    if (!kWindow && n_act == 0) walk(n_row, nullptr, nullptr, 0);
    else if (kWindow) walk(n_act, nullptr, nullptr, t0);
    else walk(n_act, act, amask, 0);
    finalize();
    return;
  }
  if (kWindow) walk(n_act, nullptr, nullptr, t0);
  else walk(n_act, act, amask, 0);

  constexpr int RS = HD + kWsExtra;
  float* ws_blk = ws + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) *
                           n_split * kTcQB * RS;
  float* mine = ws_blk + (size_t)split * kTcQB * RS;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = warp * 16 + gid + 8 * hr;
    if (r >= nq) continue;
    float* row = mine + (size_t)r * RS;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
      *reinterpret_cast<float2*>(row + nd * 8 + 2 * tig) =
          make_float2(o[nd][2 * hr], o[nd][2 * hr + 1]);
    if (tig == 0) {
      row[HD] = m[hr];
      row[HD + 1] = l[hr];
      row[HD + 2] = n_act > 0 ? 1.f : 0.f;
    }
  }
  if (!arrive_last(tickets, n_split)) return;
  if (!kWindow && !any_flag(ws_blk, n_split, kTcQB, HD)) {
    walk(n_row, nullptr, nullptr, 0);       // no valid column in the row
    finalize();
  } else {
    merge_splits<bf16, HD>(ws_blk, n_split, kTcQB, nq, qbase, b, g, a,
                           reinterpret_cast<float*>(ring), out);
  }
  if (tid == 0) tickets[blockIdx.x * gridDim.y + blockIdx.y] = 0;
}

// ------------------------------------------------------------ launch

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *page_tab, *valid;
  void *out, *ws, *tickets;
  int B, splits;
  Geo geo;
  cudaStream_t stream;
};

template <typename K>
int raise_smem(K kernel, size_t smem, size_t& cap) {
  // raise the dynamic shared memory cap once per instantiation to what
  // the largest launch so far needs
  if (smem > cap) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cap = smem;
  }
  return 0;
}

template <typename T, typename KT, int HD, bool kWindow, int NQ>
int launch_cc(const Args& a) {
  static size_t cap = 48 * 1024;
  const size_t smem = CcShape<KT, HD, NQ>::smem(a.geo.per);
  auto kernel = paged_cc_kernel<T, KT, HD, kWindow, NQ>;
  if (int rc = raise_smem(kernel, smem, cap)) return rc;
  const int nq = a.geo.sq * (a.geo.h / a.geo.kvh);
  const dim3 grid(a.B * a.geo.kvh, (nq + kCcQB - 1) / kCcQB, a.splits);
  kernel<<<grid, kCcThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.k_pool),
      static_cast<const KT*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int32_t*>(a.page_tab),
      static_cast<const uint8_t*>(a.valid), static_cast<T*>(a.out),
      static_cast<float*>(a.ws), static_cast<int*>(a.tickets), a.geo);
  return (int)cudaGetLastError();
}

template <typename KT, int HD, bool kWindow>
int launch_tc(const Args& a) {
  static size_t cap = 48 * 1024;
  const size_t smem = TcShape<KT, HD>::smem(a.geo.per);
  auto kernel = paged_tc_kernel<KT, HD, kWindow>;
  if (int rc = raise_smem(kernel, smem, cap)) return rc;
  const int nq = a.geo.sq * (a.geo.h / a.geo.kvh);
  // a warp per m16 tile of queries and, for the window, at least 4: the
  // warps without queries share the block's copies and int8 widening (a
  // decode block stays one warp: the card measured it faster)
  const int warps = max(kWindow ? 4 : 1, min(kTcQB / 16, (nq + 15) / 16));
  const dim3 grid(a.B * a.geo.kvh, (nq + kTcQB - 1) / kTcQB, a.splits);
  kernel<<<grid, warps * 32, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const KT*>(a.k_pool),
      static_cast<const KT*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int32_t*>(a.page_tab),
      static_cast<const uint8_t*>(a.valid), static_cast<bf16*>(a.out),
      static_cast<float*>(a.ws), static_cast<int*>(a.tickets), a.geo);
  return (int)cudaGetLastError();
}

// the query vectors a CUDA-core block computes: 8 for the window; for
// decode as many as the kv head has, rounded up to 1, 4 or 8
int cc_nq(int window, int group) {
  if (window) return kCcQB;
  return group == 1 ? 1 : group <= 4 ? 4 : kCcQB;
}

template <typename T, typename KT, int HD>
int launch_cc_decode(const Args& a) {
  switch (cc_nq(0, a.geo.h / a.geo.kvh)) {
    case 1: return launch_cc<T, KT, HD, false, 1>(a);
    case 4: return launch_cc<T, KT, HD, false, 4>(a);
    default: return launch_cc<T, KT, HD, false, kCcQB>(a);
  }
}

// Only the routes the wrapper takes, which the dtypes decide: the tensor
// cores for a bf16 window and for bf16 decode over a bf16 pool, the CUDA
// cores for f32 q and for bf16 decode over an int8 pool.  Any other tc
// is refused, so no other body is built.
template <typename T, typename KT, int HD>
int dispatch(int window, int tc, const Args& a) {
  constexpr bool kBf16 = sizeof(T) == 2, kInt8 = sizeof(KT) == 1;
  if (tc != (kBf16 && (window || !kInt8))) return (int)cudaErrorInvalidValue;
  if constexpr (kBf16) {
    if (window) return launch_tc<KT, HD, true>(a);
    if constexpr (kInt8) return launch_cc_decode<T, KT, HD>(a);
    else return launch_tc<KT, HD, false>(a);
  } else {
    if (window) return launch_cc<T, KT, HD, true, kCcQB>(a);
    return launch_cc_decode<T, KT, HD>(a);
  }
}

template <typename T, int HD>
int dispatch_kv(int kv_int8, int window, int tc, const Args& a) {
  return kv_int8 ? dispatch<T, int8_t, HD>(window, tc, a)
                 : dispatch<T, T, HD>(window, tc, a);
}

template <typename KT, int HD>
size_t smem_of(int tc, int nq, int per) {
  if (tc) return TcShape<KT, HD>::smem(per);
  return nq == 1 ? CcShape<KT, HD, 1>::smem(per)
         : nq == 4 ? CcShape<KT, HD, 4>::smem(per)
                   : CcShape<KT, HD, kCcQB>::smem(per);
}

template <int HD>
size_t smem_for(int is_bf16, int kv_int8, int tc, int nq, int per) {
  if (kv_int8) return smem_of<int8_t, HD>(tc, nq, per);
  return is_bf16 ? smem_of<bf16, HD>(tc, nq, per)
                 : smem_of<float, HD>(tc, nq, per);
}

}  // namespace

extern "C" {

// Shared memory one block needs (bytes) with `per` sub-tiles a split, 0
// for an unsupported head_dim or a tensor-core call with f32 q; the
// wrapper refuses shapes over the 227 KB a block may use.  group: query
// heads per kv head.
size_t paged_attention_smem_bytes(int is_bf16, int kv_int8, int hd, int tc,
                                  int window, int group, int per) {
  if (tc && !is_bf16) return 0;
  const int nq = cc_nq(window, group);
  if (hd == 32) return smem_for<32>(is_bf16, kv_int8, tc, nq, per);
  if (hd == 64) return smem_for<64>(is_bf16, kv_int8, tc, nq, per);
  if (hd == 128) return smem_for<128>(is_bf16, kv_int8, tc, nq, per);
  return 0;
}

// The launch.  q .. valid: the layouts above (k_scale/v_scale NULL for
// a pool in q's type, valid NULL for the window); kv_int8 = 1: k_pool/
// v_pool are int8 and k_scale/v_scale the f32 scale planes; tc: the
// route, which must be the one the dtypes decide (see dispatch).  n_cols:
// the columns the call may attend (view_len for decode, min(view_len,
// pos + sq) for the window); `splits` blocks split them in shares of
// `per` sub-tiles of 32 (splits <= 16).  ws: f32 workspace of B * kvh *
// q-blocks * splits * (8 or 128) * (hd + 4) floats; tickets: B * kvh *
// q-blocks int32 counters, all 0 (each launch leaves them 0).  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an unsupported head_dim or route.
int paged_attention_forward(const void* q, const void* k_pool,
                            const void* v_pool, const void* k_scale,
                            const void* v_scale, const void* page_tab,
                            const void* valid, void* out, void* ws,
                            void* tickets, int is_bf16, int kv_int8,
                            int window, int tc, int B, int sq, int h,
                            int kvh, int hd, int num_pages, int page_size,
                            int pages_per_row, int layer, int pos,
                            int n_cols, int splits, int per, float scale,
                            cudaStream_t stream) {
  const Args a{q, k_pool, v_pool, k_scale, v_scale, page_tab, valid,
               out, ws, tickets, B, splits,
               Geo{sq, h, kvh, num_pages, page_size, pages_per_row, layer,
                   pos, n_cols, per, scale},
               stream};
  if (hd == 32)
    return is_bf16 ? dispatch_kv<bf16, 32>(kv_int8, window, tc, a)
                   : dispatch_kv<float, 32>(kv_int8, window, tc, a);
  if (hd == 64)
    return is_bf16 ? dispatch_kv<bf16, 64>(kv_int8, window, tc, a)
                   : dispatch_kv<float, 64>(kv_int8, window, tc, a);
  if (hd == 128)
    return is_bf16 ? dispatch_kv<bf16, 128>(kv_int8, window, tc, a)
                   : dispatch_kv<float, 128>(kv_int8, window, tc, a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
