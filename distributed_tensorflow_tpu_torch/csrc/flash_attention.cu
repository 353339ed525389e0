// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ.
//
// Replaces the three Pallas kernels of distributed_tensorflow_tpu/ops/
// pallas/flash_attention.py:
//   - `_flash_forward` (body `_flash_kernel`): blockwise online-softmax
//     attention that also emits the row logsumexp;
//   - `_flash_backward`, first call (body `_flash_dkv_kernel`): dK, dV;
//   - `_flash_backward`, second call (body `_flash_dq_kernel`): dQ.
// `D = rowsum(dO * O)`, which `_flash_backward` computes in plain XLA
// before its two calls, is computed by the dQ kernel from O (or read,
// when a caller passes it), and dK/dV runs after dQ and reads it.
//
// Layouts (the JAX package's public ones; no transposes on either side):
//   q, out, do, dq  [B, Sq, H, HD]   bf16 or f32, HD 64 or 128
//   k, v, dk, dv    [B, Sk, HK, HD]  same type; H % HK == 0 (GQA: query
//                                    head h reads kv head h / (H / HK))
//   valid           [B, Sk] uint8 (1 = real key) or NULL (all keys real)
//   lse, dvec       [B, H, Sq] f32
//
// Semantics kept exactly from the Pallas bodies: masked logits are -inf
// (key padding, the causal rule q_pos >= k_pos aligned top-left, and keys
// past Sk), the running max starts at -inf and is shifted by 0 while it is
// not finite, a row with no unmasked key gives out 0 and lse -inf, and the
// backward's p = exp(s - lse) is 0 on such a row.  Logits, softmax and
// every accumulator are f32 whatever the input type.
//
// Design.  The TPU runs a sequential grid (batch, head, q blocks, k
// blocks) of 512 x 1024 blocks and carries the softmax state in VMEM
// scratch from one k step to the next.  Blocks run in parallel on Hopper,
// so each loop that the TPU grid walked in order is a loop inside one
// thread block here:
//   - forward: one block per (head, batch, 128-row q tile) walks the
//     64-row K/V tiles (only up to the diagonal when causal);
//   - dQ: one block per (batch, head, 64-row q tile), the same walk,
//     with D of its rows computed first;
//   - dK/dV: one block per (batch, kv head, 64-row k tile) walks every
//     query head of its group and, for each, the q tiles from the
//     diagonal on.  Summing the group's heads inside the block writes
//     dK/dV at [B, Sk, HK, HD] directly, where the TPU wrote per-q-head
//     outputs and summed them in a second pass.
// Two routes share that structure and the exact mask semantics:
//   - bf16 (the training path): tensor cores through mma.sync.m16n8k16,
//     f32 accumulators and row statistics in registers (see "tensor-core
//     path" and "forward, bf16" below);
//   - f32: the CUDA cores in full f32 (fused multiply-adds), f32 tiles in
//     shared memory, 256 threads each owning a 4 x 4 patch of the 64 x 64
//     score tile, rows reduced over 16 lanes with shuffles.
//
// What bounds it on the H100: bytes.  At the training shape (B 48, Sq =
// Sk = 256, 12 heads of 64, bf16, causal) the forward must move 76 MB
// (q, k, v, out, lse: 22.7 us at 3.35 TB/s) for 4.8 GFLOP of causal
// products (4.9 us at 989 TFLOP/s), so the design's aim is bytes in
// flight and no idle tensor cores while they arrive:
//   - the bf16 forward keeps Q in registers and streams K/V through a
//     two-stage cp.async ring, so tile t + 1 lands while tile t is
//     multiplied; XOR-swizzled tiles make every ldmatrix (Q, K, and V
//     transposed) conflict-free; 128-row q tiles halve the K/V re-reads
//     of 64-row ones; the mask runs only on the tiles that need it, and
//     a causal grid's heaviest tiles go first, so its tail is light;
//   - the bf16 dQ and dK/dV kernels take the same tools (see "backward,
//     bf16" below): the walked operand streams through the cp.async ring,
//     the held one stays in registers (HD 64) or in swizzled tiles (HD
//     128), every fragment comes by ldmatrix, the softmax is recomputed
//     with one ex2 an element, and D costs dQ one read of O instead of a
//     chain of torch elementwise kernels;
//   - mma.sync and not wgmma: at this shape the products are a fifth of
//     the byte time, and mma.sync's per-warp fragments keep the softmax
//     in registers with no warpgroup synchronisation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kB = 64;          // rows of a q tile and of a k tile
constexpr int kThreads = 256;   // 16 row groups x 16 lanes

// max / sum over the 16 lanes that share a row (lanes tx = 0..15 of one
// half-warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int HD>
struct Tile {
  static constexpr int kLd = HD + 1;       // padded f32 row of a tile
  static constexpr int kFloats = kB * kLd;
  static constexpr int kLdS = kB + 1;      // padded row of a score tile
  static constexpr int kScore = kB * kLdS;
  static constexpr int kCols = HD / 16;    // accumulator columns a thread owns
};

// Rows r0 .. r0 + kB - 1 of head `head` of a [B, S, NH, HD] f32 tensor
// into a padded tile, 16 bytes at a time; rows at or past S are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int b, int r0, int S, int NH,
                                          int head) {
  constexpr int kChunks = HD / 4;
  for (int idx = threadIdx.x; idx < kB * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      f = *reinterpret_cast<const float4*>(
          src + (((int64_t)b * S + r0 + r) * NH + head) * HD + c * 4);
    float* d = dst + r * Tile<HD>::kLd + c * 4;   // padded: not 16B aligned
    d[0] = f.x;
    d[1] = f.y;
    d[2] = f.z;
    d[3] = f.w;
  }
}

// 1 for key columns c0 .. c0 + kB - 1 that exist and are valid, else 0
__device__ __forceinline__ void load_keymask(float* dst,
                                             const uint8_t* __restrict__ valid,
                                             int b, int c0, int Sk) {
  for (int c = threadIdx.x; c < kB; c += blockDim.x) {
    const int col = c0 + c;
    dst[c] = (col < Sk && (valid == nullptr || valid[(int64_t)b * Sk + col]))
                 ? 1.f : 0.f;
  }
}

// ------------------------------------------ CUDA-core path (f32 only)
//
// The kernels for f32 inputs: f32 tiles in shared memory, products in
// f32 fused multiply-adds (see the header).

// ---------------------------------------------------------------- forward

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v,
    const uint8_t* __restrict__ valid, float* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int HK, float scale,
    int causal) {
  using Tl = Tile<HD>;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / HK);
  const int q0 = qt * kB;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + Tl::kFloats;
  float* Vs = Ks + Tl::kFloats;
  float* Ps = Vs + Tl::kFloats;
  float* keym = Ps + Tl::kScore;

  load_tile<HD>(Qs, q, b, q0, Sq, H, h);

  float m[4], l[4], acc[4][Tl::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < Tl::kCols; ++j) acc[i][j] = 0.f;
  }

  int nk = (Sk + kB - 1) / kB;
  if (causal) nk = min(nk, qt + 1);   // tiles above the diagonal add nothing
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();                  // the last tile's readers are done
    load_tile<HD>(Ks, k, b, k0, Sk, HK, g);
    load_tile<HD>(Vs, v, b, k0, Sk, HK, g);
    load_keymask(keym, valid, b, k0, Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * Tl::kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * Tl::kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = keym[c] > 0.5f && (!causal || row >= k0 + c);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float shift = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m[i]) ? expf(m[i] - shift) : 0.f;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - shift);   // exp(-inf) = 0
        Ps[r * Tl::kLdS + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < Tl::kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kB; ++c) {
      float pa[4], vb[Tl::kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty * 4 + i) * Tl::kLdS + c];
#pragma unroll
      for (int j = 0; j < Tl::kCols; ++j) vb[j] = Vs[c * Tl::kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < Tl::kCols; ++j)
          acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float denom = l[i] > 0.f ? l[i] : 1.f;
    float* orow = out + (((int64_t)b * Sq + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < Tl::kCols; ++j)
      orow[tx + 16 * j] = acc[i][j] / denom;
    if (tx == 0) {
      const float shift = isfinite(m[i]) ? m[i] : 0.f;
      lse[((int64_t)b * H + h) * Sq + row] =
          l[i] > 0.f ? shift + logf(l[i]) : -INFINITY;
    }
  }
}

// -------------------------------------------------------------------- dQ

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v,
    const uint8_t* __restrict__ valid, const float* __restrict__ dout,
    const float* __restrict__ out, const float* __restrict__ lse,
    float* __restrict__ dvec, float* __restrict__ dq, int Sq, int Sk, int H,
    int HK, float scale, int causal) {
  using Tl = Tile<HD>;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / HK);
  const int q0 = qt * kB;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + Tl::kFloats;
  float* Ks = dOs + Tl::kFloats;
  float* Vs = Ks + Tl::kFloats;
  float* dSs = Vs + Tl::kFloats;
  float* keym = dSs + Tl::kScore;
  float* lse_s = keym + kB;
  float* d_s = lse_s + kB;

  load_tile<HD>(Qs, q, b, q0, Sq, H, h);
  load_tile<HD>(dOs, dout, b, q0, Sq, H, h);
  for (int r = tid; r < kB; r += kThreads) {
    const bool in = q0 + r < Sq;
    const int64_t idx = ((int64_t)b * H + h) * Sq + q0 + r;
    lse_s[r] = in ? lse[idx] : 0.f;   // padded rows: dO = 0, D = 0
    d_s[r] = in && out == nullptr ? dvec[idx] : 0.f;
  }
  if (out != nullptr) {
    // D = rowsum(dO * O) of the block's rows, 16 lanes a row, also
    // written out for the dK/dV kernel
    __syncthreads();                  // the dO tile is complete
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = q0 + r;
      float d = 0.f;
      if (row < Sq) {
        const float* orow = out + (((int64_t)b * Sq + row) * H + h) * HD;
        for (int c = tx; c < HD; c += 16)
          d = fmaf(dOs[r * Tl::kLd + c], orow[c], d);
      }
      d = row_sum(d);
      if (tx == 0 && row < Sq) {
        d_s[r] = d;
        dvec[((int64_t)b * H + h) * Sq + row] = d;
      }
    }
  }

  float acc[4][Tl::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < Tl::kCols; ++j) acc[i][j] = 0.f;

  int nk = (Sk + kB - 1) / kB;
  if (causal) nk = min(nk, qt + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    load_tile<HD>(Ks, k, b, k0, Sk, HK, g);
    load_tile<HD>(Vs, v, b, k0, Sk, HK, g);
    load_keymask(keym, valid, b, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ty * 4 + i) * Tl::kLd + d];
        oa[i] = dOs[(ty * 4 + i) * Tl::kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = Ks[(tx + 16 * j) * Tl::kLd + d];
        vb[j] = Vs[(tx + 16 * j) * Tl::kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = q0 + r;
      const float L = lse_s[r];
      const bool live = isfinite(L);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = keym[c] > 0.5f && (!causal || row >= k0 + c);
        const float sc = ok ? s[i][j] * scale : -INFINITY;
        const float p = live ? expf(sc - L) : 0.f;
        dSs[r * Tl::kLdS + c] = p * (dp[i][j] - d_s[r]) * scale;
      }
    }
    __syncthreads();

    for (int c = 0; c < kB; ++c) {
      float da[4], kb[Tl::kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = dSs[(ty * 4 + i) * Tl::kLdS + c];
#pragma unroll
      for (int j = 0; j < Tl::kCols; ++j) kb[j] = Ks[c * Tl::kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < Tl::kCols; ++j)
          acc[i][j] = fmaf(da[i], kb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    float* drow = dq + (((int64_t)b * Sq + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < Tl::kCols; ++j)
      drow[tx + 16 * j] = acc[i][j];
  }
}

// ----------------------------------------------------------------- dK/dV

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v,
    const uint8_t* __restrict__ valid, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
    int HK, float scale, int causal) {
  using Tl = Tile<HD>;
  const int kt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int group = H / HK;
  const int k0 = kt * kB;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + Tl::kFloats;
  float* Qs = Vs + Tl::kFloats;
  float* dOs = Qs + Tl::kFloats;
  float* Pt = dOs + Tl::kFloats;        // [k row][q col]
  float* dSt = Pt + Tl::kScore;         // [k row][q col]
  float* keym = dSt + Tl::kScore;       // per k row of this tile
  float* lse_s = keym + kB;             // per q row of the current q tile
  float* d_s = lse_s + kB;

  load_tile<HD>(Ks, k, b, k0, Sk, HK, g);
  load_tile<HD>(Vs, v, b, k0, Sk, HK, g);
  load_keymask(keym, valid, b, k0, Sk);

  float dk_acc[4][Tl::kCols], dv_acc[4][Tl::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < Tl::kCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (Sq + kB - 1) / kB;
  // q tiles wholly above the diagonal add nothing to this k tile
  const int qt_first = causal ? kt : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = g * group + gi;
    for (int qt = qt_first; qt < nq; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();
      load_tile<HD>(Qs, q, b, q0, Sq, H, h);
      load_tile<HD>(dOs, dout, b, q0, Sq, H, h);
      for (int r = tid; r < kB; r += kThreads) {
        const bool in = q0 + r < Sq;
        const int64_t idx = ((int64_t)b * H + h) * Sq + q0 + r;
        lse_s[r] = in ? lse[idx] : 0.f;
        d_s[r] = in ? dvec[idx] : 0.f;
      }
      __syncthreads();

      // this thread: k rows ty * 4 + i, q columns tx + 16 * j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < HD; ++d) {
        float ka[4], va[4], qb[4], ob[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = Ks[(ty * 4 + i) * Tl::kLd + d];
          va[i] = Vs[(ty * 4 + i) * Tl::kLd + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qb[j] = Qs[(tx + 16 * j) * Tl::kLd + d];
          ob[j] = dOs[(tx + 16 * j) * Tl::kLd + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
            dp[i][j] = fmaf(va[i], ob[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, col = k0 + r;
        const bool key_ok = keym[r] > 0.5f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float L = lse_s[c];
          const bool ok = key_ok && (!causal || q0 + c >= col);
          const float sc = ok ? s[i][j] * scale : -INFINITY;
          const float p = isfinite(L) ? expf(sc - L) : 0.f;
          Pt[r * Tl::kLdS + c] = p;
          dSt[r * Tl::kLdS + c] = p * (dp[i][j] - d_s[c]) * scale;
        }
      }
      __syncthreads();

      for (int c = 0; c < kB; ++c) {
        float pa[4], da[4], ob[Tl::kCols], qb[Tl::kCols];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = Pt[(ty * 4 + i) * Tl::kLdS + c];
          da[i] = dSt[(ty * 4 + i) * Tl::kLdS + c];
        }
#pragma unroll
        for (int j = 0; j < Tl::kCols; ++j) {
          ob[j] = dOs[c * Tl::kLd + tx + 16 * j];
          qb[j] = Qs[c * Tl::kLd + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < Tl::kCols; ++j) {
            dv_acc[i][j] = fmaf(pa[i], ob[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(da[i], qb[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= Sk) continue;
    const int64_t off = (((int64_t)b * Sk + row) * HK + g) * HD;
#pragma unroll
    for (int j = 0; j < Tl::kCols; ++j) {
      dk[off + tx + 16 * j] = dk_acc[i][j];
      dv[off + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

// ------------------------------------------ tensor-core path (bf16 only)
//
// For bf16 inputs the three kernels run their products on the tensor cores
// with mma.sync.m16n8k16 (bf16 operands, f32 accumulators).  A warp owns
// 16 rows of a tile, so its score tile is 16 x 64 in mma accumulator
// layout: lane (gid = lane / 4, tig = lane % 4) holds rows gid and gid + 8,
// columns 8 n + 2 tig + {0, 1}, and a row's statistics reduce over its 4
// lanes.  The probabilities (and dS) are rounded to bf16 to enter the
// second product, as flash attention does on every GPU; the softmax sums
// stay f32.  f32 inputs keep the CUDA-core kernels above, which compute in
// f32 throughout.

using bf16 = __nv_bfloat16;

// ----------------------------------------- forward, bf16 (Hopper design)
//
// One block per (head, batch, 128-row q tile): 8 warps of 16 q rows.  Q
// is copied once and held in registers as mma A fragments; K and V tiles
// of 64 keys stream through a ring of kStages shared-memory stages filled
// by cp.async a tile ahead, so tile t + 1 lands while tile t is
// multiplied.  Shared tiles are unpadded rows of HD bf16 whose 16-byte
// chunks are XOR-swizzled by the row (chunk ^ row % 8), so the 8 row
// addresses of every ldmatrix phase, and every cp.async row, fall in 8
// distinct bank groups.  K fragments come by ldmatrix.x4, V fragments by
// ldmatrix.x4.trans (V is read down its columns for P V).  The softmax
// runs in log2 units (log2(e) folded into the scale, one MUFU ex2 per
// element); a row's sum stays split over its 4 lanes until the end; the
// stored lse is converted back to the natural log, which dK/dV and dQ
// read.  The mask is evaluated only on tiles that need it: with a valid
// plane, on the ragged last tile, and (causal) on tiles that cross the
// warp's diagonal; tiles wholly above it are skipped.  Causal grids run
// their heaviest q tiles first.  Each thread's copy addresses are worked
// out once (TileLoader), and the epilogue multiplies by one reciprocal a
// row: the kernel is latency-bound, so every instruction of a warp's
// dependent chain counts.

constexpr int kFwdRows = 128;                 // q rows of a block
constexpr int kFwdThreads = kFwdRows / 16 * 32;   // a warp per 16 rows
constexpr int kStages = 2;                    // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x in one MUFU instruction (denormal results flush to 0; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte chunk c of row r in a swizzled tile of HD bf16
template <int HD>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * (HD * 2) + ((c ^ (r & 7)) << 4));
}

// This thread's share (of NT threads) of the cp.async copies of an R-row
// tile of head `head` of a [B, S, NH, HD] bf16 tensor into a swizzled
// tile: chunk c of rows row0, row0 + kRowStep, ...; their global offset
// (for tile 0) and swizzled shared offset are worked out once, and tile t
// adds t * R rows (and `extra` elements, another head of the same rows).
// Rows at or past S are zeros.
template <int HD, int R, int NT = kFwdThreads>
struct TileLoader {
  static constexpr int kChunks = HD / 8;
  static constexpr int kPer = R * kChunks / NT;
  static constexpr int kRowStep = NT / kChunks;
  static_assert(R * kChunks % NT == 0, "whole chunks a thread");
  int row0;
  int64_t off0, row_elems;
  uint32_t soff0;

  __device__ __forceinline__ TileLoader(int b, int S, int NH, int head) {
    row0 = threadIdx.x / kChunks;
    const int c = threadIdx.x % kChunks;
    row_elems = (int64_t)NH * HD;
    off0 = ((int64_t)b * S + row0) * row_elems + (int64_t)head * HD + c * 8;
    soff0 = swz<HD>(row0, c);   // row0 + i * kRowStep: the same swizzle
  }
  __device__ __forceinline__ void load(uint32_t dst,
                                       const bf16* __restrict__ src, int t,
                                       int S, int64_t extra = 0) const {
    const bf16* base = src + off0 + extra + (int64_t)t * R * row_elems;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const bool in = t * R + row0 + i * kRowStep < S;
      cp_async16(dst + soff0 + i * kRowStep * HD * 2,
                 in ? base + i * kRowStep * row_elems : src, in ? 16 : 0);
    }
  }
};

// S = Q K^T for one warp: 16 q rows (fragments qf) by the 64 keys of the
// swizzled K tile at shared address ks
template <int HD>
__device__ __forceinline__ void qk_tile(float (&s)[8][4],
                                        const uint32_t (&qf)[HD / 16][4],
                                        uint32_t ks, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t kb[4];
      ldsm_x4(kb, ks + swz<HD>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                               kk * 2 + ((lane >> 3) & 1)));
      mma16816(s[2 * np], qf[kk], kb[0], kb[1]);
      mma16816(s[2 * np + 1], qf[kk], kb[2], kb[3]);
    }
}

// Two blocks an SM at HD 64 (at most 128 registers a thread); HD 128
// needs more registers than that for Q, O and the scores.
template <int HD>
__global__ void __launch_bounds__(kFwdThreads, HD == 64 ? 2 : 1)
flash_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const uint8_t* __restrict__ valid,
    bf16* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H,
    int HK, float scale_log2, int causal) {
  constexpr int kTile = kB * HD * 2;          // bytes of a K or V tile
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int g = h / (H / HK);
  const int q0 = qt * kFwdRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr0 = q0 + warp * 16;             // this warp's first q row

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t q_s = smem_u32(smem_raw);
  const uint32_t kv_s = q_s + kFwdRows * HD * 2;   // stage s: K, then V
  uint8_t* keym = smem_raw + kFwdRows * HD * 2 + kStages * 2 * kTile;

  // key tiles any row of this block can see
  int nk = (Sk + kB - 1) / kB;
  if (causal) nk = min(nk, (min(q0 + kFwdRows, Sq) - 1) / kB + 1);

  const TileLoader<HD, kB> kv_load(b, Sk, HK, g);   // the same chunks in K, V
  auto issue = [&](int t) {
    const int st = t % kStages;
    const uint32_t ks = kv_s + st * 2 * kTile;
    kv_load.load(ks, k, t, Sk);
    kv_load.load(ks + kTile, v, t, Sk);
    if (valid != nullptr && threadIdx.x < kB) {
      const int col = t * kB + threadIdx.x;
      keym[st * kB + threadIdx.x] =
          col < Sk ? valid[(int64_t)b * Sk + col] : 0;
    }
  };

  TileLoader<HD, kFwdRows>(b, Sq, H, h).load(q_s, q, qt, Sq);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nk) issue(t);
    cp_async_commit();
  }

  // m: running max in log2 units; l: this lane's part of the row sum (the
  // 4 lanes of a row share m, and their parts are added at the end)
  uint32_t qf[HD / 16][4];
  float o[HD / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    if (t + kStages - 1 < nk) issue(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();     // tile t (and Q) landed for this thread
    __syncthreads();                  // ... and for every thread
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldsm_x4(qf[kk], q_s + swz<HD>(warp * 16 + (lane & 15),
                                      kk * 2 + (lane >> 4)));
    }
    const int k0 = t * kB;
    const int st = t % kStages;
    const uint32_t ks = kv_s + st * 2 * kTile, vs = ks + kTile;
    // rows past Sq are never stored; causal keys past the warp's last row
    // are all masked
    if (wr0 < Sq && (!causal || k0 <= wr0 + 15)) {
      float s[8][4];
      qk_tile<HD>(s, qf, ks, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
      // the mask only where some key is masked: a valid plane, the ragged
      // last tile, a tile crossing the warp's diagonal
      if (valid != nullptr || k0 + kB > Sk || (causal && k0 + kB - 1 > wr0)) {
        // element (n, e) is key k0 + 2 tig + off of row wr0 + gid + 8 (e/2)
        const int keys = Sk - k0 - 2 * tig;     // key exists: off < keys
        const int diag = wr0 + gid - k0 - 2 * tig;   // row - key at off 0
        const uint8_t* km = keym + st * kB + 2 * tig;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int off = n * 8 + (e & 1);
            const bool ok = off < keys &&
                            (!causal || diag + 8 * (e >> 1) >= off) &&
                            (valid == nullptr || km[off]);
            if (!ok) s[n][e] = -INFINITY;
          }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
        const float shift = isfinite(m_new) ? m_new : 0.f;
        const float corr = isfinite(m[hr]) ? ex2(m[hr] - shift) : 0.f;
        float ps = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            s[n][e] = ex2(s[n][e] - shift);       // 2^-inf = 0
            ps += s[n][e];
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
      for (int j = 0; j < 4; ++j) {
        const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                               pack_bf16(s[2 * j][2], s[2 * j][3]),
                               pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                               pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vs + swz<HD>(j * 16 + (lane & 7) +
                                             (((lane >> 3) & 1) << 3),
                                         dp * 2 + (lane >> 4)));
          mma16816(o[2 * dp], a, vb[0], vb[1]);
          mma16816(o[2 * dp + 1], a, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();                  // stage st is free for tile t + kStages
  }
  cp_async_wait<0>();
  __syncthreads();                    // Q's copies landed before its reuse

  // out = O / l in bf16, staged through this warp's 16 rows of the Q tile
  // and written 16 bytes at a time
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(kFull, l[hr], 1);
    l[hr] += __shfl_xor_sync(kFull, l[hr], 2);
    const int r = warp * 16 + gid + 8 * hr;
    const float inv = l[hr] > 0.f ? 1.f / l[hr] : 1.f;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
      *reinterpret_cast<uint32_t*>(smem_raw + swz<HD>(r, nd) + 4 * tig) =
          pack_bf16(o[nd][2 * hr] * inv, o[nd][2 * hr + 1] * inv);
    const int row = q0 + r;
    if (tig == 0 && row < Sq) {
      const float shift = isfinite(m[hr]) ? m[hr] : 0.f;
      lse[((int64_t)b * H + h) * Sq + row] =
          l[hr] > 0.f ? (shift + log2f(l[hr])) * kLn2 : -INFINITY;
    }
  }
  __syncwarp();
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int rr = idx / kChunks, c = idx % kChunks;
    const int row = wr0 + rr;
    if (row < Sq)
      *reinterpret_cast<uint4*>(out + (((int64_t)b * Sq + row) * H + h) * HD +
                                c * 8) =
          *reinterpret_cast<const uint4*>(smem_raw +
                                          swz<HD>(warp * 16 + rr, c));
  }
}

// ---------------------------------------- backward, bf16 (Hopper design)
//
// Two kernels and no atomics, so dQ, dK and dV are the same bits from
// call to call: dQ runs first and also writes D = rowsum(dO * O), which
// dK/dV then reads.  Both take the forward's tools: a block of 4 warps of
// 16 rows over 64-row tiles; the operand that the block walks streams
// through a ring of kStages XOR-swizzled shared stages filled by cp.async
// a tile ahead (TileLoader); every fragment comes by ldmatrix (x4, or x4
// .trans for an operand read down its columns); the softmax is recomputed
// in log2 units, one MUFU ex2 an element from the stored natural-log lse
// (-inf lse: p = 0); and masks run only on the tiles that need them.
//   - dQ: one block per (head, batch, q tile), heaviest causal tiles
//     first.  Q and dO are copied once (held in registers as A fragments
//     at HD 64, read from their swizzled tiles at HD 128, where registers
//     run short); the prologue computes D of its rows from O and the dO
//     tile (or reads a given D) while K/V tile 0 lands; then per K/V tile
//     S = Q K^T, dP = dO V^T (B by ldmatrix), dS = P (dP - D), dQ += dS K
//     (B by ldmatrix.trans).  Masked: valid plane, ragged last tile, tiles
//     crossing a warp's diagonal.
//   - dK/dV: one block per (kv head, batch, k tile), k tile 0 (the
//     heaviest when causal) first.  K and V stay (registers at HD 64,
//     swizzled tiles at HD 128); the block walks every query head of its
//     group and, for each, the q tiles from the diagonal on, as one
//     stream of stages of (Q, dO, lse, D).  Per stage S^T = K Q^T and dP^T
//     = V dO^T take B from Q and dO by ldmatrix; dV += P^T dO and dK +=
//     dS^T Q take A from P and dS rounded to bf16 and B from the same
//     tiles by ldmatrix.trans.  A key's dK and dV rows depend on that key
//     alone, so invalid keys and keys past Sk are simply not kept (their
//     rows are stored as 0 or not at all), and only the causal diagonal
//     tile is masked; q rows past Sq arrive as zeros (dO, lse, D) and add
//     nothing.
//   - The scale of dS is applied once, to dQ and dK in the epilogue, and
//     every output leaves through shared memory in 16-byte stores.

constexpr int kBwdThreads = 128;              // 4 warps of 16 rows
static_assert(kBwdThreads == 2 * kB, "two threads a row of a tile");

struct Frag {
  uint32_t r[4];
};

// A warp's 16 rows of a swizzled HD-wide tile as mma A operands: held in
// registers (hold() after the tile landed) or read by ldmatrix at each use
template <int HD, bool kHeld>
struct ARows {
  Frag f[kHeld ? HD / 16 : 1];
  uint32_t addr;                // this lane's ldmatrix row
  int sw, hi;

  __device__ __forceinline__ ARows(uint32_t tile, int r0, int lane) {
    const int row = r0 + (lane & 15);
    addr = tile + row * (HD * 2);
    sw = row & 7;
    hi = lane >> 4;
  }
  __device__ __forceinline__ Frag fetch(int kk) const {
    Frag x;
    ldsm_x4(x.r, addr + (((kk * 2 + hi) ^ sw) << 4));
    return x;
  }
  __device__ __forceinline__ void hold() {
    if constexpr (kHeld) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) f[kk] = fetch(kk);
    }
  }
  __device__ __forceinline__ Frag get(int kk) const {
    if constexpr (kHeld) return f[kk];
    else return fetch(kk);
  }
};

// s[16 x 64] = a[16 x HD] times the 64 rows of the swizzled tile bs,
// transposed (B by ldmatrix.x4, as qk_tile)
template <int HD, class A>
__device__ __forceinline__ void score_tile(float (&s)[8][4], const A& a,
                                           uint32_t bs, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const Frag af = a.get(kk);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t kb[4];
      ldsm_x4(kb, bs + swz<HD>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                               kk * 2 + ((lane >> 3) & 1)));
      mma16816(s[2 * np], af.r, kb[0], kb[1]);
      mma16816(s[2 * np + 1], af.r, kb[2], kb[3]);
    }
  }
}

// acc[16 x HD] += p[16 x 64] (score layout, rounded to bf16 as the A
// operand) times the 64 x HD swizzled tile ts (B by ldmatrix.x4.trans)
template <int HD>
__device__ __forceinline__ void acc_tile(float (&acc)[HD / 8][4],
                                         const float (&p)[8][4], uint32_t ts,
                                         int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                           pack_bf16(p[2 * j][2], p[2 * j][3]),
                           pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, ts + swz<HD>(j * 16 + (lane & 7) +
                                         (((lane >> 3) & 1) << 3),
                                     dp * 2 + (lane >> 4)));
      mma16816(acc[2 * dp], a, vb[0], vb[1]);
      mma16816(acc[2 * dp + 1], a, vb[2], vb[3]);
    }
  }
}

// A warp's acc[16 x HD] times `mul`, rows with keep false as 0, rounded to
// bf16 through rows r0 .. r0 + 15 of the swizzled tile `tile`, then
// written 16 bytes at a time to dst + i * stride for the rows i < rows
template <int HD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           int64_t stride, int rows,
                                           unsigned char* tile, int r0,
                                           const float (&acc)[HD / 8][4],
                                           float mul, const bool (&keep)[2],
                                           int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + gid + 8 * hr;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
      *reinterpret_cast<uint32_t*>(tile + swz<HD>(r, nd) + 4 * tig) =
          keep[hr] ? pack_bf16(acc[nd][2 * hr] * mul,
                               acc[nd][2 * hr + 1] * mul)
                   : 0u;
  }
  __syncwarp();
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int rr = idx / kChunks, c = idx % kChunks;
    if (rr < rows)
      *reinterpret_cast<uint4*>(dst + rr * stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<HD>(r0 + rr, c));
  }
}

// d + the sum over 8 bf16 pairs of a * b, in f32 (a bf16 is the upper
// half of its f32)
__device__ __forceinline__ float dot2(uint32_t a, uint32_t b, float d) {
  d = fmaf(__uint_as_float(a << 16), __uint_as_float(b << 16), d);
  return fmaf(__uint_as_float(a & 0xffff0000u),
              __uint_as_float(b & 0xffff0000u), d);
}
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float d) {
  d = dot2(a.x, b.x, d);
  d = dot2(a.y, b.y, d);
  d = dot2(a.z, b.z, d);
  return dot2(a.w, b.w, d);
}

// -log2(e) * lse, or -inf for a row with no unmasked key (so p = 0)
__device__ __forceinline__ float neg_lse2(float lse) {
  return isfinite(lse) ? -lse * kLog2e : -INFINITY;
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads) flash_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const uint8_t* __restrict__ valid,
    const bf16* __restrict__ dout, const bf16* __restrict__ out,
    const float* __restrict__ lse, float* __restrict__ dvec,
    bf16* __restrict__ dq, int Sq, int Sk, int H, int HK, float scale,
    float scale_log2, int causal) {
  constexpr int kTile = kB * HD * 2;          // bytes of a 64-row tile
  constexpr int kChunks = HD / 8;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int g = h / (H / HK);
  const int q0 = qt * kB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr0 = q0 + warp * 16;             // this warp's first q row

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t q_s = smem_u32(smem_raw);
  const uint32_t do_s = q_s + kTile;
  const uint32_t kv_s = do_s + kTile;         // stage s: K, then V
  float* d_s = reinterpret_cast<float*>(smem_raw + (2 + 2 * kStages) * kTile);
  uint8_t* keym = reinterpret_cast<uint8_t*>(d_s + kB);

  // key tiles any row of this block can see
  int nk = (Sk + kB - 1) / kB;
  if (causal) nk = min(nk, (min(q0 + kB, Sq) - 1) / kB + 1);

  const TileLoader<HD, kB, kBwdThreads> kv_load(b, Sk, HK, g);
  auto issue = [&](int t) {
    const int st = t % kStages;
    const uint32_t ks = kv_s + st * 2 * kTile;
    kv_load.load(ks, k, t, Sk);
    kv_load.load(ks + kTile, v, t, Sk);
    if (valid != nullptr && threadIdx.x < kB) {
      const int col = t * kB + threadIdx.x;
      keym[st * kB + threadIdx.x] =
          col < Sk ? valid[(int64_t)b * Sk + col] : 0;
    }
  };

  {
    const TileLoader<HD, kB, kBwdThreads> q_load(b, Sq, H, h);
    q_load.load(q_s, q, qt, Sq);
    q_load.load(do_s, dout, qt, Sq);
  }
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nk) issue(t);
    cp_async_commit();
  }

  // this lane's rows: -log2(e) lse, and later D
  const int64_t rows = ((int64_t)b * H + h) * Sq;
  float nl2[2], dd[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = wr0 + gid + 8 * hr;
    nl2[hr] = row < Sq ? neg_lse2(lse[rows + row]) : 0.f;
  }

  cp_async_wait<kStages - 1>();   // Q and dO landed; K/V tile 0 may not
  __syncthreads();
  {
    // D = rowsum(dO * O) of the block's rows, two threads a row (or the
    // given D)
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    float d = 0.f;
    if (out != nullptr) {
      if (row < Sq) {
        const bf16* orow = out + (((int64_t)b * Sq + row) * H + h) * HD;
#pragma unroll
        for (int c = half * kChunks / 2; c < (half + 1) * kChunks / 2; ++c)
          d = dot8(*reinterpret_cast<const uint4*>(orow + c * 8),
                   *reinterpret_cast<const uint4*>(smem_raw + kTile +
                                                   swz<HD>(r, c)), d);
      }
      d += __shfl_xor_sync(kFull, d, 1);
      if (half == 0 && row < Sq) dvec[rows + row] = d;
    } else if (row < Sq) {
      d = dvec[rows + row];
    }
    if (half == 0) d_s[r] = d;
  }
  ARows<HD, HD == 64> qa(q_s, warp * 16, lane), doa(do_s, warp * 16, lane);
  qa.hold();
  doa.hold();
  __syncthreads();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) dd[hr] = d_s[warp * 16 + gid + 8 * hr];

  float acc[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    if (t + kStages - 1 < nk) issue(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();     // tile t landed for this thread
    __syncthreads();                  // ... and for every thread
    const int k0 = t * kB;
    const int st = t % kStages;
    const uint32_t ks = kv_s + st * 2 * kTile, vs = ks + kTile;
    // rows past Sq are never stored; causal keys past the warp's last row
    // are all masked
    if (wr0 < Sq && (!causal || k0 <= wr0 + 15)) {
      float s[8][4], dp[8][4];
      score_tile<HD>(s, qa, ks, lane);           // S = Q K^T
      if (valid != nullptr || k0 + kB > Sk || (causal && k0 + kB - 1 > wr0)) {
        // element (n, e) is key k0 + 2 tig + off of row wr0 + gid + 8 (e/2)
        const int keys = Sk - k0 - 2 * tig;     // key exists: off < keys
        const int diag = wr0 + gid - k0 - 2 * tig;   // row - key at off 0
        const uint8_t* km = keym + st * kB + 2 * tig;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int off = n * 8 + (e & 1);
            const bool ok = off < keys &&
                            (!causal || diag + 8 * (e >> 1) >= off) &&
                            (valid == nullptr || km[off]);
            if (!ok) s[n][e] = -INFINITY;
          }
      }
      score_tile<HD>(dp, doa, vs, lane);         // dP = dO V^T
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const float p = ex2(fmaf(s[n][e], scale_log2, nl2[hr]));
          s[n][e] = p * (dp[n][e] - dd[hr]);     // dS / scale
        }
      acc_tile<HD>(acc, s, ks, lane);            // dQ += dS K
    }
    __syncthreads();                  // stage st is free for tile t + kStages
  }
  cp_async_wait<0>();
  __syncthreads();                    // the Q tile is free for the output

  const bool keep[2] = {true, true};
  store_rows<HD>(dq + (((int64_t)b * Sq + wr0) * H + h) * HD,
                 (int64_t)H * HD, Sq - wr0, smem_raw, warp * 16, acc, scale,
                 keep, lane);
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads) flash_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const uint8_t* __restrict__ valid,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Sq, int Sk, int H, int HK, float scale,
    float scale_log2, int causal) {
  constexpr int kTile = kB * HD * 2;
  constexpr int kStage = 2 * kTile + 2 * kB * 4;   // Q, dO, lse, D
  const int g = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int group = H / HK;
  const int k0 = kt * kB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kw0 = k0 + warp * 16;             // this warp's first key

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t k_s = smem_u32(smem_raw);
  const uint32_t v_s = k_s + kTile;
  const uint32_t ring = v_s + kTile;

  // the (head, q tile) pairs of the group, q tiles from the diagonal on
  const int nq = (Sq + kB - 1) / kB;
  const int qt_first = causal ? kt : 0;
  const int nqt = max(nq - qt_first, 0);
  const int T = group * nqt;

  {
    const TileLoader<HD, kB, kBwdThreads> kv_load(b, Sk, HK, g);
    kv_load.load(k_s, k, kt, Sk);
    kv_load.load(v_s, v, kt, Sk);
  }
  cp_async_commit();
  const TileLoader<HD, kB, kBwdThreads> qo_load(b, Sq, H, g * group);
  auto issue = [&](int t) {
    const int gi = t / nqt, qt = qt_first + t % nqt;
    const uint32_t st = ring + (t % kStages) * kStage;
    qo_load.load(st, q, qt, Sq, (int64_t)gi * HD);
    qo_load.load(st + kTile, dout, qt, Sq, (int64_t)gi * HD);
    // lse (threads 0..63) and D (64..127) of the tile's rows; 0 past Sq
    const int r = threadIdx.x % kB, row = qt * kB + r;
    const float* src = threadIdx.x < kB ? lse : dvec;
    const bool in = row < Sq;
    cp_async4(st + 2 * kTile + (threadIdx.x / kB) * kB * 4 + r * 4,
              in ? src + ((int64_t)b * H + g * group + gi) * Sq + row : src,
              in ? 4 : 0);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < T) issue(t);
    cp_async_commit();
  }

  // this lane's keys: valid ones keep their rows
  bool keep[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = kw0 + gid + 8 * hr;
    keep[hr] = key < Sk && (valid == nullptr ||
                            valid[(int64_t)b * Sk + key]);
  }

  ARows<HD, HD == 64> ka(k_s, warp * 16, lane), va(v_s, warp * 16, lane);
  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  for (int t = 0; t < T; ++t) {
    if (t + kStages - 1 < T) issue(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();     // K, V and stage t landed here
    __syncthreads();                  // ... and for every thread
    if (t == 0) {
      ka.hold();
      va.hold();
    }
    const int q0 = (qt_first + t % nqt) * kB;
    const int soff = 2 * kTile + (t % kStages) * kStage;
    const uint32_t qs = k_s + soff, dos = qs + kTile;
    const float* ls = reinterpret_cast<const float*>(smem_raw + soff +
                                                     2 * kTile);
    const float* ds = ls + kB;

    // transposed scores: rows are this warp's keys, columns q rows
    float s[8][4];
    score_tile<HD>(s, ka, qs, lane);             // S^T = K Q^T
    if (causal && q0 < kw0 + 15) {               // some q row before a key
      const int diag = q0 + 2 * tig - kw0 - gid;    // q - key at (0, 0)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (diag + n * 8 + (e & 1) - 8 * (e >> 1) < 0) s[n][e] = -INFINITY;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 L = *reinterpret_cast<const float2*>(ls + n * 8 + 2 * tig);
      const float nl[2] = {neg_lse2(L.x), neg_lse2(L.y)};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = ex2(fmaf(s[n][e], scale_log2, nl[e & 1]));
    }
    acc_tile<HD>(dv_acc, s, dos, lane);          // dV += P^T dO
    float dp[8][4];
    score_tile<HD>(dp, va, dos, lane);           // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 D = *reinterpret_cast<const float2*>(ds + n * 8 + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e)                // dS / scale
        dp[n][e] = s[n][e] * (dp[n][e] - ((e & 1) ? D.y : D.x));
    }
    acc_tile<HD>(dk_acc, dp, qs, lane);          // dK += dS^T Q
    __syncthreads();                  // stage t is free for t + kStages
  }
  cp_async_wait<0>();
  __syncthreads();                    // K and V tiles are free for output

  const int64_t off = (((int64_t)b * Sk + kw0) * HK + g) * HD;
  store_rows<HD>(dk + off, (int64_t)HK * HD, Sk - kw0, smem_raw, warp * 16,
                 dk_acc, scale, keep, lane);
  store_rows<HD>(dv + off, (int64_t)HK * HD, Sk - kw0, smem_raw + kTile,
                 warp * 16, dv_acc, 1.f, keep, lane);
}

// ------------------------------------------------------------- launchers

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int HD>
size_t smem_bytes(int which) {
  if (std::is_same<T, bf16>::value) {
    constexpr size_t kTile = sizeof(bf16) * kB * HD;
    switch (which) {
      case kFwd:                          // Q tile, K/V ring, valid bytes
        return sizeof(bf16) * HD * (kFwdRows + kStages * 2 * kB) +
               kStages * kB;
      case kDq:                           // Q, dO, K/V ring, D, valid bytes
        return (2 + 2 * kStages) * kTile + sizeof(float) * kB + kStages * kB;
      default:                            // K, V, ring of (Q, dO, lse, D)
        return 2 * kTile + kStages * (2 * kTile + 2 * sizeof(float) * kB);
    }
  }
  using Tl = Tile<HD>;
  switch (which) {
    case kFwd: return sizeof(float) * (3 * Tl::kFloats + Tl::kScore + kB);
    case kDq: return sizeof(float) * (4 * Tl::kFloats + Tl::kScore + 3 * kB);
    default: return sizeof(float) * (4 * Tl::kFloats + 2 * Tl::kScore + 3 * kB);
  }
}

// raise a kernel's dynamic shared memory cap once, to what it needs
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& cap) {
  if (bytes <= cap) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) cap = bytes;
  return err;
}

// `out` is the forward's output, and dQ's input O (NULL: D is given);
// `dvec` is D, which dQ writes when it is given O and dK/dV reads
struct Args {
  const void *q, *k, *v, *valid, *dout, *lse_in;
  void *out, *lse_out, *dvec, *dq, *dk, *dv;
  int B, Sq, Sk, H, HK;
  float scale;
  int causal;
};

// The kernels of one (type, head dim): the tensor-core ones for bf16, the
// CUDA-core ones for f32.
template <typename T, int HD>
struct Kernels {
  static constexpr bool kMma = std::is_same<T, bf16>::value;
  static constexpr int kBlock = kMma ? kBwdThreads : kThreads;
  static auto fwd() {
    if constexpr (kMma) return flash_fwd_bf16_kernel<HD>;
    else return flash_fwd_kernel<HD>;
  }
  static auto dq() {
    if constexpr (kMma) return flash_dq_mma_kernel<HD>;
    else return flash_dq_kernel<HD>;
  }
  static auto dkv() {
    if constexpr (kMma) return flash_dkv_mma_kernel<HD>;
    else return flash_dkv_kernel<HD>;
  }
};

template <typename T, int HD>
int launch(int which, const Args& a, cudaStream_t st) {
  using Kn = Kernels<T, HD>;
  const size_t smem = smem_bytes<T, HD>(which);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const uint8_t* valid = static_cast<const uint8_t*>(a.valid);
  cudaError_t err;
  if (which == kFwd) {
    static size_t cap = 48 * 1024;
    auto kern = Kn::fwd();
    if ((err = allow_smem(kern, smem, cap)) != cudaSuccess) return (int)err;
    if constexpr (Kn::kMma) {
      // q tiles slowest, so a causal grid's heavy tiles all go first
      const dim3 grid(a.H, a.B, (a.Sq + kFwdRows - 1) / kFwdRows);
      kern<<<grid, kFwdThreads, smem, st>>>(
          q, k, v, valid, static_cast<T*>(a.out),
          static_cast<float*>(a.lse_out), a.Sq, a.Sk, a.H, a.HK,
          a.scale * kLog2e, a.causal);
    } else {
      const dim3 grid((a.Sq + kB - 1) / kB, a.H, a.B);
      kern<<<grid, Kn::kBlock, smem, st>>>(
          q, k, v, valid, static_cast<T*>(a.out),
          static_cast<float*>(a.lse_out), a.Sq, a.Sk, a.H, a.HK, a.scale,
          a.causal);
    }
  } else if (which == kDq) {
    static size_t cap = 48 * 1024;
    auto kern = Kn::dq();
    if ((err = allow_smem(kern, smem, cap)) != cudaSuccess) return (int)err;
    const T* dout = static_cast<const T*>(a.dout);
    const T* out = static_cast<const T*>(a.out);
    const float* lse = static_cast<const float*>(a.lse_in);
    float* dvec = static_cast<float*>(a.dvec);
    T* dq = static_cast<T*>(a.dq);
    if constexpr (Kn::kMma) {
      // q tiles slowest, so a causal grid's heavy tiles all go first
      const dim3 grid(a.H, a.B, (a.Sq + kB - 1) / kB);
      kern<<<grid, Kn::kBlock, smem, st>>>(
          q, k, v, valid, dout, out, lse, dvec, dq, a.Sq, a.Sk, a.H, a.HK,
          a.scale, a.scale * kLog2e, a.causal);
    } else {
      const dim3 grid((a.Sq + kB - 1) / kB, a.H, a.B);
      kern<<<grid, Kn::kBlock, smem, st>>>(
          q, k, v, valid, dout, out, lse, dvec, dq, a.Sq, a.Sk, a.H, a.HK,
          a.scale, a.causal);
    }
  } else {
    static size_t cap = 48 * 1024;
    auto kern = Kn::dkv();
    if ((err = allow_smem(kern, smem, cap)) != cudaSuccess) return (int)err;
    const T* dout = static_cast<const T*>(a.dout);
    const float* lse = static_cast<const float*>(a.lse_in);
    const float* dvec = static_cast<const float*>(a.dvec);
    T* dk = static_cast<T*>(a.dk);
    T* dv = static_cast<T*>(a.dv);
    if constexpr (Kn::kMma) {
      // k tiles slowest: a causal grid's k tile 0 (the heaviest) first
      const dim3 grid(a.HK, a.B, (a.Sk + kB - 1) / kB);
      kern<<<grid, Kn::kBlock, smem, st>>>(
          q, k, v, valid, dout, lse, dvec, dk, dv, a.Sq, a.Sk, a.H, a.HK,
          a.scale, a.scale * kLog2e, a.causal);
    } else {
      const dim3 grid((a.Sk + kB - 1) / kB, a.HK, a.B);
      kern<<<grid, Kn::kBlock, smem, st>>>(
          q, k, v, valid, dout, lse, dvec, dk, dv, a.Sq, a.Sk, a.H, a.HK,
          a.scale, a.causal);
    }
  }
  return (int)cudaGetLastError();
}

int dispatch(int which, int is_bf16, int hd, const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(which, a, st)
                   : launch<float, 64>(which, a, st);
  if (hd == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128>(which, a, st)
                   : launch<float, 128>(which, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head dim other than 64 or 128.

int flash_forward(const void* q, const void* k, const void* v,
                  const void* valid, void* out, void* lse, int is_bf16, int B,
                  int Sq, int Sk, int H, int HK, int hd, float scale,
                  int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.valid = valid; a.out = out; a.lse_out = lse;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.HK = HK; a.scale = scale;
  a.causal = causal;
  return dispatch(kFwd, is_bf16, hd, a, stream);
}

// With `out` (O) the kernel computes D = rowsum(dO * O) and writes it to
// `dvec`; with out NULL it reads D from `dvec`.
int flash_backward_dq(const void* q, const void* k, const void* v,
                      const void* valid, const void* dout, const void* out,
                      const void* lse, void* dvec, void* dq, int is_bf16,
                      int B, int Sq, int Sk, int H, int HK, int hd,
                      float scale, int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.valid = valid; a.dout = dout;
  a.out = const_cast<void*>(out); a.lse_in = lse; a.dvec = dvec; a.dq = dq;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.HK = HK; a.scale = scale;
  a.causal = causal;
  return dispatch(kDq, is_bf16, hd, a, stream);
}

int flash_backward_dkv(const void* q, const void* k, const void* v,
                       const void* valid, const void* dout, const void* lse,
                       const void* dvec, void* dk, void* dv, int is_bf16,
                       int B, int Sq, int Sk, int H, int HK, int hd,
                       float scale, int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.valid = valid; a.dout = dout; a.lse_in = lse;
  a.dvec = const_cast<void*>(dvec); a.dk = dk; a.dv = dv;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.HK = HK; a.scale = scale;
  a.causal = causal;
  return dispatch(kDkv, is_bf16, hd, a, stream);
}

// Dynamic shared memory of a block of the forward (which 0), dQ (1) or
// dK/dV (2) kernel, in bytes; -1 for a head dim other than 64 or 128.
int flash_smem_bytes(int which, int is_bf16, int hd) {
  if (hd == 64)
    return (int)(is_bf16 ? smem_bytes<bf16, 64>(which)
                         : smem_bytes<float, 64>(which));
  if (hd == 128)
    return (int)(is_bf16 ? smem_bytes<bf16, 128>(which)
                         : smem_bytes<float, 128>(which));
  return -1;
}

}  // extern "C"
