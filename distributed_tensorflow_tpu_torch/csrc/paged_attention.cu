// Paged attention straight off the KV page pool, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of distributed_tensorflow_tpu/ops/pallas/
// paged_attention.py (`_paged_attention`, body `_make_paged_kernel`),
// both entries: decode (s=1 per slot row, per-column valid plane) and the
// prefill window (one row, `sq` queries, causal `col <= pos + j` computed
// here, never materialised).
//
// Layouts (the JAX package's, unchanged):
//   q         [B, sq, h, hd]            bf16 or f32, hd 64 or 128
//   k/v pool  [L, NP, pg, kvh, hd]      q's type, or int8 (the int8 branch)
//   k/v scale [L, NP, pg, kvh, 1] f32   int8 branch only; NULL otherwise
//   page_tab  [B, P] int32              row b's logical page j -> pool page
//   valid     [B, P * pg] uint8 (bool)  decode only; NULL for the window
//   out       [B, sq, h, hd]            q's type
//
// Design.  The TPU walks the (B, P) grid in order and carries the online
// softmax state in VMEM scratch from one grid step to the next.  Here a
// thread block owns one (row, kv head) pair and up to kQB of its query
// vectors (the `group` query heads of that kv head times the `sq` window
// rows; a decode block has one).  The row's logical columns are cut into
// sub-tiles of 32, one column per lane, and the block's 4 warps take the
// sub-tiles in turn, each warp walking its share of the row's page table
// inside the kernel (the int32 table is read from device memory: there
// is no scalar prefetch).  A warp copies its next sub-tile's K and V
// columns into shared memory with cp.async while it computes on the
// current one (two stages), and keeps its own online-softmax state (max,
// sum, accumulator) in f32 registers.  The four warps' states are merged
// at the end, the step the TPU's sequential grid never needed.
//
// The guards of the Pallas body are kept exactly: -inf init with the
// isfinite shift (here also in the merge), `l == 0 -> 1` at finalize, and
// the additive FINITE -1e9 for invalid and causally masked columns, so a
// masked column's exp underflows to exactly 0.0 next to any unmasked
// column.  That exactness is what lets a sub-tile whose columns are all
// masked be skipped without changing the result, as long as the row has
// at least one unmasked column.  A decode row with none attends every
// column uniformly, as the reference softmax does, and walks every
// sub-tile.
//
// Page size: any page_size >= 1 works.  The kernel gathers per column,
// so there is no tiling rule like Mosaic's multiple-of-8 sublane rule.
//
// What bounds it on the H100: bytes.  Per (row, kv head) it reads each
// needed K/V column once (hd * 2 bytes per column per leaf in bf16) and
// does 4 * hd flops per query per column, far below the 295 flops per
// byte where the tensor cores would bind.  The design reads only
// sub-tiles that hold an unmasked column, overlaps each warp's next loads
// with its current arithmetic, and keeps every intermediate on chip.
// Still to do: at decode batch 8 there are only 96 blocks for 132 SMs
// (split-K across blocks would fill them), and the arithmetic runs on the
// CUDA cores, not wgmma.
//
// The int8 branch replaces the Pallas body's `quantized` path
// (paged_attention.py:92-118): K/V are int8 with one f32 scale per
// (token, kv head) in the pool's k_scale/v_scale planes, dequantized at
// the operand in f32.  It is a third element type of the same design: a
// column of one leaf is hd bytes (eight 16-byte cp.async copies at hd
// 128) and its scale one f32, copied with a 4-byte cp.async.ca into the
// same stage.  The scales are folded rather than multiplied into each
// element: the k scale into the logit, `s = (q . k_int8) * k_scale *
// scale`, and the v scale into the softmax weight that multiplies V,
// `acc += (p * v_scale) * v_int8`, while the softmax sum l takes p alone.
// That equals the Pallas `q . (k * k_scale)` and `p . (v * v_scale)` up
// to f32 rounding order.  Cells never written have scale 0 and
// dequantize to 0; they are masked anyway.  What bounds the branch is
// bytes too: (hd + 4) bytes per column per leaf against 2 * hd in bf16,
// so its bound is about 0.52x the bf16 branch's at hd 128.  Measured on
// an H100 80GB HBM3 (700 W) at Llama-3-8B's decode shape (8 rows of up
// to 8192 columns, 32 query / 8 kv heads): 0.51 ms against a 0.014 ms
// byte bound, and no faster than the bf16 branch: a long row's block
// walks 256 sub-tiles with one warp per scheduler, each sub-tile a chain
// of dependent shared loads, shuffles and FMAs, so latency binds first.
// Split-K across blocks is the next step for both branches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQB = 8;                 // query vectors per block
constexpr float kNegInf = -1e9f;       // ops.attention.NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes of T -> 16 / sizeof(T) floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float* f, int8_t) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// KT: the pool's element type, T (q's type) or int8_t
template <typename KT, int HD>
struct Shape {
  static constexpr bool kQuant = sizeof(KT) == 1;
  static constexpr int kVec = 16 / sizeof(KT);    // elements per 16 bytes
  static constexpr int kChunks = HD / kVec;       // 16-byte chunks per column
  static constexpr int kRow = HD * sizeof(KT) + 16;  // padded smem row bytes
  static constexpr int kDpl = HD / 32;            // dims per lane in P @ V
  // K and V rows of 32 columns, then (int8) their 32 + 32 f32 scales
  static constexpr size_t kKV = 2ull * 32 * kRow;
  static constexpr size_t kStage = kKV + (kQuant ? 2 * 32 * sizeof(float) : 0);
  static size_t smem(int n_sub) {
    return sizeof(float) * (kQB * HD                  // q
                            + kWarps * kQB * 32       // p of each warp
                            + kWarps * kQB * (HD + 2))  // merge: acc, m, l
           + kWarps * 2 * kStage                      // 2 stages per warp
           + sizeof(int) * (n_sub + 1);               // active sub-tiles
  }
};

template <typename T, typename KT, int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ page_tab,
    const uint8_t* __restrict__ valid, T* __restrict__ out, int sq, int h,
    int kvh, int num_pages, int page_size, int pages_per_row, int layer,
    int pos, float scale) {
  using S = Shape<KT, HD>;
  const int b = blockIdx.x / kvh;
  const int g = blockIdx.x % kvh;
  const int group = h / kvh;
  const int qbase = blockIdx.y * kQB;
  const int nq = min(kQB, sq * group - qbase);   // this block's queries
  const int view_len = pages_per_row * page_size;
  const int n_sub = (view_len + 31) / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);          // [kQB][HD]
  float* p_s = q_s + kQB * HD;                           // [warp][kQB][32]
  float* acc_s = p_s + kWarps * kQB * 32;                // [warp][kQB][HD]
  float* m_s = acc_s + kWarps * kQB * HD;                 // [warp][kQB]
  float* l_s = m_s + kWarps * kQB;                       // [warp][kQB]
  unsigned char* stages = reinterpret_cast<unsigned char*>(l_s + kWarps * kQB);
  int* act = reinterpret_cast<int*>(stages + kWarps * 2 * S::kStage);

  // query qi of this block is query qbase + qi of the pair:
  // window row j = (qbase + qi) / group, q head g * group + (.. % group)
  for (int idx = tid; idx < kQB * HD; idx += kThreads) {
    const int qi = idx / HD, d = idx % HD;
    float v = 0.f;
    if (qi < nq) {
      const int qq = qbase + qi, j = qq / group, gi = qq % group;
      v = to_float(q[(((int64_t)b * sq + j) * h + g * group + gi) * HD + d]);
    }
    q_s[idx] = v;
  }

  // active sub-tiles, in column order
  int n_act;
  if (kWindow) {
    // the block's last query row attends up to pos + j_max; every row
    // attends column 0
    const int j_max = (qbase + nq - 1) / group;
    n_act = min(n_sub, (pos + j_max) / 32 + 1);
    for (int t = tid; t < n_act; t += kThreads) act[t] = t;
  } else {
    const uint8_t* vrow = valid + (int64_t)b * view_len;
    for (int t = tid; t < n_sub; t += kThreads) {
      int any = 0;
      for (int c = t * 32; c < min(view_len, t * 32 + 32); ++c) any |= vrow[c];
      act[t] = any;
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int t = 0; t < n_sub; ++t)
        if (act[t]) act[n++] = t;
      if (n == 0) {              // no valid column: attend every column
        for (int t = 0; t < n_sub; ++t) act[t] = t;
        n = n_sub;
      }
      act[n_sub] = n;
    }
    __syncthreads();
    n_act = act[n_sub];
  }
  __syncthreads();

  const int64_t layer_pages = (int64_t)layer * num_pages;
  unsigned char* my_stages = stages + warp * 2 * S::kStage;

  // lane `lane` copies column 32 * t + lane of sub-tile t into stage st
  auto issue = [&](int t, int st) {
    unsigned char* stage = my_stages + st * S::kStage;
    unsigned char* ks = stage + lane * S::kRow;
    unsigned char* vs = ks + 32 * S::kRow;
    float* kscl = reinterpret_cast<float*>(stage + S::kKV);
    const int col = t * 32 + lane;
    if (col < view_len) {
      const int page = page_tab[(int64_t)b * pages_per_row + col / page_size];
      const int64_t cell = ((layer_pages + page) * page_size + col % page_size)
                           * kvh + g;
      const int64_t e = cell * HD;
#pragma unroll
      for (int k = 0; k < S::kChunks; ++k) {
        cp_async16(ks + 16 * k, k_pool + e + k * S::kVec);
        cp_async16(vs + 16 * k, v_pool + e + k * S::kVec);
      }
      if constexpr (S::kQuant) {
        cp_async4(kscl + lane, k_scale + cell);
        cp_async4(kscl + 32 + lane, v_scale + cell);
      }
    } else {
#pragma unroll
      for (int k = 0; k < S::kChunks; ++k) {
        *reinterpret_cast<uint4*>(ks + 16 * k) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vs + 16 * k) = make_uint4(0, 0, 0, 0);
      }
      if constexpr (S::kQuant) {
        kscl[lane] = 0.f;
        kscl[32 + lane] = 0.f;
      }
    }
  };

  float m[kQB], l[kQB], acc[kQB][S::kDpl];
#pragma unroll
  for (int qi = 0; qi < kQB; ++qi) {
    m[qi] = -INFINITY;
    l[qi] = 0.f;
#pragma unroll
    for (int e = 0; e < S::kDpl; ++e) acc[qi][e] = 0.f;
  }
  float* my_p = p_s + warp * kQB * 32;

  int st = 0;
  if (warp < n_act) issue(act[warp], 0);
  cp_async_commit();
  for (int i = warp; i < n_act; i += kWarps, st ^= 1) {
    if (i + kWarps < n_act) issue(act[i + kWarps], st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();          // this stage has landed (for this lane)
    __syncwarp();                // ... and for every lane of the warp

    const int col = act[i] * 32 + lane;
    const bool exists = col < view_len;
    float valid_add = 0.f;
    if (!kWindow)
      valid_add = (exists && valid[(int64_t)b * view_len + col]) ? 0.f
                                                                 : kNegInf;
    const unsigned char* ks = my_stages + st * S::kStage;
    const unsigned char* vs = ks + 32 * S::kRow;
    uint4 kr[S::kChunks];
#pragma unroll
    for (int k = 0; k < S::kChunks; ++k)
      kr[k] = *reinterpret_cast<const uint4*>(ks + lane * S::kRow + 16 * k);
    // int8: this lane's column's scales (0 for a column past the view)
    float k_sc = 1.f, v_sc = 1.f;
    if constexpr (S::kQuant) {
      const float* scl = reinterpret_cast<const float*>(ks + S::kKV);
      k_sc = scl[lane];
      v_sc = scl[32 + lane];
    }

#pragma unroll
    for (int qi = 0; qi < kQB; ++qi) {
      if (qi >= nq) break;                       // block-uniform
      const float* qrow = q_s + qi * HD;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < S::kChunks; ++k) {
        float kf[S::kVec];
        unpack(kr[k], kf, KT());
#pragma unroll
        for (int v = 0; v < S::kVec; ++v)
          s = fmaf(qrow[k * S::kVec + v], kf[v], s);
      }
      if constexpr (S::kQuant) s = s * k_sc;
      s = s * scale;
      s = s + valid_add;
      if (kWindow) {
        const int j = (qbase + qi) / group;
        s = s + (col <= pos + j ? 0.f : kNegInf);
      }
      if (!exists) s = -INFINITY;
      const float m_new = fmaxf(m[qi], warp_max(s));
      const float shift = isfinite(m_new) ? m_new : 0.f;
      const float p = exists ? expf(s - shift) : 0.f;
      const float alpha = isfinite(m[qi]) ? expf(m[qi] - shift) : 0.f;
      l[qi] = alpha * l[qi] + warp_sum(p);
      m[qi] = m_new;
#pragma unroll
      for (int e = 0; e < S::kDpl; ++e) acc[qi][e] *= alpha;
      my_p[qi * 32 + lane] = S::kQuant ? p * v_sc : p;
    }
    __syncwarp();
    for (int c = 0; c < 32; ++c) {
      const KT* vrow = reinterpret_cast<const KT*>(vs + c * S::kRow);
      float vv[S::kDpl];
#pragma unroll
      for (int e = 0; e < S::kDpl; ++e)
        vv[e] = to_float(vrow[lane * S::kDpl + e]);
#pragma unroll
      for (int qi = 0; qi < kQB; ++qi) {
        if (qi >= nq) break;
        const float pc = my_p[qi * 32 + c];
#pragma unroll
        for (int e = 0; e < S::kDpl; ++e) acc[qi][e] = fmaf(pc, vv[e], acc[qi][e]);
      }
    }
    __syncwarp();                // stage and p are rewritten next
  }
  cp_async_wait<0>();

  // merge the warps' states
#pragma unroll
  for (int qi = 0; qi < kQB; ++qi) {
#pragma unroll
    for (int e = 0; e < S::kDpl; ++e)
      acc_s[(warp * kQB + qi) * HD + lane * S::kDpl + e] = acc[qi][e];
    if (lane == 0) {
      m_s[warp * kQB + qi] = m[qi];
      l_s[warp * kQB + qi] = l[qi];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nq * HD; idx += kThreads) {
    const int qi = idx / HD, d = idx % HD;
    float m_tot = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_tot = fmaxf(m_tot, m_s[w * kQB + qi]);
    const float shift = isfinite(m_tot) ? m_tot : 0.f;
    float l_tot = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = m_s[w * kQB + qi];
      const float f = isfinite(mw) ? expf(mw - shift) : 0.f;
      l_tot += f * l_s[w * kQB + qi];
      a += f * acc_s[(w * kQB + qi) * HD + d];
    }
    const int qq = qbase + qi, j = qq / group, gi = qq % group;
    out[(((int64_t)b * sq + j) * h + g * group + gi) * HD + d] =
        from_float<T>(a / (l_tot == 0.f ? 1.f : l_tot));
  }
}

template <typename KT, int HD>
size_t smem_bytes(int view_len) { return Shape<KT, HD>::smem((view_len + 31) / 32); }

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *page_tab, *valid;
  void* out;
  int B, sq, h, kvh, num_pages, page_size, pages_per_row, layer, pos;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KT, int HD, bool kWindow>
int launch(const Args& a) {
  const size_t smem = smem_bytes<KT, HD>(a.pages_per_row * a.page_size);
  auto kernel = paged_attention_kernel<T, KT, HD, kWindow>;
  // raise the dynamic shared memory cap once per instantiation to what
  // the largest launch so far needs
  static size_t cap = 48 * 1024;
  if (smem > cap) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cap = smem;
  }
  const int nq = a.sq * (a.h / a.kvh);
  const dim3 grid(a.B * a.kvh, (nq + kQB - 1) / kQB);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.k_pool),
      static_cast<const KT*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int32_t*>(a.page_tab),
      static_cast<const uint8_t*>(a.valid), static_cast<T*>(a.out), a.sq, a.h,
      a.kvh, a.num_pages, a.page_size, a.pages_per_row, a.layer, a.pos,
      a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KT, int HD>
int dispatch(int window, const Args& a) {
  return window ? launch<T, KT, HD, true>(a) : launch<T, KT, HD, false>(a);
}

template <typename T, int HD>
int dispatch_kv(int kv_int8, int window, const Args& a) {
  return kv_int8 ? dispatch<T, int8_t, HD>(window, a)
                 : dispatch<T, T, HD>(window, a);
}

template <int HD>
size_t smem_for(int is_bf16, int kv_int8, int view_len) {
  if (kv_int8) return smem_bytes<int8_t, HD>(view_len);
  return is_bf16 ? smem_bytes<__nv_bfloat16, HD>(view_len)
                 : smem_bytes<float, HD>(view_len);
}

}  // namespace

extern "C" {

// Shared memory one block needs (bytes), 0 for an unsupported head_dim;
// the wrapper refuses shapes over the 227 KB a block may use.
size_t paged_attention_smem_bytes(int is_bf16, int kv_int8, int hd,
                                  int view_len) {
  if (hd == 64) return smem_for<64>(is_bf16, kv_int8, view_len);
  if (hd == 128) return smem_for<128>(is_bf16, kv_int8, view_len);
  return 0;
}

// kv_int8 = 1: k_pool/v_pool are int8 and k_scale/v_scale the f32 scale
// planes; else the pool is in q's type and the scale pointers are NULL.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an unsupported head_dim.
int paged_attention_forward(const void* q, const void* k_pool,
                            const void* v_pool, const void* k_scale,
                            const void* v_scale, const void* page_tab,
                            const void* valid, void* out, int is_bf16,
                            int kv_int8, int window, int B, int sq, int h,
                            int kvh, int hd, int num_pages, int page_size,
                            int pages_per_row, int layer, int pos,
                            float scale, void* stream) {
  const Args a{q, k_pool, v_pool, k_scale, v_scale, page_tab, valid, out,
               B, sq, h, kvh, num_pages, page_size, pages_per_row, layer, pos,
               scale, static_cast<cudaStream_t>(stream)};
  if (hd == 64)
    return is_bf16 ? dispatch_kv<__nv_bfloat16, 64>(kv_int8, window, a)
                   : dispatch_kv<float, 64>(kv_int8, window, a);
  if (hd == 128)
    return is_bf16 ? dispatch_kv<__nv_bfloat16, 128>(kv_int8, window, a)
                   : dispatch_kv<float, 128>(kv_int8, window, a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
