// RMSNorm over the last axis, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of distributed_tensorflow_tpu/ops/pallas/
// fused.py (`_rmsnorm_forward`, body `_rmsnorm_kernel`), the Llama block
// norm: `x * rsqrt(mean(x^2) + eps) * gamma` with f32 statistics and no
// centering, output in the input's type.
//
//   x      [rows, d]  bf16 or f32
//   gamma  [d] f32
//   out    [rows, d]  x's type
//
// What bounds it on the H100: bytes, and at the decode tick's rows the
// launch.  It reads x once and writes the output once, about 4 flops an
// element.  At the Llama prefill's [2048, 4096] bf16 that is 33.5 MB, a
// bound of 10 us at 3.35 TB/s; at the decode tick's [8, 4096] it is
// 131 KB, and what a launch costs is the kernel's latency: the dependent
// steps (loads, reductions, barriers) between its start and its last
// store.
//
// Design, the register path:
//   - the row is read once, into registers, with 16-byte loads: thread t
//     holds vectors t, t + blockDim, ..., NV of them (NV <= 4), and the
//     scaled row is computed from the registers and stored with 16-byte
//     stores;
//   - gamma is loaded once per block, with 16-byte loads, into registers
//     for the same columns, and kept there for every row the block does;
//   - the sum of squares is reduced by warp shuffles and one exchange of
//     the per-warp partials in shared memory: one barrier a row (two
//     buffers of partials, alternating by row);
//   - few rows (rows <= the SM count: the decode tick's 8, the window's
//     32): one row a block, spread over up to 512 threads (one 16-byte
//     vector each for bf16 d = 4096), so each row's chain is short;
//   - many rows (the prefill's 2048): narrow blocks (NV = 4 and 128
//     threads for bf16 d = 4096, 256 for f32), as many as fit the card
//     at once, each walking rows with a stride of the grid and issuing
//     the next row's loads before this row's reduction and stores.  The
//     host sizes the grid from the SM count (given once per device by
//     the caller) and the kernel's occupancy (asked once per block size
//     and cached), and evens the rows out over it: shapes alone decide,
//     so a launch can be captured in a CUDA graph.
// The register path takes rows of up to 1024 vectors (16 KB: d up to
// 8192 in bf16, 4096 in f32, which takes it with NV = 2 on few rows and
// NV = 4 on many) with x, out and gamma 16-byte aligned.  Any other d or
// address takes the looped path: one 256-thread block a row, two passes
// over x (the second from L1/L2), 16-byte loads where the alignment
// allows them.
//
// Both paths compute `(x * inv) * gamma` with inv = rsqrtf(sum / d + eps),
// each product rounded on its own as the plain version's torch ops round
// it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::warp_sum;

constexpr int kMaxThreads = 512;    // a block of the register path
constexpr int kMaxVecs = 1024;      // 16-byte vectors a row may have there
constexpr int kManyThreads = 128;   // many rows: threads a row (at NV 4)
constexpr int kLoopThreads = 256;   // a block of the looped path

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

// 16 bytes of a row as kN floats, and back
template <typename T> struct Vec;

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// this thread's NV vectors of a row (zeros past the row's end)
template <int NV>
__device__ __forceinline__ void load_row(uint4 (&r)[NV], const uint4* xr,
                                         int nvec) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = i * blockDim.x + threadIdx.x;
    r[i] = v < nvec ? xr[v] : make_uint4(0, 0, 0, 0);
  }
}

// The register path: block b does rows b, b + gridDim, ...
template <typename T, int NV>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_vec_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    T* __restrict__ out, int rows, int d, float eps) {
  using V = Vec<T>;
  __shared__ float red[2][kMaxThreads / 32];
  const int nvec = d / V::kN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  float g[NV][V::kN];
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = i * blockDim.x + threadIdx.x;
#pragma unroll
    for (int j = 0; j < V::kN / 4; ++j) {
      const float4 q = v < nvec ? g4[v * (V::kN / 4) + j]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      g[i][4 * j] = q.x;
      g[i][4 * j + 1] = q.y;
      g[i][4 * j + 2] = q.z;
      g[i][4 * j + 3] = q.w;
    }
  }

  int row = blockIdx.x;
  uint4 cur[NV], nxt[NV];
  load_row(cur, reinterpret_cast<const uint4*>(x + (int64_t)row * d), nvec);
  for (int buf = 0; row < rows; row += gridDim.x, buf ^= 1) {
    const int next = row + gridDim.x;
    if (next < rows)
      load_row(nxt, reinterpret_cast<const uint4*>(x + (int64_t)next * d),
               nvec);

    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float f[V::kN];
      V::unpack(cur[i], f);
#pragma unroll
      for (int e = 0; e < V::kN; ++e) ss = fmaf(f[e], f[e], ss);
    }
    ss = warp_sum(ss);
    if (warps > 1) {
      // a row's partials go to red[buf]; the row after next writes it
      // again only after every thread has passed the next row's barrier,
      // so after this row's reads
      if (lane == 0) red[buf][warp] = ss;
      __syncthreads();
      ss = warp_sum(lane < warps ? red[buf][lane] : 0.f);
    }
    const float inv = rsqrtf(ss / d + eps);

    uint4* orow = reinterpret_cast<uint4*>(out + (int64_t)row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = i * blockDim.x + threadIdx.x;
      if (v < nvec) {
        float f[V::kN];
        V::unpack(cur[i], f);
#pragma unroll
        for (int e = 0; e < V::kN; ++e)
          f[e] = __fmul_rn(__fmul_rn(f[e], inv), g[i][e]);
        orow[v] = V::pack(f);
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
  }
}

// Sum over a block of kLoopThreads; every thread gets the total.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < kLoopThreads / 32 ? red[lane] : 0.f);
}

// The looped path: one block a row, any d and any alignment (`vec`: x
// and out 16-byte aligned and d * sizeof(T) a multiple of 16).
template <typename T>
__global__ void __launch_bounds__(kLoopThreads) rmsnorm_loop_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    T* __restrict__ out, int d, float eps, int vec) {
  using V = Vec<T>;
  __shared__ float red[kLoopThreads / 32];
  const T* xr = x + (int64_t)blockIdx.x * d;
  T* orow = out + (int64_t)blockIdx.x * d;

  float ss = 0.f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / V::kN; i += kLoopThreads) {
      float f[V::kN];
      V::unpack(xv[i], f);
#pragma unroll
      for (int e = 0; e < V::kN; ++e) ss = fmaf(f[e], f[e], ss);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kLoopThreads) {
      const float v = to_float(xr[i]);
      ss = fmaf(v, v, ss);
    }
  }
  const float inv = rsqrtf(block_sum(ss, red) / d + eps);

  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* ov = reinterpret_cast<uint4*>(orow);
    for (int i = threadIdx.x; i < d / V::kN; i += kLoopThreads) {
      float f[V::kN];
      V::unpack(xv[i], f);
#pragma unroll
      for (int e = 0; e < V::kN; ++e)
        f[e] = __fmul_rn(__fmul_rn(f[e], inv), gamma[i * V::kN + e]);
      ov[i] = V::pack(f);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kLoopThreads)
      orow[i] = from_float<T>(
          __fmul_rn(__fmul_rn(to_float(xr[i]), inv), gamma[i]));
  }
}

// Blocks of `threads` that one SM holds at once, asked once per block
// size and kept.
template <typename T, int NV>
int resident(int threads, int* blocks) {
  static int known[kMaxThreads / 32 + 1];
  int& n = known[threads / 32];
  if (n == 0) {
    const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, rmsnorm_vec_kernel<T, NV>, threads, 0);
    if (rc != cudaSuccess) return (int)rc;
  }
  *blocks = n;
  return 0;
}

template <typename T, int NV>
int launch_vec(const T* x, const float* g, T* o, int rows, int d, float eps,
               int nvec, bool few, int sms, cudaStream_t s) {
  const int threads = ((nvec + NV - 1) / NV + 31) / 32 * 32;
  int grid = rows;
  if (!few) {
    int per_sm = 0;
    const int rc = resident<T, NV>(threads, &per_sm);
    if (rc != 0) return rc;
    grid = per_sm * sms < rows ? per_sm * sms : rows;
    if (grid < 1) grid = 1;
    const int per = (rows + grid - 1) / grid;   // rows a block, evened out
    grid = (rows + per - 1) / per;
  }
  rmsnorm_vec_kernel<T, NV><<<grid, threads, 0, s>>>(x, g, o, rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xp, const void* gp, void* op, int rows, int d,
           float eps, int sms, cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const float* g = static_cast<const float*>(gp);
  T* o = static_cast<T*>(op);
  const bool vec = (d * sizeof(T)) % 16 == 0 &&
                   (((uintptr_t)xp | (uintptr_t)op) % 16) == 0;
  const int nvec = (int)(d * sizeof(T) / 16);
  if (!vec || (uintptr_t)gp % 16 != 0 || nvec > kMaxVecs) {
    rmsnorm_loop_kernel<T><<<rows, kLoopThreads, 0, s>>>(x, g, o, d, eps,
                                                         vec);
    return (int)cudaGetLastError();
  }
  // vectors a thread: 1 or 2 on few rows, up to 4 on many
  const bool few = rows <= sms;
  const int spread = few ? kMaxThreads : kManyThreads;
  const int nv = (nvec + spread - 1) / spread;
  if (nv <= 1)
    return launch_vec<T, 1>(x, g, o, rows, d, eps, nvec, few, sms, s);
  if (nv <= 2)
    return launch_vec<T, 2>(x, g, o, rows, d, eps, nvec, few, sms, s);
  return launch_vec<T, 4>(x, g, o, rows, d, eps, nvec, few, sms, s);
}

}  // namespace

extern "C" {

// `sms`: the card's SM count (the caller reads it once per device).
// Returns 0 when launched, else a CUDA error code.
int rmsnorm_forward(const void* x, const void* gamma, void* out, int is_bf16,
                    int rows, int d, float eps, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, gamma, out, rows, d, eps, sms, s)
                 : launch<float>(x, gamma, out, rows, d, eps, sms, s);
}

}  // extern "C"
