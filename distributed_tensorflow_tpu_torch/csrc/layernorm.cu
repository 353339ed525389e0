// LayerNorm over the last axis, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of distributed_tensorflow_tpu/ops/pallas/
// fused.py (`_layernorm_forward`, body `_layernorm_kernel`): f32 mean and
// centred variance of each row, `(x - mean) * rsqrt(var + eps) * gamma +
// beta`, output in the input's type.
//
//   x      [rows, d]  bf16 or f32
//   gamma  [d] f32, beta [d] f32
//   out    [rows, d]  x's type
//
// What bounds it on the H100: bytes, and at the serving path's shapes the
// launch.  It reads x once and writes the output once (about 8 flops per
// element); at GPT-2's d = 768 a row is 1.5 KB in bf16, so the decode
// tick's 8 rows are 12 KB, a few nanoseconds of the card's memory rate.
// What a launch costs is the kernel's latency: how many dependent steps
// (loads, reductions, barriers) stand between its start and its last
// store.
//
// Design, for that latency:
//   - one warp per row, 4 rows per block: the statistics are warp
//     shuffles alone, with no shared memory and no __syncthreads;
//   - the row is read once, into registers, with 16-byte loads (at d = 768
//     in bf16 three uint4 a lane, in f32 six), and both statistics come
//     from the registers: the mean, then the centred sum of squares, the
//     two-pass variance the plain version computes;
//   - gamma and beta by 16-byte loads, the output by 16-byte stores.
// The host picks that path when d, x, out, gamma and beta are 16-byte
// aligned and the row fits the register budget (16 uint4 a lane: d up to
// 4096 in bf16, 2048 in f32).  Any other d or address takes the looped
// path: the same warp per row, scalar loads, three passes over the row
// (the re-reads hit L1).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;               // rows per block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
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

// ((x - mean) * inv) * gamma + beta, each step rounded on its own as the
// plain version's separate torch ops round it (no fused multiply-add)
__device__ __forceinline__ float affine(float x, float mean, float inv,
                                        float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), inv), g), b);
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

// The row in registers: lane `lane` holds 16-byte vectors lane, lane + 32,
// ..., up to NV of them; vectors past the row's end are zero and skipped.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) layernorm_vec_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ out, int rows, int d,
    float eps) {
  using V = Vec<T>;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                 // the whole warp leaves
  const int nvec = d / V::kN;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (int64_t)row * d);

  uint4 r[NV];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = i * 32 + lane;
    r[i] = v < nvec ? xr[v] : make_uint4(0, 0, 0, 0);
    float f[V::kN];
    V::unpack(r[i], f);
#pragma unroll
    for (int j = 0; j < V::kN; ++j) s += f[j];
  }
  const float mean = warp_sum(s) / d;

  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i * 32 + lane < nvec) {
      float f[V::kN];
      V::unpack(r[i], f);
#pragma unroll
      for (int j = 0; j < V::kN; ++j) {
        const float c = f[j] - mean;
        ss += c * c;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(ss) / d + eps);

  uint4* orow = reinterpret_cast<uint4*>(out + (int64_t)row * d);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = i * 32 + lane;
    if (v < nvec) {
      float f[V::kN];
      V::unpack(r[i], f);
#pragma unroll
      for (int j = 0; j < V::kN / 4; ++j) {
        const float4 g = g4[v * (V::kN / 4) + j];
        const float4 b = b4[v * (V::kN / 4) + j];
        float* e = f + 4 * j;
        e[0] = affine(e[0], mean, inv, g.x, b.x);
        e[1] = affine(e[1], mean, inv, g.y, b.y);
        e[2] = affine(e[2], mean, inv, g.z, b.z);
        e[3] = affine(e[3], mean, inv, g.w, b.w);
      }
      orow[v] = V::pack(f);
    }
  }
}

// Any d and any alignment: scalar loads, three passes over the row.
template <typename T>
__global__ void __launch_bounds__(kThreads) layernorm_loop_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ out, int rows, int d,
    float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (int64_t)row * d;
  T* orow = out + (int64_t)row * d;

  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += to_float(xr[i]);
  const float mean = warp_sum(s) / d;

  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float c = to_float(xr[i]) - mean;
    ss += c * c;
  }
  const float inv = rsqrtf(warp_sum(ss) / d + eps);

  for (int i = lane; i < d; i += 32)
    orow[i] = from_float<T>(affine(to_float(xr[i]), mean, inv, gamma[i], beta[i]));
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* out,
           int rows, int d, float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  T* o = static_cast<T*>(out);
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const bool aligned =
      (d * sizeof(T)) % 16 == 0 &&
      (((uintptr_t)x | (uintptr_t)gamma | (uintptr_t)beta | (uintptr_t)out)
       % 16) == 0;
  // 16-byte vectors a lane needs for the whole row
  const int per_lane = (int)((d * sizeof(T) / 16 + 31) / 32);
  if (aligned && per_lane <= 4)
    layernorm_vec_kernel<T, 4><<<grid, kThreads, 0, s>>>(xt, g, b, o, rows, d, eps);
  else if (aligned && per_lane <= 8)
    layernorm_vec_kernel<T, 8><<<grid, kThreads, 0, s>>>(xt, g, b, o, rows, d, eps);
  else if (aligned && per_lane <= 16)
    layernorm_vec_kernel<T, 16><<<grid, kThreads, 0, s>>>(xt, g, b, o, rows, d, eps);
  else
    layernorm_loop_kernel<T><<<grid, kThreads, 0, s>>>(xt, g, b, o, rows, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int layernorm_forward(const void* x, const void* gamma, const void* beta,
                      void* out, int is_bf16, int rows, int d, float eps,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, gamma, beta, out, rows, d, eps, s)
                 : launch<float>(x, gamma, beta, out, rows, d, eps, s);
}

}  // extern "C"
