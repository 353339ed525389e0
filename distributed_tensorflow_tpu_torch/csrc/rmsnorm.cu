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
// Design: one thread block of 256 threads per row.  The TPU kernel takes
// blocks of rows sized for VMEM; here a row of Llama's d = 4096 is 8 KB in
// bf16, so one block reads it with 16-byte loads (two per thread), sums
// the squares in f32 (warp shuffles, then one warp over the per-warp
// partials), and reads the row again from L1/L2 to scale and write it.
// A row whose length or address does not allow 16-byte access takes the
// element-wise loops instead.
//
// What bounds it on the H100: bytes.  It reads x once from device memory
// and writes the output once, about 4 flops per element.  At the serving
// path's shapes ([8, 4096] and [32, 4096] bf16: 131 KB and 524 KB moved,
// a bound of 0.04 and 0.16 us at 3.35 TB/s) the launch itself dominates,
// as it does for LayerNorm; fusing the norm into the next projection is
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

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

// 16 bytes of T <-> 16 / sizeof(T) floats
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
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// Sum over the block; every thread gets the total.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (kThreads / 32) ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    T* __restrict__ out, int d, float eps, int vec) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float red[kThreads / 32];
  const T* xr = x + (int64_t)blockIdx.x * d;
  T* orow = out + (int64_t)blockIdx.x * d;

  float ss = 0.f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / kVec; i += kThreads) {
      float f[kVec];
      unpack(xv[i], f, T());
#pragma unroll
      for (int e = 0; e < kVec; ++e) ss = fmaf(f[e], f[e], ss);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float v = to_float(xr[i]);
      ss = fmaf(v, v, ss);
    }
  }
  const float inv = 1.f / sqrtf(block_sum(ss, red) / d + eps);

  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* ov = reinterpret_cast<uint4*>(orow);
    for (int i = threadIdx.x; i < d / kVec; i += kThreads) {
      float f[kVec];
      unpack(xv[i], f, T());
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = f[e] * inv * gamma[i * kVec + e];
      ov[i] = pack(f, T());
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      orow[i] = from_float<T>(to_float(xr[i]) * inv * gamma[i]);
  }
}

}  // namespace

extern "C" {

// `vec` = 1 when d * sizeof(T) is a multiple of 16 and x and out are
// 16-byte aligned (the wrapper decides).  Returns cudaGetLastError()
// after the launch (0 = launched).
int rmsnorm_forward(const void* x, const void* gamma, void* out, int is_bf16,
                    int rows, int d, float eps, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(gamma), static_cast<__nv_bfloat16*>(out),
        d, eps, vec);
  } else {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<float*>(out), d, eps, vec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
