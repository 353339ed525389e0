// LayerNorm over the last axis, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of distributed_tensorflow_tpu/ops/pallas/
// fused.py (`_layernorm_forward`, body `_layernorm_kernel`): f32 mean and
// variance of each row, `(x - mean) * rsqrt(var + eps) * gamma + beta`,
// output in the input's type.
//
//   x      [rows, d]  bf16 or f32
//   gamma  [d] f32, beta [d] f32
//   out    [rows, d]  x's type
//
// Design: one thread block per row.  The TPU kernel takes blocks of rows
// sized for VMEM; here a row of GPT-2's d = 768 is 1.5 KB in bf16, so one
// block of 256 threads holds it in L1 across the three passes (sum,
// centred sum of squares, write) and the statistics are block reductions
// (warp shuffles, then one warp over the per-warp partials).
//
// What bounds it on the H100: bytes.  It reads x once from device memory
// and writes the output once (about 8 flops per element, far below the
// compute roofline).  At the serving path's shapes (8 to 256 rows) the
// launch itself dominates; fusing the norm into the neighbouring
// projection is later work.

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

// Sum over the block; every thread gets the total.  `red` holds one
// partial per warp and is reused, so callers separate calls by the
// barrier at the end of this function.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (kThreads / 32) ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) layernorm_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ out, int d, float eps) {
  __shared__ float red[kThreads / 32];
  const T* xr = x + (int64_t)blockIdx.x * d;
  T* orow = out + (int64_t)blockIdx.x * d;

  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) s += to_float(xr[i]);
  const float mean = block_sum(s, red) / d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float c = to_float(xr[i]) - mean;
    ss += c * c;
  }
  const float inv = rsqrtf(block_sum(ss, red) / d + eps);

  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float c = to_float(xr[i]) - mean;
    orow[i] = from_float<T>(c * inv * gamma[i] + beta[i]);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int layernorm_forward(const void* x, const void* gamma, const void* beta,
                      void* out, int is_bf16, int rows, int d, float eps,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    layernorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<__nv_bfloat16*>(out), d, eps);
  } else {
    layernorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(out), d, eps);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
