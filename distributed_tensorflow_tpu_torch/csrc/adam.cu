// One Adam(W) step for one f32 tensor, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of distributed_tensorflow_tpu/ops/pallas/
// fused.py (`fused_adam_update`, body `_adam_kernel`):
//
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g * g
//   u  = -lr_t * (m' / (sqrt(v') + eps_t))  [- lr * wd * p]
//   p' = u if delta else p + u
//
// with the bias correction folded into the scalars lr_t and eps_t on the
// host, as the JAX wrapper folds them outside its kernel.
//
//   p, g, m, v        [n] f32
//   p_out, m_out, v_out [n] f32; each may be the same buffer as its input
//                     (the element is read before it is written, by the
//                     same thread), so an optimizer can update in place
//
// Design.  The TPU kernel walks (rows, 128) blocks of the flattened tensor
// padded to whole blocks.  Here nothing is padded: a grid-stride loop
// takes four elements per thread per iteration as one 16-byte load of
// each stream when the tensor's base and length allow it, and the ragged
// tail (or a misaligned tensor) goes element by element.
//
// What bounds it on the H100: bytes.  Four f32 streams in and three out,
// 28 bytes per element, against about 12 flops: the loop keeps every
// intermediate in registers and touches each stream once.  One launch per
// tensor, as on the TPU; a launch over many tensors is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// c1 = 1 - b1 and c2 = 1 - b2 come rounded from the host's doubles, as
// the JAX kernel's `(1.0 - b1)` does
struct Scalars {
  float b1, c1, b2, c2, lr_t, eps_t, lr, wd;
  int delta;
};

__device__ __forceinline__ void step(float p, float g, float& m, float& v,
                                     float& out, const Scalars& s) {
  m = s.b1 * m + s.c1 * g;
  v = s.b2 * v + s.c2 * g * g;
  float u = -s.lr_t * (m / (sqrtf(v) + s.eps_t));
  if (s.wd != 0.0f) u = u - s.lr * s.wd * p;
  out = s.delta ? u : p + u;
}

// No __restrict__: the outputs may alias the inputs.
__global__ void __launch_bounds__(kThreads) adam_vec4_kernel(
    const float4* p, const float4* g, const float4* m, const float4* v,
    float4* p_out, float4* m_out, float4* v_out, int64_t n4, Scalars s) {
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * kThreads) {
    const float4 pp = p[i], gg = g[i];
    float4 mm = m[i], vv = v[i], oo;
    step(pp.x, gg.x, mm.x, vv.x, oo.x, s);
    step(pp.y, gg.y, mm.y, vv.y, oo.y, s);
    step(pp.z, gg.z, mm.z, vv.z, oo.z, s);
    step(pp.w, gg.w, mm.w, vv.w, oo.w, s);
    p_out[i] = oo;
    m_out[i] = mm;
    v_out[i] = vv;
  }
}

__global__ void __launch_bounds__(kThreads) adam_scalar_kernel(
    const float* p, const float* g, const float* m, const float* v,
    float* p_out, float* m_out, float* v_out, int64_t start, int64_t n,
    Scalars s) {
  for (int64_t i = start + blockIdx.x * (int64_t)kThreads + threadIdx.x;
       i < n; i += (int64_t)gridDim.x * kThreads) {
    float mm = m[i], vv = v[i], oo;
    step(p[i], g[i], mm, vv, oo, s);
    p_out[i] = oo;
    m_out[i] = mm;
    v_out[i] = vv;
  }
}

int grid_for(int64_t items) {
  // enough blocks to fill the card several times over; the loop strides
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0 = launched).
int adam_update(const void* p, const void* g, const void* m, const void* v,
                void* p_out, void* m_out, void* v_out, long long n, float b1,
                float c1, float b2, float c2, float lr_t, float eps_t,
                float lr, float wd, int delta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scalars s{b1, c1, b2, c2, lr_t, eps_t, lr, wd, delta};
  const void* ptrs[7] = {p, g, m, v, p_out, m_out, v_out};
  bool vec = true;
  for (const void* q : ptrs) vec = vec && aligned16(q);
  const int64_t n4 = vec ? n / 4 : 0;
  if (n4 > 0) {
    adam_vec4_kernel<<<grid_for(n4), kThreads, 0, st>>>(
        static_cast<const float4*>(p), static_cast<const float4*>(g),
        static_cast<const float4*>(m), static_cast<const float4*>(v),
        static_cast<float4*>(p_out), static_cast<float4*>(m_out),
        static_cast<float4*>(v_out), n4, s);
  }
  if (4 * n4 < n) {
    adam_scalar_kernel<<<grid_for(n - 4 * n4), kThreads, 0, st>>>(
        static_cast<const float*>(p), static_cast<const float*>(g),
        static_cast<const float*>(m), static_cast<const float*>(v),
        static_cast<float*>(p_out), static_cast<float*>(m_out),
        static_cast<float*>(v_out), 4 * n4, (int64_t)n, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
