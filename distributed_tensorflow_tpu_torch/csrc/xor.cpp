// The XOR task's sample generator on the host: x [n, 2*bits] in {0, 1},
// y = x_lo ^ x_hi [n, bits], as f32.
//
// A copy of dt_xor_generate in the JAX package's native/dttpu_native.cpp
// (the port loads none of that package's code), so that the two give the
// same bytes for the same (n, bits, seed): splitmix64 seeds a
// xoshiro256** stream (xoshiro.h) per block of 4096 rows, keyed by the
// block's index, not by the thread that fills it, so the output does not
// depend on the machine's core count.
//
// Host code only (no CUDA): ops/kernels/_build.py compiles it with the
// system C++ compiler into build/kernels/ and binds it with ctypes.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

#include "xoshiro.h"

namespace {

using dt::Xoshiro;

const int64_t kXorBlock = 4096;

}  // namespace

extern "C" void xor_generate(uint64_t seed, int64_t n, int32_t bits,
                             float* x, float* y) {
  int64_t nblocks = (n + kXorBlock - 1) / kXorBlock;
  int64_t nthreads = std::max<int64_t>(
      1, std::min<int64_t>(std::thread::hardware_concurrency(), nblocks));
  std::vector<std::thread> pool;
  std::atomic<int64_t> next_block{0};
  for (int64_t t = 0; t < nthreads; ++t) {
    pool.emplace_back([&, n, bits, seed]() {
      for (;;) {
        int64_t blk = next_block.fetch_add(1);
        if (blk >= nblocks) return;
        int64_t lo = blk * kXorBlock, hi = std::min(n, lo + kXorBlock);
        uint64_t s = seed ^ (0x9E3779B97F4A7C15ull *
                             static_cast<uint64_t>(blk + 1));
        Xoshiro rng(s);
        for (int64_t i = lo; i < hi; ++i) {
          float* xr = x + i * 2 * bits;
          float* yr = y + i * bits;
          for (int32_t b = 0; b < 2 * bits; b += 64) {
            uint64_t w = rng.next();
            int32_t take = std::min(64, 2 * bits - b);
            for (int32_t j = 0; j < take; ++j)
              xr[b + j] = static_cast<float>((w >> j) & 1);
          }
          for (int32_t j = 0; j < bits; ++j)
            yr[j] = static_cast<float>(
                (static_cast<int>(xr[j]) ^ static_cast<int>(xr[bits + j])));
        }
      }
    });
  }
  for (auto& th : pool) th.join();
}
