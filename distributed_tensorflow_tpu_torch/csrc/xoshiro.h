// The host pseudo-random stream shared by csrc/xor.cpp and
// csrc/loader.cpp: splitmix64 to seed, xoshiro256** to draw, and Lemire's
// unbiased bounded draw for the loader's Fisher-Yates shuffle.
//
// A copy of the same routines in the JAX package's
// native/dttpu_native.cpp (the port loads none of that package's code),
// so that both packages draw the same numbers for the same seed: the XOR
// task's rows, and the loader's permutation of each epoch.

#pragma once

#include <cstdint>

namespace dt {

inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

struct Xoshiro {
  uint64_t s[4];
  explicit Xoshiro(uint64_t seed) {
    for (auto& w : s) w = splitmix64(seed);
  }
  static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // Unbiased draw in [0, n) (Lemire).
  uint64_t bounded(uint64_t n) {
    unsigned __int128 m = static_cast<unsigned __int128>(next()) * n;
    uint64_t lo = static_cast<uint64_t>(m);
    if (lo < n) {
      uint64_t thresh = (0 - n) % n;
      while (lo < thresh) {
        m = static_cast<unsigned __int128>(next()) * n;
        lo = static_cast<uint64_t>(m);
      }
    }
    return static_cast<uint64_t>(m >> 64);
  }
};

}  // namespace dt
