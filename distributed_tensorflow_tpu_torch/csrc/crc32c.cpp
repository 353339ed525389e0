// CRC32-C (Castagnoli) on the host, slice-by-8: the checksum of every
// checkpoint leaf (train/checkpoint.py) and of the page wire's frames.
//
// A copy of the routine in the JAX package's native/dttpu_native.cpp
// (dt_crc32c); the port loads none of that package's code.  Eight 256-entry
// tables let one step fold eight input bytes; a GPT-2-small training state
// with its moments and EMA shadow is 2 GB, checksummed on every save and
// every verified restore.
//
// Host code only (no CUDA): ops/kernels/_build.py compiles it with the
// system C++ compiler into build/kernels/ and binds it with ctypes.

#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

uint32_t g_tables[8][256];
std::once_flag g_once;

void init_tables() {
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
    g_tables[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = g_tables[0][i];
    for (int t = 1; t < 8; ++t) {
      c = g_tables[0][c & 0xFF] ^ (c >> 8);
      g_tables[t][i] = c;
    }
  }
}

}  // namespace

// CRC32-C of data[0:len) continuing from crc (0 for a fresh checksum).
extern "C" uint32_t crc32c_update(const uint8_t* data, uint64_t len,
                                  uint32_t crc) {
  std::call_once(g_once, init_tables);
  crc ^= 0xFFFFFFFFu;
  while (len >= 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    crc ^= static_cast<uint32_t>(word);
    uint32_t hi = static_cast<uint32_t>(word >> 32);
    crc = g_tables[7][crc & 0xFF] ^ g_tables[6][(crc >> 8) & 0xFF] ^
          g_tables[5][(crc >> 16) & 0xFF] ^ g_tables[4][crc >> 24] ^
          g_tables[3][hi & 0xFF] ^ g_tables[2][(hi >> 8) & 0xFF] ^
          g_tables[1][(hi >> 16) & 0xFF] ^ g_tables[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  while (len--) crc = g_tables[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}
