// Byte-pair encoding on the host: the encode loop of data/text.py
// BPETokenizer (backend "native" and "auto").
//
// A copy of dt_bpe_encode in the JAX package's native/dttpu_native.cpp
// (the port loads none of that package's code).  The semantics are the
// Python loop's exactly: find the lowest-rank adjacent pair present in
// the sequence, replace every non-overlapping occurrence of it left to
// right, and repeat until no learned pair remains.  merge_pairs is
// [a0, b0, a1, b1, ...] in rank order; merged token r gets id
// base_id + r.
//
// Host code only (no CUDA): ops/kernels/_build.py compiles it with the
// system C++ compiler into build/kernels/ and binds it with ctypes
// (utils/native.py bpe_encode).

#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <vector>

// Writes the ids of text[0:n) to out; returns their count, or -1 when
// out_cap < n.
extern "C" int64_t bpe_encode(const uint8_t* text, int64_t n,
                              const int32_t* merge_pairs, int64_t n_merges,
                              int32_t base_id, int32_t* out,
                              int64_t out_cap) {
  if (n > out_cap) return -1;
  std::vector<int32_t> seq(n);
  for (int64_t i = 0; i < n; ++i) seq[i] = text[i];

  std::unordered_map<uint64_t, int32_t> rank;
  rank.reserve(static_cast<size_t>(n_merges) * 2);
  auto key = [](int32_t a, int32_t b) {
    return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
           static_cast<uint32_t>(b);
  };
  for (int64_t r = 0; r < n_merges; ++r)
    rank.emplace(key(merge_pairs[2 * r], merge_pairs[2 * r + 1]),
                 static_cast<int32_t>(r));

  std::vector<int32_t> next(seq.size());
  while (seq.size() > 1) {
    int32_t best_rank = -1;
    for (size_t i = 0; i + 1 < seq.size(); ++i) {
      auto it = rank.find(key(seq[i], seq[i + 1]));
      if (it != rank.end() && (best_rank < 0 || it->second < best_rank))
        best_rank = it->second;
    }
    if (best_rank < 0) break;
    const int32_t a = merge_pairs[2 * best_rank];
    const int32_t b = merge_pairs[2 * best_rank + 1];
    const int32_t merged = base_id + best_rank;
    next.clear();
    for (size_t i = 0; i < seq.size();) {
      if (i + 1 < seq.size() && seq[i] == a && seq[i + 1] == b) {
        next.push_back(merged);
        i += 2;
      } else {
        next.push_back(seq[i]);
        i += 1;
      }
    }
    seq.swap(next);
  }
  for (size_t i = 0; i < seq.size(); ++i) out[i] = seq[i];
  return static_cast<int64_t>(seq.size());
}
