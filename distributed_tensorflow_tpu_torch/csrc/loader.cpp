// The threaded batch loader on the host: a per-epoch Fisher-Yates shuffle
// and the row gather run on worker threads into a bounded ring of
// pre-allocated batch buffers, so the consumer's next() is one copy away
// from a batch already gathered.
//
// A copy of the loader in the JAX package's native/dttpu_native.cpp
// (dt_loader_*; the port loads none of that package's code), so that for
// the same (seed, shuffle, n, batch) the two packages hand out the same
// batches in the same order: epoch e's permutation draws from
// Xoshiro(seed * 0x9E3779B97F4A7C15 + e) (xoshiro.h); batch j of the
// epoch is rows perm[j * batch : (j + 1) * batch]; a partial last batch
// is dropped.
//
// Rows move as raw bytes (xrow, yrow: bytes a row), so any fixed-width
// dtype loads.  Workers claim global batch ids in order; one may build
// epoch e's permutation only once every batch of the earlier epochs has
// been consumed, and may claim a ring slot only for a batch inside the
// in-flight window (job - next_consume < depth), so a fast worker never
// takes the slot of a batch a slower one still holds.
//
// Host code only (no CUDA): ops/kernels/_build.py compiles it with the
// system C++ compiler into build/kernels/ and binds it with ctypes
// (utils/native.py NativeLoader).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include "xoshiro.h"

namespace {

struct Slot {
  std::vector<uint8_t> x, y;
  int64_t batch_id = -1;   // the global batch that holds this slot
  bool ready = false;
};

struct Loader {
  const uint8_t* x;
  const uint8_t* y;
  int64_t xrow, yrow, n, batch, per_epoch;
  uint64_t seed;
  bool shuffle;

  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<int64_t> next_job{0};
  int64_t next_consume = 0;
  bool stop = false;

  // the permutation of epoch perm_epoch, rebuilt under mu
  int64_t perm_epoch = -1;
  std::vector<int64_t> perm;

  void build_perm(int64_t epoch) {
    perm.resize(n);
    for (int64_t i = 0; i < n; ++i) perm[i] = i;
    if (!shuffle) return;
    uint64_t s = seed * 0x9E3779B97F4A7C15ull + static_cast<uint64_t>(epoch);
    dt::Xoshiro rng(s);
    for (int64_t i = n - 1; i > 0; --i) {
      int64_t j = static_cast<int64_t>(rng.bounded(i + 1));
      std::swap(perm[i], perm[j]);
    }
  }

  // Copy the rows of global batch `job` out of the permutation under mu
  // (it changes between epochs), then gather outside the lock.
  void run_worker() {
    for (;;) {
      int64_t job = next_job.fetch_add(1);
      std::vector<int64_t> idx(batch);
      {
        std::unique_lock<std::mutex> lock(mu);
        if (stop) return;
        int64_t epoch = job / per_epoch;
        int64_t off = (job % per_epoch) * batch;
        while (!stop && perm_epoch != epoch) {
          if (perm_epoch < epoch &&
              next_consume >= std::min(job, epoch * per_epoch)) {
            build_perm(epoch);
            perm_epoch = epoch;
            break;
          }
          cv_free.wait_for(lock, std::chrono::milliseconds(1));
        }
        if (stop) return;
        for (int64_t i = 0; i < batch; ++i) idx[i] = perm[off + i];
        Slot& s = slots[job % slots.size()];
        while (!stop &&
               (s.batch_id >= 0 ||
                job - next_consume >= static_cast<int64_t>(slots.size())))
          cv_free.wait(lock);
        if (stop) return;
        s.batch_id = job;  // claim
      }
      Slot& s = slots[job % slots.size()];
      for (int64_t i = 0; i < batch; ++i) {
        std::memcpy(s.x.data() + i * xrow, x + idx[i] * xrow, xrow);
        if (y != nullptr)
          std::memcpy(s.y.data() + i * yrow, y + idx[i] * yrow, yrow);
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        s.ready = true;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

// A loader over x [n, xrow bytes] and y [n, yrow bytes] (y may be null);
// null when batch <= 0 or n < batch.
extern "C" void* loader_create(const uint8_t* x, int64_t xrow,
                               const uint8_t* y, int64_t yrow, int64_t n,
                               int64_t batch, uint64_t seed, int32_t shuffle,
                               int32_t num_threads, int32_t queue_depth) {
  if (batch <= 0 || n < batch) return nullptr;
  auto* L = new Loader();
  L->x = x; L->y = y; L->xrow = xrow; L->yrow = yrow;
  L->n = n; L->batch = batch; L->per_epoch = n / batch;
  L->seed = seed; L->shuffle = shuffle != 0;
  if (num_threads <= 0) num_threads = 2;
  if (queue_depth < num_threads + 1) queue_depth = num_threads + 1;
  L->slots.resize(queue_depth);
  for (auto& s : L->slots) {
    s.x.resize(batch * xrow);
    if (y != nullptr) s.y.resize(batch * yrow);
  }
  for (int32_t i = 0; i < num_threads; ++i)
    L->workers.emplace_back([L] { L->run_worker(); });
  return L;
}

extern "C" int64_t loader_batches_per_epoch(void* h) {
  return static_cast<Loader*>(h)->per_epoch;
}

// Blocks until the next batch in order is gathered, and copies it out.
extern "C" void loader_next(void* h, uint8_t* xout, uint8_t* yout) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lock(L->mu);
  int64_t want = L->next_consume;
  Slot& s = L->slots[want % L->slots.size()];
  L->cv_ready.wait(lock, [&] { return s.batch_id == want && s.ready; });
  std::memcpy(xout, s.x.data(), L->batch * L->xrow);
  if (yout != nullptr && L->y != nullptr)
    std::memcpy(yout, s.y.data(), L->batch * L->yrow);
  s.batch_id = -1;
  s.ready = false;
  L->next_consume = want + 1;
  lock.unlock();
  L->cv_free.notify_all();
}

extern "C" void loader_destroy(void* h) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lock(L->mu);
    L->stop = true;
  }
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}
