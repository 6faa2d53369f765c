// The host routines' parallel loop and statuses.
//
// parallel_for runs body(chunk) for every chunk in [0, n_chunks) on
// n_threads std::thread workers (the calling thread is one of them), which
// pull chunk indices from one atomic counter: the work is irregular
// (Mandelbrot's escape loop, the ray tracer's misses and shadows), so a
// fixed split would leave workers idle.  A chunk is a fixed set of output
// elements, each computed by the one thread that takes the chunk in a
// fixed order of operations, so results do not depend on the number of
// threads.  std::thread rather than OpenMP: the torch wheel ships its own
// libgomp, and a second OpenMP runtime in the same process may
// oversubscribe the cores or crash.  The caller passes torch's intra-op
// thread count, which reserve_feeder_cores caps so that each card keeps a
// core for the thread that launches its packets.
#pragma once

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <exception>
#include <thread>
#include <vector>

namespace repro_host {

// statuses of the C entry points (kernels/host_build.py STATUS)
constexpr int kOk = 0;
constexpr int kBadArgument = 1;
constexpr int kFailed = 2;

template <class Body>
int parallel_for(int64_t n_chunks, int n_threads, const Body& body) {
  if (n_chunks <= 0) return kOk;
  const int64_t n_workers =
      std::min<int64_t>(std::max(n_threads, 1), n_chunks);
  std::atomic<int64_t> next{0};
  std::atomic<bool> failed{false};
  auto work = [&]() noexcept {
    try {
      for (int64_t c = next.fetch_add(1); c < n_chunks;
           c = next.fetch_add(1)) {
        body(c);
      }
    } catch (...) {
      failed.store(true);
      next.store(n_chunks);
    }
  };
  std::vector<std::thread> pool;
  try {
    pool.reserve(n_workers - 1);
    for (int64_t i = 1; i < n_workers; ++i) pool.emplace_back(work);
  } catch (const std::exception&) {
    // fewer workers than asked: the ones running take every chunk
  }
  work();
  for (auto& t : pool) t.join();
  return failed.load() ? kFailed : kOk;
}

}  // namespace repro_host
