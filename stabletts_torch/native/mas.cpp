// Monotonic Alignment Search — native CPU kernel.
//
// Same DP semantics as the device-side lax.scan kernel (stabletts_tpu/ops/
// mas.py) and the reference's numba kernel (reference: monotonic_align/
// core.py:14-47): forward accumulation over the (t_y, t_x) band, then argmax
// backtrace. Batch items run in parallel across threads.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libstabletts_native.so mas.cpp audio.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr float kMaxNeg = -1e9f;

void mas_single(int32_t* path, float* value, int t_y, int t_x, int t_y_max,
                int t_x_max) {
  // degenerate lengths: t_x==0 would write path[-1] (heap corruption) and
  // an empty t_y has nothing to do — leave the zeroed path untouched
  if (t_y <= 0 || t_x <= 0) return;
  t_x = std::min(t_x, t_x_max);
  t_y = std::min(t_y, t_y_max);
  // forward: value[y, x] += max(value[y-1, x-1], value[y-1, x]) within band
  for (int y = 0; y < t_y; ++y) {
    const int x_lo = std::max(0, t_x + y - t_y);
    const int x_hi = std::min(t_x, y + 1);
    float* row = value + static_cast<int64_t>(y) * t_x_max;
    const float* prev = row - t_x_max;  // row y-1 (unused when y == 0)
    for (int x = x_lo; x < x_hi; ++x) {
      const float v_cur = (x == y) ? kMaxNeg : prev[x];
      float v_prev;
      if (x == 0) {
        v_prev = (y == 0) ? 0.0f : kMaxNeg;
      } else {
        v_prev = prev[x - 1];
      }
      row[x] += std::max(v_prev, v_cur);
    }
  }
  // backtrace. The y==0 index update is skipped: it would read row -1 (the
  // python reference wraps to the last row there, C would read out of
  // bounds) and the updated index is never used after the final write.
  int index = t_x - 1;
  for (int y = t_y - 1; y >= 0; --y) {
    path[static_cast<int64_t>(y) * t_x_max + index] = 1;
    if (index != 0 && y > 0) {
      const float* prev = value + static_cast<int64_t>(y - 1) * t_x_max;
      if (index == y || prev[index] < prev[index - 1]) {
        --index;
      }
    }
  }
}

}  // namespace

extern "C" {

// paths: [b, t_y_max, t_x_max] int32 zero-initialized (output)
// values: [b, t_y_max, t_x_max] float32 neg_cent (modified in place)
// t_ys, t_xs: [b] int32 valid lengths
void stabletts_maximum_path(int32_t* paths, float* values, const int32_t* t_ys,
                            const int32_t* t_xs, int b, int t_y_max,
                            int t_x_max, int n_threads) {
  const int64_t plane = static_cast<int64_t>(t_y_max) * t_x_max;
  if (n_threads <= 1 || b == 1) {
    for (int i = 0; i < b; ++i) {
      mas_single(paths + i * plane, values + i * plane, t_ys[i], t_xs[i],
                 t_y_max, t_x_max);
    }
    return;
  }
  std::vector<std::thread> workers;
  std::atomic_int next{0};
  auto run = [&]() {
    for (int i = next.fetch_add(1); i < b; i = next.fetch_add(1)) {
      mas_single(paths + i * plane, values + i * plane, t_ys[i], t_xs[i],
                 t_y_max, t_x_max);
    }
  };
  const int n = std::min(n_threads, b);
  workers.reserve(n);
  for (int t = 0; t < n; ++t) workers.emplace_back(run);
  for (auto& w : workers) w.join();
}

}  // extern "C"
