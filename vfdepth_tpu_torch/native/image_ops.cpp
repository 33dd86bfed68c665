// Native host-side image ops for the data pipeline.
//
// The reference feeds its torch DataLoader with PIL-based per-camera resize
// (heavy on Python/PIL; SURVEY.md §7 hard part 7 flags the host pipeline as
// a throughput risk). This library provides the two hot per-sample
// operations as multithreaded C++ callable via ctypes:
//
//   * bilinear_resize_batch: [N, H, W, C] float32 -> [N, H', W', C]
//     (align_corners=False / half-pixel convention, matching the
//     torchvision Resize the reference uses for inputs)
//   * u8_to_f32_resize_batch: decode-normalized uint8 HWC frames straight
//     to resized float32 (fuses /255 normalization with the resize)
//
// Threads come from a small internal pool sized by the caller.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ResizePlan {
  std::vector<int> lo;      // source low index per output pixel
  std::vector<float> whi;   // weight of lo+1
};

ResizePlan plan_axis(int in_size, int out_size) {
  ResizePlan p;
  p.lo.resize(out_size);
  p.whi.resize(out_size);
  const double scale = static_cast<double>(in_size) / out_size;
  for (int i = 0; i < out_size; ++i) {
    double src = (i + 0.5) * scale - 0.5;
    src = std::max(0.0, std::min(src, static_cast<double>(in_size - 1)));
    int lo = static_cast<int>(std::floor(src));
    lo = std::min(lo, in_size - 1);
    p.lo[i] = lo;
    p.whi[i] = static_cast<float>(src - lo);
  }
  return p;
}

template <typename SrcT, bool kNormalize>
void resize_one(const SrcT* src, float* dst, int in_h, int in_w, int out_h,
                int out_w, int channels, const ResizePlan& py,
                const ResizePlan& px) {
  const float norm = kNormalize ? 1.0f / 255.0f : 1.0f;
  std::vector<float> row(static_cast<size_t>(out_w) * channels);
  for (int oy = 0; oy < out_h; ++oy) {
    const int y0 = py.lo[oy];
    const int y1 = std::min(y0 + 1, in_h - 1);
    const float wy = py.whi[oy];
    const SrcT* r0 = src + static_cast<size_t>(y0) * in_w * channels;
    const SrcT* r1 = src + static_cast<size_t>(y1) * in_w * channels;
    float* out_row = dst + static_cast<size_t>(oy) * out_w * channels;
    for (int ox = 0; ox < out_w; ++ox) {
      const int x0 = px.lo[ox];
      const int x1 = std::min(x0 + 1, in_w - 1);
      const float wx = px.whi[ox];
      const float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
      const float w10 = wy * (1 - wx), w11 = wy * wx;
      const SrcT* p00 = r0 + static_cast<size_t>(x0) * channels;
      const SrcT* p01 = r0 + static_cast<size_t>(x1) * channels;
      const SrcT* p10 = r1 + static_cast<size_t>(x0) * channels;
      const SrcT* p11 = r1 + static_cast<size_t>(x1) * channels;
      float* o = out_row + static_cast<size_t>(ox) * channels;
      for (int c = 0; c < channels; ++c) {
        o[c] = norm * (w00 * static_cast<float>(p00[c]) +
                       w01 * static_cast<float>(p01[c]) +
                       w10 * static_cast<float>(p10[c]) +
                       w11 * static_cast<float>(p11[c]));
      }
    }
  }
  (void)row;
}

template <typename SrcT, bool kNormalize>
void resize_batch(const SrcT* src, float* dst, int n, int in_h, int in_w,
                  int out_h, int out_w, int channels, int n_threads) {
  const ResizePlan py = plan_axis(in_h, out_h);
  const ResizePlan px = plan_axis(in_w, out_w);
  const size_t in_stride = static_cast<size_t>(in_h) * in_w * channels;
  const size_t out_stride = static_cast<size_t>(out_h) * out_w * channels;

  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      resize_one<SrcT, kNormalize>(src + i * in_stride, dst + i * out_stride,
                                   in_h, in_w, out_h, out_w, channels, py, px);
    }
  };
  n_threads = std::max(1, std::min(n_threads, n));
  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void bilinear_resize_batch_f32(const float* src, float* dst, int n, int in_h,
                               int in_w, int out_h, int out_w, int channels,
                               int n_threads) {
  resize_batch<float, false>(src, dst, n, in_h, in_w, out_h, out_w, channels,
                             n_threads);
}

void u8_to_f32_resize_batch(const uint8_t* src, float* dst, int n, int in_h,
                            int in_w, int out_h, int out_w, int channels,
                            int n_threads) {
  resize_batch<uint8_t, true>(src, dst, n, in_h, in_w, out_h, out_w, channels,
                              n_threads);
}

}  // extern "C"
