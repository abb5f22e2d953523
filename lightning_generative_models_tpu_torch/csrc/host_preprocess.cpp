// Host-side image preprocessing: center-crop + area resize on uint8 batches.
//
// The port's copy of the JAX package's native/preprocess.cpp, the same code built
// with the same flags, so that both packages stage a dataset to the same bytes. The
// DataModule's one-time staging of an image folder at native resolution (CelebA,
// LSUN) is Python/PIL-bound; this library runs the hot loop natively: per-image square
// center-crop to min(H, W) followed by a box-filter (area) resize, parallelized across
// images with std::thread. Built at first use and loaded through ctypes by
// lightning_generative_models_tpu_torch/data/native.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Area (box-filter) resample of one HxWxC uint8 image region to SxSxC.
// Matches the semantics of PIL's BILINEAR closely for downscales and exactly
// matches the integer-factor mean-pool path in data/datamodule.py.
void resize_area_one(const uint8_t* src, int src_h, int src_w, int channels,
                     int row_stride, uint8_t* dst, int size) {
  const float scale_y = static_cast<float>(src_h) / size;
  const float scale_x = static_cast<float>(src_w) / size;
  std::vector<float> acc(channels);
  for (int oy = 0; oy < size; ++oy) {
    const float y0 = oy * scale_y;
    const float y1 = std::min((oy + 1) * scale_y, static_cast<float>(src_h));
    for (int ox = 0; ox < size; ++ox) {
      const float x0 = ox * scale_x;
      const float x1 = std::min((ox + 1) * scale_x, static_cast<float>(src_w));
      std::fill(acc.begin(), acc.end(), 0.0f);
      float total_w = 0.0f;
      for (int sy = static_cast<int>(y0); sy < y1; ++sy) {
        const float wy =
            std::min<float>(sy + 1, y1) - std::max<float>(sy, y0);
        const uint8_t* row = src + sy * row_stride;
        for (int sx = static_cast<int>(x0); sx < x1; ++sx) {
          const float wx =
              std::min<float>(sx + 1, x1) - std::max<float>(sx, x0);
          const float w = wy * wx;
          total_w += w;
          const uint8_t* px = row + sx * channels;
          for (int ch = 0; ch < channels; ++ch) acc[ch] += w * px[ch];
        }
      }
      uint8_t* out = dst + (oy * size + ox) * channels;
      for (int ch = 0; ch < channels; ++ch) {
        const float v = acc[ch] / std::max(total_w, 1e-8f);
        out[ch] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// images:   [n, h, w, c] uint8, C-contiguous
// out:      [n, size, size, c] uint8, C-contiguous (pre-allocated)
// Crops each image to the centered min(h,w) square, then area-resizes.
void center_crop_resize_batch(const uint8_t* images, int n, int h, int w,
                              int c, uint8_t* out, int size,
                              int num_threads) {
  const int side = std::min(h, w);
  const int top = (h - side) / 2;
  const int left = (w - side) / 2;
  const long in_stride = static_cast<long>(h) * w * c;
  const long out_stride = static_cast<long>(size) * size * c;
  const int row_stride = w * c;

  if (num_threads <= 0)
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
  num_threads = std::max(1, std::min(num_threads, n));

  auto worker = [&](int start, int stop) {
    for (int i = start; i < stop; ++i) {
      const uint8_t* src =
          images + i * in_stride + (top * w + left) * c;
      resize_area_one(src, side, side, c, row_stride, out + i * out_stride,
                      size);
    }
  };

  std::vector<std::thread> threads;
  const int chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int start = t * chunk;
    const int stop = std::min(start + chunk, n);
    if (start >= stop) break;
    threads.emplace_back(worker, start, stop);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
