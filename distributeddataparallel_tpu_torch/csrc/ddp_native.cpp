// Native host-side input kernels for distributeddataparallel_tpu_torch: a
// copy of the JAX package's csrc/ddp_native.cpp (the same arithmetic, so both
// packages produce the same bytes), without the bucket planner, which the
// port keeps in Python (parallel/data_parallel.py).
//
//   - ddp_gather_rows_f32 / ddp_gather_norm_u8: the per-batch fancy-index
//     copy, and the fused uint8 -> normalized float32 transform (ToTensor +
//     Normalize((0.5,), (0.5,))), multithreaded with the GIL released
//     (called through ctypes from data.loader and data.sharded).
//   - ddp_chw_to_hwc_f32: (N, C, H, W) -> (N, H, W, C) layout conversion.
//   - ddp_gather_augment_u8: gather + RandomCrop(pad) + horizontal flip +
//     normalize in one pass over the uint8 rows (data.transforms).
//
// Built on first use with g++ (-ffp-contract=off keeps every product and
// sum rounded as numpy rounds them) into distributeddataparallel_tpu_torch/
// _build/ by distributeddataparallel_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// Run fn(begin, end) over [0, n) split across up to max_threads threads.
template <typename Fn>
void parallel_for(int64_t n, int max_threads, Fn fn) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int threads = std::max(1, std::min(max_threads, hw));
  if (threads == 1 || n < 2) {
    fn(static_cast<int64_t>(0), n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = std::min(n, begin + chunk);
    if (begin >= end) break;
    pool.emplace_back([=] { fn(begin, end); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// out[i, :] = src[idx[i], :]; rows are row_elems float32 each.
void ddp_gather_rows_f32(const float* src, const int64_t* idx, int64_t n_idx,
                         int64_t row_elems, float* out, int max_threads) {
  parallel_for(n_idx, max_threads, [=](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      std::memcpy(out + i * row_elems, src + idx[i] * row_elems,
                  sizeof(float) * static_cast<size_t>(row_elems));
    }
  });
}

// out[i, :] = (src[idx[i], :] / 255 - shift) / scale  (u8 -> f32 fused with
// the reference's ToTensor + Normalize transform, ref dpp.py:32).
void ddp_gather_norm_u8(const uint8_t* src, const int64_t* idx, int64_t n_idx,
                        int64_t row_elems, float shift, float scale,
                        float* out, int max_threads) {
  const float inv255 = 1.0f / 255.0f;
  const float inv_scale = 1.0f / scale;
  parallel_for(n_idx, max_threads, [=](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      const uint8_t* s = src + idx[i] * row_elems;
      float* o = out + i * row_elems;
      for (int64_t j = 0; j < row_elems; ++j) {
        o[j] = (static_cast<float>(s[j]) * inv255 - shift) * inv_scale;
      }
    }
  });
}

// (N, C, H, W) f32 -> (N, H, W, C): the NHWC layout of the image models.
void ddp_chw_to_hwc_f32(const float* src, int64_t n, int64_t c, int64_t h,
                        int64_t w, float* out, int max_threads) {
  parallel_for(n, max_threads, [=](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      const float* img = src + i * c * h * w;
      float* o = out + i * h * w * c;
      for (int64_t ch = 0; ch < c; ++ch) {
        const float* plane = img + ch * h * w;
        for (int64_t p = 0; p < h * w; ++p) {
          o[p * c + ch] = plane[p];
        }
      }
    }
  });
}

// Fused training-augmentation gather: for each output row i,
//   out[i] = normalize(flip_i(crop_i(src[idx[i]])))
// in one pass over the uint8 source — the gather, the RandomCrop(pad)
// (virtual padding: out-of-bounds source pixels become `fill`, already
// in normalized units), the optional horizontal flip, and the
// ToTensor+Normalize transform never materialize intermediates.
// Layout: src (N, H, W, C) u8; oy/ox in [0, 2*pad]; flip 0/1 per row.
// Crop-then-flip order matches data/transforms.py: the flipped output
// pixel (y, x) reads the crop at (y, w-1-x).
void ddp_gather_augment_u8(const uint8_t* src, const int64_t* idx,
                           int64_t n_idx, int64_t h, int64_t w, int64_t c,
                           const int64_t* oy, const int64_t* ox,
                           const uint8_t* flip, int64_t pad, float shift,
                           float scale, float fill, float* out,
                           int max_threads) {
  const float inv255 = 1.0f / 255.0f;
  const float inv_scale = 1.0f / scale;
  parallel_for(n_idx, max_threads, [=](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      const uint8_t* img = src + idx[i] * h * w * c;
      float* o = out + i * h * w * c;
      const int64_t dy = oy[i] - pad;
      const int64_t dx = ox[i] - pad;
      const bool fl = flip[i] != 0;
      for (int64_t y = 0; y < h; ++y) {
        const int64_t sy = y + dy;
        const bool row_ok = sy >= 0 && sy < h;
        for (int64_t x = 0; x < w; ++x) {
          const int64_t cx = fl ? (w - 1 - x) : x;
          const int64_t sx = cx + dx;
          float* op = o + (y * w + x) * c;
          if (row_ok && sx >= 0 && sx < w) {
            const uint8_t* sp = img + (sy * w + sx) * c;
            for (int64_t ch = 0; ch < c; ++ch) {
              op[ch] =
                  (static_cast<float>(sp[ch]) * inv255 - shift) * inv_scale;
            }
          } else {
            for (int64_t ch = 0; ch < c; ++ch) op[ch] = fill;
          }
        }
      }
    }
  });
}

}  // extern "C"
