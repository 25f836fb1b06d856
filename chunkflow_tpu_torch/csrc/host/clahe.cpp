// Contrast-limited adaptive histogram equalization of uint8 sections,
// bitwise OpenCV's cv::CLAHE::apply with tileGridSize (t, t).
//
// cf_clahe_u8 equalizes each of nz sections of ny x nx pixels on its own:
// the section is padded reflect-101 (bottom t - ny % t, right t - nx % t,
// when either is nonzero) for the histograms, each of the t x t tiles gets
// a clipped 256-bin histogram and a lookup table, and each pixel mixes the
// tables of its four nearest tiles bilinearly in float32. The arithmetic is
// OpenCV's, operation for operation; no multiply and add may fuse, or the
// rounding would differ from OpenCV's (and from ops/clahe.py:clahe_plain,
// the same steps in numpy). Sections run on up to `threads` std::threads;
// each section's result does not depend on the count.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr int kBins = 256;

// OpenCV's borderInterpolate for BORDER_REFLECT_101
int64_t reflect_101(int64_t p, int64_t n) {
  if (n == 1) return 0;
  while (p < 0 || p >= n) p = p < 0 ? -p : 2 * n - 2 - p;
  return p;
}

inline uint8_t saturate_u8(float v) {
  // cvRound: nearest, ties to even (the default rounding mode)
  const long r = std::lrint(v);
  return static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
}

struct Axis {
  std::vector<int32_t> first, second;
  std::vector<float> w_first, w_second;
};

__attribute__((optimize("fp-contract=off")))
Axis axis_weights(int64_t n, int64_t tile, int t) {
  Axis a;
  a.first.resize(n);
  a.second.resize(n);
  a.w_first.resize(n);
  a.w_second.resize(n);
  const float inv = 1.0f / static_cast<float>(tile);
  for (int64_t i = 0; i < n; ++i) {
    const float f = static_cast<float>(i) * inv - 0.5f;
    const int lo = static_cast<int>(std::floor(f));
    const float w = f - static_cast<float>(lo);
    a.w_second[i] = w;
    a.w_first[i] = 1.0f - w;
    a.first[i] = std::max(lo, 0);
    a.second[i] = std::min(lo + 1, t - 1);
  }
  return a;
}

__attribute__((optimize("fp-contract=off")))
void clahe_section(const uint8_t* src, uint8_t* dst, int64_t ny, int64_t nx,
                   int t, double clip_limit) {
  const bool pad = ny % t != 0 || nx % t != 0;
  const int64_t py = pad ? ny + t - ny % t : ny;
  const int64_t px = pad ? nx + t - nx % t : nx;
  const int64_t th = py / t, tw = px / t;
  const int64_t area = th * tw;
  std::vector<int64_t> rows(py), cols(px);
  for (int64_t i = 0; i < py; ++i) rows[i] = reflect_101(i, ny);
  for (int64_t i = 0; i < px; ++i) cols[i] = reflect_101(i, nx);

  int64_t limit = 0;
  if (clip_limit > 0.0) {
    limit = static_cast<int64_t>(clip_limit * static_cast<double>(area) /
                                 kBins);
    limit = std::max<int64_t>(limit, 1);
  }
  const float scale = static_cast<float>(kBins - 1) / static_cast<float>(area);
  std::vector<uint8_t> lut(static_cast<size_t>(t) * t * kBins);
  std::vector<int64_t> hist(kBins);
  for (int ty = 0; ty < t; ++ty) {
    for (int tx = 0; tx < t; ++tx) {
      std::fill(hist.begin(), hist.end(), 0);
      for (int64_t y = ty * th; y < (ty + 1) * th; ++y) {
        const uint8_t* row = src + rows[y] * nx;
        for (int64_t x = tx * tw; x < (tx + 1) * tw; ++x) ++hist[row[cols[x]]];
      }
      if (limit > 0) {
        int64_t clipped = 0;
        for (int i = 0; i < kBins; ++i) {
          if (hist[i] > limit) {
            clipped += hist[i] - limit;
            hist[i] = limit;
          }
        }
        const int64_t batch = clipped / kBins;
        int64_t residual = clipped - batch * kBins;
        for (int i = 0; i < kBins; ++i) hist[i] += batch;
        if (residual != 0) {
          const int64_t step = std::max<int64_t>(kBins / residual, 1);
          for (int64_t i = 0; i < kBins && residual > 0; i += step, --residual)
            ++hist[i];
        }
      }
      uint8_t* table = lut.data() + (static_cast<size_t>(ty) * t + tx) * kBins;
      int64_t sum = 0;
      for (int i = 0; i < kBins; ++i) {
        sum += hist[i];
        table[i] = saturate_u8(static_cast<float>(sum) * scale);
      }
    }
  }

  const Axis ax = axis_weights(nx, tw, t);
  const Axis ay = axis_weights(ny, th, t);
  for (int64_t y = 0; y < ny; ++y) {
    const uint8_t* l1 = lut.data() + static_cast<size_t>(ay.first[y]) * t * kBins;
    const uint8_t* l2 = lut.data() + static_cast<size_t>(ay.second[y]) * t * kBins;
    const float ya = ay.w_second[y], ya1 = ay.w_first[y];
    const uint8_t* in = src + y * nx;
    uint8_t* out = dst + y * nx;
    for (int64_t x = 0; x < nx; ++x) {
      const int v = in[x];
      const int64_t i1 = static_cast<int64_t>(ax.first[x]) * kBins + v;
      const int64_t i2 = static_cast<int64_t>(ax.second[x]) * kBins + v;
      const float xa = ax.w_second[x], xa1 = ax.w_first[x];
      const float top = static_cast<float>(l1[i1]) * xa1 +
                        static_cast<float>(l1[i2]) * xa;
      const float bottom = static_cast<float>(l2[i1]) * xa1 +
                           static_cast<float>(l2[i2]) * xa;
      out[x] = saturate_u8(top * ya1 + bottom * ya);
    }
  }
}

}  // namespace

extern "C" {

// CLAHE of nz uint8 sections of ny x nx each (C order) into dst; the grid
// is t x t tiles, clip_limit <= 0 leaves the histograms unclipped. Returns
// 0, or -1 for a bad shape or grid.
int cf_clahe_u8(const uint8_t* src, uint8_t* dst, int64_t nz, int64_t ny,
                int64_t nx, double clip_limit, int t, int threads) {
  if (nz < 0 || ny < 1 || nx < 1 || t < 1) return -1;
  const int64_t plane = ny * nx;
  int nt = std::max(1, std::min<int>(threads, static_cast<int>(nz)));
  if (nt == 1) {
    for (int64_t z = 0; z < nz; ++z)
      clahe_section(src + z * plane, dst + z * plane, ny, nx, t, clip_limit);
    return 0;
  }
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int w = 0; w < nt; ++w) {
    workers.emplace_back([=]() {
      for (int64_t z = w; z < nz; z += nt)
        clahe_section(src + z * plane, dst + z * plane, ny, nx, t,
                      clip_limit);
    });
  }
  for (auto& worker : workers) worker.join();
  return 0;
}

}  // extern "C"
