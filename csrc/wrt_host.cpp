// wrt_host: native host-side runtime for the path tracer.
//
// The device owns the compute path (JAX/XLA/Pallas kernels); this library owns
// the host runtime around it, the role the reference implements in Rust:
// display transform + quantization (the reference's swapchain present,
// src/main.rs:463-473), frame encoding for streaming/storage, terminal
// frame rendering for the interactive viewer, and Morton ordering for
// scene/BVH preparation (mirrors ops/bvh.py for host-built scenes).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency);
// every entry point has a pure-Python fallback in utils/native.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Tonemap: uncharted2 (exposure bias 0.246, white 11.2) + sRGB encode to u8.
// Mirrors ops/tonemap.py (reference raytracer.wgsl:83-103).
// ---------------------------------------------------------------------------

static inline float uncharted2_curve(float x) {
  const float a = 0.15f, b = 0.50f, c = 0.10f, d = 0.20f, e = 0.02f, f = 0.30f;
  return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f;
}

static inline float srgb_encode(float x) {
  x = std::min(1.0f, std::max(0.0f, x));
  return x <= 0.0031308f ? 12.92f * x
                         : 1.055f * std::pow(x, 1.0f / 2.4f) - 0.055f;
}

void wrt_tonemap_u8(const float* mean_rgb, int64_t n_pixels, uint8_t* out) {
  const float exposure = 0.246f;
  const float white_scale = 1.0f / uncharted2_curve(11.2f);
  for (int64_t i = 0; i < n_pixels * 3; ++i) {
    float v = white_scale * uncharted2_curve(exposure * mean_rgb[i]);
    float s = srgb_encode(v) * 255.0f + 0.5f;
    out[i] = (uint8_t)std::min(255.0f, std::max(0.0f, s));
  }
}

// ---------------------------------------------------------------------------
// Terminal frame encoding: 24-bit ANSI half-block cells (two pixels/cell).
// Hot path of the interactive viewer; Python string-building is too slow
// for fluid frame rates at 160x90+.
// Returns the number of bytes written (excluding NUL). `out` must hold at
// least wrt_halfblock_bound(w, h) bytes.
// ---------------------------------------------------------------------------

int64_t wrt_halfblock_bound(int32_t w, int32_t h) {
  // worst case ~45 bytes/cell + newline + reset per row
  return (int64_t)(h / 2 + 1) * ((int64_t)w * 48 + 16);
}

int64_t wrt_halfblock_render(const uint8_t* img, int32_t w, int32_t h,
                             char* out) {
  char* p = out;
  int32_t rows = h - (h % 2);
  for (int32_t y = 0; y < rows; y += 2) {
    const uint8_t* top = img + (int64_t)y * w * 3;
    const uint8_t* bot = img + (int64_t)(y + 1) * w * 3;
    for (int32_t x = 0; x < w; ++x) {
      p += std::sprintf(p, "\x1b[38;2;%d;%d;%dm\x1b[48;2;%d;%d;%dm\xe2\x96\x80",
                        top[3 * x], top[3 * x + 1], top[3 * x + 2],
                        bot[3 * x], bot[3 * x + 1], bot[3 * x + 2]);
    }
    std::memcpy(p, "\x1b[0m\n", 5);
    p += 5;
  }
  *p = '\0';
  return (int64_t)(p - out);
}

// ---------------------------------------------------------------------------
// Morton ordering: 30-bit codes + LSB radix argsort.
// Host-side scene prep mirror of ops/bvh.py (morton_codes/build order).
// ---------------------------------------------------------------------------

static inline uint32_t part1by2(uint32_t x) {
  x &= 0x3FF;
  x = (x | (x << 16)) & 0x030000FF;
  x = (x | (x << 8)) & 0x0300F00F;
  x = (x | (x << 4)) & 0x030C30C3;
  x = (x | (x << 2)) & 0x09249249;
  return x;
}

void wrt_morton_codes(const float* cx, const float* cy, const float* cz,
                      int64_t n, const float* lo, const float* hi,
                      uint32_t* codes) {
  float span[3];
  for (int i = 0; i < 3; ++i) span[i] = std::max(hi[i] - lo[i], 1e-6f);
  for (int64_t i = 0; i < n; ++i) {
    auto q = [&](float v, int k) {
      float t = (v - lo[k]) / span[k] * 1024.0f;
      t = std::min(1023.0f, std::max(0.0f, t));
      return (uint32_t)t;
    };
    codes[i] = part1by2(q(cx[i], 0)) | (part1by2(q(cy[i], 1)) << 1) |
               (part1by2(q(cz[i], 2)) << 2);
  }
}

void wrt_radix_argsort_u32(const uint32_t* keys, int64_t n, int32_t* order) {
  std::vector<int32_t> a(n), b(n);
  for (int64_t i = 0; i < n; ++i) a[i] = (int32_t)i;
  for (int shift = 0; shift < 32; shift += 8) {
    int64_t count[257] = {0};
    for (int64_t i = 0; i < n; ++i)
      count[((keys[a[i]] >> shift) & 0xFF) + 1]++;
    for (int i = 0; i < 256; ++i) count[i + 1] += count[i];
    for (int64_t i = 0; i < n; ++i)
      b[count[(keys[a[i]] >> shift) & 0xFF]++] = a[i];
    std::swap(a, b);
  }
  std::memcpy(order, a.data(), n * sizeof(int32_t));
}

// ---------------------------------------------------------------------------
// PPM encoding (P6). PNG goes through PIL/zlib on the Python side; PPM is
// the zero-dependency fast path for frame dumps and pipes.
// ---------------------------------------------------------------------------

int32_t wrt_write_ppm(const char* path, const uint8_t* img, int32_t w,
                      int32_t h) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f, "P6\n%d %d\n255\n", w, h);
  size_t want = (size_t)w * h * 3;
  size_t got = std::fwrite(img, 1, want, f);
  std::fclose(f);
  return got == want ? 0 : -2;
}

}  // extern "C"
