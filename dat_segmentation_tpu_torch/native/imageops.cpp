// The two host-side image ops of the port's train transform, in C++.
//
// A copy of normalize_pad_f32 and photometric_distortion_u8 (with its HSV
// helpers) from dat_segmentation_tpu/native/imageops.cpp, the JAX package's
// native data path, unchanged, so that the port's augmentation equals that
// package's native branch (DAT_TPU_NATIVE=1) bit for bit on one machine.
// The port builds it with g++ at first use (native/__init__.py), with the
// JAX package's Makefile flags: -O3 -march=native -fPIC -shared -std=c++17.
// -march=native lets GCC contract products into FMAs where the host has
// them, so two machines may differ in the last bit of an intermediate and,
// after a uint8 rounding, by one grey level.
//
// All images are HWC, uint8 (aug stages) or float32 (post-normalize),
// C-contiguous.
//
// resize_cubic_u8 and warp_affine_u8_c3 (the classifier's transforms) are
// not in the JAX package's library: they reproduce cv2.resize(INTER_CUBIC)
// and cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT) on uint8 images bit for
// bit, as OpenCV's own C++ computes them (its IPP path, not taken here,
// differs for the resize). Their floating-point steps are written out with
// std::fmaf where OpenCV fuses and with FMA contraction off elsewhere, so
// -march=native cannot change them.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Fused normalize + pad: (img - mean)/std into a pre-sized float32
// canvas; the padded region stays at pad_value.
void normalize_pad_f32(const uint8_t* src, int h, int w,
                       const float* mean, const float* stdinv,
                       float* dst, int oh, int ow, float pad_value) {
  for (int i = 0; i < oh * ow * 3; ++i) dst[i] = pad_value;
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = src + y * w * 3;
    float* o = dst + y * ow * 3;
    for (int x = 0; x < w; ++x) {
      o[x * 3 + 0] = (s[x * 3 + 0] - mean[0]) * stdinv[0];
      o[x * 3 + 1] = (s[x * 3 + 1] - mean[1]) * stdinv[1];
      o[x * 3 + 2] = (s[x * 3 + 2] - mean[2]) * stdinv[2];
    }
  }
}

// RGB<->HSV helpers matching OpenCV's uint8 conventions
// (H in [0,180), S,V in [0,255]).
static inline void rgb2hsv_px(float r, float g, float b, float* hsv) {
  float mx = std::max(r, std::max(g, b));
  float mn = std::min(r, std::min(g, b));
  float d = mx - mn;
  float hch;
  if (d == 0.f) hch = 0.f;
  else if (mx == r) hch = 60.f * (g - b) / d;
  else if (mx == g) hch = 120.f + 60.f * (b - r) / d;
  else hch = 240.f + 60.f * (r - g) / d;
  if (hch < 0) hch += 360.f;
  hsv[0] = hch * 0.5f;                       // [0, 180)
  hsv[1] = mx == 0.f ? 0.f : 255.f * d / mx; // [0, 255]
  hsv[2] = mx;
}

static inline void hsv2rgb_px(float h, float s, float v, uint8_t* rgb) {
  h = h * 2.f;  // back to degrees
  s /= 255.f;
  float cc = v * s;
  float hh = h / 60.f;
  float xx = cc * (1.f - std::fabs(std::fmod(hh, 2.f) - 1.f));
  float m = v - cc;
  float r, g, b;
  if (hh < 1) { r = cc; g = xx; b = 0; }
  else if (hh < 2) { r = xx; g = cc; b = 0; }
  else if (hh < 3) { r = 0; g = cc; b = xx; }
  else if (hh < 4) { r = 0; g = xx; b = cc; }
  else if (hh < 5) { r = xx; g = 0; b = cc; }
  else { r = cc; g = 0; b = xx; }
  rgb[0] = (uint8_t)std::min(255.f, std::max(0.f, r + m + 0.5f));
  rgb[1] = (uint8_t)std::min(255.f, std::max(0.f, g + m + 0.5f));
  rgb[2] = (uint8_t)std::min(255.f, std::max(0.f, b + m + 0.5f));
}

// Fused photometric distortion (reference datasets/ade20k.py:205-244):
// brightness delta, contrast alpha (order by mode), saturation factor,
// hue shift — one pass per pixel instead of five full-image ops.
// Disabled steps: pass delta=0 / alpha=1 / sat=1 / hue=0.
void photometric_distortion_u8(uint8_t* img, int h, int w,
                               float brightness_delta, float contrast_alpha,
                               float saturation, float hue_delta,
                               int contrast_first) {
  const int n = h * w;
  for (int i = 0; i < n; ++i) {
    uint8_t* px = img + i * 3;
    float r = px[0] + brightness_delta;
    float g = px[1] + brightness_delta;
    float b = px[2] + brightness_delta;
    if (contrast_first) { r *= contrast_alpha; g *= contrast_alpha; b *= contrast_alpha; }
    // quantize like the reference's uint8 round-trips
    r = std::min(255.f, std::max(0.f, r));
    g = std::min(255.f, std::max(0.f, g));
    b = std::min(255.f, std::max(0.f, b));
    r = (float)(uint8_t)(r); g = (float)(uint8_t)(g); b = (float)(uint8_t)(b);
    float hsv[3];
    rgb2hsv_px(r, g, b, hsv);
    hsv[1] = std::min(255.f, std::max(0.f, hsv[1] * saturation));
    hsv[0] = std::fmod(hsv[0] + hue_delta + 180.f, 180.f);
    uint8_t rgb[3];
    hsv2rgb_px(hsv[0], hsv[1], hsv[2], rgb);
    if (!contrast_first) {
      float rr = rgb[0] * contrast_alpha;
      float gg = rgb[1] * contrast_alpha;
      float bb = rgb[2] * contrast_alpha;
      px[0] = (uint8_t)std::min(255.f, std::max(0.f, rr));
      px[1] = (uint8_t)std::min(255.f, std::max(0.f, gg));
      px[2] = (uint8_t)std::min(255.f, std::max(0.f, bb));
    } else {
      px[0] = rgb[0]; px[1] = rgb[1]; px[2] = rgb[2];
    }
  }
}

#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")

// cv2.resize(src, (dw, dh), interpolation=INTER_CUBIC) of an (h, w, cn)
// uint8 image, as OpenCV's resizeGeneric_ computes it. The tables come from
// the caller (native/__init__.py:cubic_table, OpenCV's float32 coefficient
// arithmetic): per output column the first source column of its 4 taps
// (before clamping) and the 4 coefficients scaled by 2048 and rounded; the
// same per output row. The horizontal pass sums in int; the vertical pass
// takes 8 outputs at a time in float32 (OpenCV's VResizeCubicVec_32s8u,
// mul then add, rounded half to even) and the tail in fixed point
// (VResizeCubic: +2^21, >>22).
void resize_cubic_u8(const uint8_t* src, int h, int w, int cn, uint8_t* dst,
                     int dh, int dw, const int* xofs, const int16_t* alpha,
                     const int* yofs, const int16_t* beta) {
  const int width = dw * cn;
  std::vector<int> rows(4 * (size_t)width);
  std::vector<int> tapx(4 * (size_t)dw);
  for (int dx = 0; dx < dw; ++dx)
    for (int j = 0; j < 4; ++j)
      tapx[dx * 4 + j] = std::min(std::max(xofs[dx] + j, 0), w - 1) * cn;
  int cached[4] = {-1, -1, -1, -1};
  const float scale = 1.f / (2048 * 2048);
  for (int dy = 0; dy < dh; ++dy) {
    int* r[4];
    for (int k = 0; k < 4; ++k) {
      const int sy = std::min(std::max(yofs[dy] + k, 0), h - 1);
      r[k] = rows.data() + (size_t)k * width;
      if (cached[k] == sy) continue;
      cached[k] = sy;
      const uint8_t* s = src + (size_t)sy * w * cn;
      for (int dx = 0; dx < dw; ++dx) {
        const int16_t* a = alpha + dx * 4;
        const int* t = tapx.data() + dx * 4;
        for (int c = 0; c < cn; ++c)
          r[k][dx * cn + c] = s[t[0] + c] * a[0] + s[t[1] + c] * a[1] +
                              s[t[2] + c] * a[2] + s[t[3] + c] * a[3];
      }
    }
    const int16_t* b = beta + dy * 4;
    const float b0 = b[0] * scale, b1 = b[1] * scale, b2 = b[2] * scale,
                b3 = b[3] * scale;
    uint8_t* d = dst + (size_t)dy * width;
    const int vec_end = width / 8 * 8;
    int x = 0;
    for (; x < vec_end; ++x) {
      float v = (float)r[3][x] * b3;
      v = (float)r[2][x] * b2 + v;
      v = (float)r[1][x] * b1 + v;
      v = (float)r[0][x] * b0 + v;
      const int iv = (int)std::nearbyint(v);
      d[x] = (uint8_t)std::min(std::max(iv, 0), 255);
    }
    for (; x < width; ++x) {
      const int v = r[0][x] * b[0] + r[1][x] * b[1] + r[2][x] * b[2] +
                    r[3][x] * b[3];
      d[x] = (uint8_t)std::min(std::max((v + (1 << 21)) >> 22, 0), 255);
    }
  }
}

// cv2.warpAffine(src, M, (w, h), flags=INTER_LINEAR | WARP_INVERSE_MAP,
// borderMode=BORDER_CONSTANT, borderValue=(fill,) * 3) of an (h, w, 3)
// uint8 image; M (2x3, output -> input, float32) as OpenCV takes it after
// its conversion to float. OpenCV's warp_kernels compute each source
// position and the bilinear blend in float32, 16 outputs of a row at a time
// with FMAs (x * M0 + (y * M1 + M2)), and the row's tail with
// fma(x, M0, y * M1) + M2; a tap outside the image reads fill. The blend is
// p00 + a (p01 - p00) per row, then the rows by b, fused, rounded half to
// even.
void warp_affine_u8_c3(const uint8_t* src, int h, int w, uint8_t* dst,
                       int dh, int dw, const float* M, int fill) {
  const int vec_end = dw / 16 * 16;
  const float ffill = (float)fill;
  for (int y = 0; y < dh; ++y) {
    const float fy = (float)y;
    const float mx = fy * M[1] + M[2], my = fy * M[4] + M[5];
    const float tx = fy * M[1], ty = fy * M[4];
    uint8_t* d = dst + (size_t)y * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const float fx = (float)x;
      float sx, sy;
      if (x < vec_end) {
        sx = std::fmaf(fx, M[0], mx);
        sy = std::fmaf(fx, M[3], my);
      } else {
        sx = std::fmaf(fx, M[0], tx) + M[2];
        sy = std::fmaf(fx, M[3], ty) + M[5];
      }
      const float flx = std::floor(sx), fly = std::floor(sy);
      const int ix = (int)flx, iy = (int)fly;
      const float a = sx - flx, b = sy - fly;
      const bool x0 = ix >= 0 && ix < w, x1 = ix + 1 >= 0 && ix + 1 < w;
      const bool y0 = iy >= 0 && iy < h, y1 = iy + 1 >= 0 && iy + 1 < h;
      const long long o00 = ((long long)iy * w + ix) * 3, o10 = o00 + (long long)w * 3;
      for (int c = 0; c < 3; ++c) {
        const float p00 = (y0 && x0) ? src[o00 + c] : ffill;
        const float p01 = (y0 && x1) ? src[o00 + 3 + c] : ffill;
        const float p10 = (y1 && x0) ? src[o10 + c] : ffill;
        const float p11 = (y1 && x1) ? src[o10 + 3 + c] : ffill;
        const float v0 = std::fmaf(a, p01 - p00, p00);
        const float v1 = std::fmaf(a, p11 - p10, p10);
        const float v = std::fmaf(b, v1 - v0, v0);
        const int iv = (int)std::nearbyint(v);
        d[x * 3 + c] = (uint8_t)std::min(std::max(iv, 0), 255);
      }
    }
  }
}

#pragma GCC pop_options

}  // extern "C"
