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

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

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

}  // extern "C"
