// Device helpers shared by the plane-sweep kernels (fused_costvol.cu,
// fused_costvol_bwd.cu, sweep_sampler.cu): 16-byte channel pieces and
// 8-channel vectors in fp32 or bf16, the projection of a reference pixel
// through the relative homography (split into a per-pixel ray and a
// per-depth step), and the choice of the 4 zero-padded bilinear taps. One
// copy, so every kernel evaluates the same expressions in the same order
// and picks the same taps.
//
// Offsets inside one [H, W, C] plane are 32-bit: the wrappers check that
// H * W * C < 2^31.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sweep {

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// one rounding to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  reinterpret_cast<uint4*>(p)[0] = raw;
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

// N = 4 or 8 channels into fp32
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float* out) {
  static_assert(N == 4 || N == 8, "4 or 8 channels");
  if constexpr (N == 8)
    load8(p, out);
  else
    load4(p, out);
}

// A 16-byte piece of a C-vector: kPiece<T> channels (4 fp32 or 8 bf16).
// A lane that owns one piece loads (load_n<kPiece<T>>) and stores it in one
// instruction, and the lanes of one pixel cover its C-vector contiguously.
template <typename T>
constexpr int kPiece = 16 / (int)sizeof(T);

__device__ __forceinline__ void store_piece(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_piece(__nv_bfloat16* p, const float* v) { store8(p, v); }

// The projection of reference pixel (xf, yf) through the 12-float relative
// homography g (rot row-major, then trans), in two parts: the ray
// r = rot * [xf, yf, 1], once per pixel and view, then for each depth
// (px, py) = where the pixel lands in the source image, with the grid round
// trip px = u * sx + ox, py = v * sy + oy.
__device__ __forceinline__ void project_ray(const float* g, float xf, float yf, float* r) {
  r[0] = g[0] * xf + (g[1] * yf + g[2]);
  r[1] = g[3] * xf + (g[4] * yf + g[5]);
  r[2] = g[6] * xf + (g[7] * yf + g[8]);
}

__device__ __forceinline__ void project_depth(const float* r, const float* trans, float depth,
                                              float sx, float ox, float sy, float oy,
                                              float& px, float& py) {
  const float nx = r[0] * depth + trans[0];
  const float ny = r[1] * depth + trans[1];
  const float nz = r[2] * depth + trans[2];
  px = nx / nz * sx + ox;
  py = ny / nz * sy + oy;
}

__device__ __forceinline__ void project(const float* g, float xf, float yf, float depth,
                                        float sx, float ox, float sy, float oy,
                                        float& px, float& py) {
  float r[3];
  project_ray(g, xf, yf, r);
  project_depth(r, g + 9, depth, sx, ox, sy, oy, px, py);
}

// The 4 zero-padded bilinear taps of (px, py) in an H x W plane: tap k is
// pixel (x0 + (k & 1), y0 + (k >> 1)) with weight wt[k], present where bit
// k of `ok` is set. Bounds are tested in float before any cast to int: a
// non-finite or huge coordinate has no tap and never wraps into a valid
// index (the comparisons are false for NaN).
struct Taps {
  int x0, y0;
  float wt[4];
  unsigned ok;
};

__device__ __forceinline__ Taps bilinear_taps(float px, float py, int H, int W) {
  Taps t;
  t.x0 = t.y0 = 0;
  t.ok = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) t.wt[k] = 0.f;
  if (px > -1.f && px < (float)W && py > -1.f && py < (float)H) {
    const float x0f = floorf(px), y0f = floorf(py);
    const float wx = px - x0f, wy = py - y0f;
    t.x0 = (int)x0f;
    t.y0 = (int)y0f;
    const bool xa = t.x0 >= 0, xb = t.x0 + 1 <= W - 1;
    const bool ya = t.y0 >= 0, yb = t.y0 + 1 <= H - 1;
    t.wt[0] = (1.f - wx) * (1.f - wy);
    t.wt[1] = wx * (1.f - wy);
    t.wt[2] = (1.f - wx) * wy;
    t.wt[3] = wx * wy;
    t.ok = (ya && xa ? 1u : 0u) | (ya && xb ? 2u : 0u) | (yb && xa ? 4u : 0u) |
           (yb && xb ? 8u : 0u);
  }
  return t;
}

// the pixel index y * W + x of tap k (valid where bit k of t.ok is set)
__device__ __forceinline__ int tap_pixel(const Taps& t, int k, int W) {
  return (t.y0 + (k >> 1)) * W + t.x0 + (k & 1);
}

// out[c] += wt * p[c] for one tap's contiguous C-vector
template <typename T, int C>
__device__ __forceinline__ void accum_tap(const T* p, float wt, float* out) {
#pragma unroll
  for (int k = 0; k < C; k += 8) {
    float v[8];
    load8(p + k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[k + j] = fmaf(wt, v[j], out[k + j]);
  }
}

// out[C] = the zero-padded bilinear sample of the [H, W, C] plane `base` at
// (px, py), in fp32, the taps added in order 0..3.
template <typename T, int C>
__device__ __forceinline__ void bilinear_zeros(const T* base, float px, float py, int H,
                                               int W, float* out) {
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = 0.f;
  const Taps t = bilinear_taps(px, py, H, W);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (t.ok & (1u << k)) accum_tap<T, C>(base + tap_pixel(t, k, W) * C, t.wt[k], out);
}

}  // namespace sweep
