// Device helpers shared by the plane-sweep kernels (fused_costvol.cu,
// fused_costvol_bwd.cu, sweep_sampler.cu): 8-channel vector loads and
// stores in fp32 or bf16, the projection of a reference pixel through the
// relative homography, and the 4-tap zero-padded bilinear sample. One copy,
// so every kernel evaluates the same expressions in the same order and
// picks the same taps.
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

// (px, py): where reference pixel (xf, yf) at depth `depth` lands in the
// source image, through the 12-float relative homography g (rot row-major,
// then trans) and the grid round trip px = u * sx + ox, py = v * sy + oy.
__device__ __forceinline__ void project(const float* g, float xf, float yf, float depth,
                                        float sx, float ox, float sy, float oy,
                                        float& px, float& py) {
  const float nx = (g[0] * xf + (g[1] * yf + g[2])) * depth + g[9];
  const float ny = (g[3] * xf + (g[4] * yf + g[5])) * depth + g[10];
  const float nz = (g[6] * xf + (g[7] * yf + g[8])) * depth + g[11];
  px = nx / nz * sx + ox;
  py = ny / nz * sy + oy;
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
// (px, py), in fp32. Bounds are tested in float before any cast to int: a
// non-finite or huge coordinate samples to zero and never wraps into a
// valid index (the comparisons are false for NaN).
template <typename T, int C>
__device__ __forceinline__ void bilinear_zeros(const T* base, float px, float py, int H,
                                               int W, float* out) {
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = 0.f;
  if (px > -1.f && px < (float)W && py > -1.f && py < (float)H) {
    const float x0f = floorf(px), y0f = floorf(py);
    const float wx = px - x0f, wy = py - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
    const bool xa = x0 >= 0, xb = x0 + 1 <= W - 1;
    const bool ya = y0 >= 0, yb = y0 + 1 <= H - 1;
    if (ya && xa) accum_tap<T, C>(base + ((long long)y0 * W + x0) * C, (1.f - wx) * (1.f - wy), out);
    if (ya && xb) accum_tap<T, C>(base + ((long long)y0 * W + x0 + 1) * C, wx * (1.f - wy), out);
    if (yb && xa) accum_tap<T, C>(base + ((long long)(y0 + 1) * W + x0) * C, (1.f - wx) * wy, out);
    if (yb && xb) accum_tap<T, C>(base + ((long long)(y0 + 1) * W + x0 + 1) * C, wx * wy, out);
  }
}

}  // namespace sweep
