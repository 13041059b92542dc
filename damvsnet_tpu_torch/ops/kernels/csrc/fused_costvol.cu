// Fused adaptive cost volume for Hopper (sm_90a).
//
// Replaces the TPU kernel damvsnet_tpu/ops/pallas/fused_costvol.py
// (fused_adaptive_cost_volume, kernel body _kernel): for every output voxel
// (b, d, y, x) and every source view v
//
//     (px, py)  = project (x, y) at depth dv through the view's 12-float
//                 relative homography [rot row-major | trans], then the
//                 reference's grid normalization px = u * sx + ox
//     warp_v    = 4-tap zero-padded bilinear sample of src_v (C channels)
//     d2_v      = (ref - warp_v)^2
//     w_v       = relu(w2 * relu(<w1, d2_v> + b1) + b2)   (folded AggWeightNet)
//     out       = sum_v (w_v + 1) * d2_v * 1/(N-1)
//
// The TPU kernel's band DMA windows, two-tier repair pass and x-subtiles
// exist only because the TPU has no fast gather; here every tap is gathered
// directly, so nothing can overflow and there is no overflow flag.
//
// Design: one thread per output voxel. The thread loads the reference
// C-vector once, keeps d2[C] and acc[C] in fp32 registers (C <= 32), loops
// over the source views, gathers each tap as one contiguous C-vector from
// channels-last source features with 16-byte loads, and writes one
// contiguous C-vector in the feature dtype. Accumulation is fp32 whatever
// the feature dtype.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): the output is the dominant byte stream (stage 1 at 1152x864:
// 64*216*288*32 bf16 = 255 MB plus 20 MB of features, 0.082 ms); the
// gathered source rows of neighbouring threads overlap and stay in L1/L2.
// The fp32 arithmetic is about (14*C + 60) operations per voxel and view,
// 8.2 GFLOP at stage 1 (0.123 ms), so in bf16 the kernel is bound by
// operations at every stage, in fp32 by bytes. chip_smoke.py computes both
// bounds from each run's shapes; on an H100 80GB HBM3 at 700 W it measured
// 1.06 / 1.29 / 0.86 ms for stages 1/2/3 in bf16 against bounds of
// 0.123 / 0.137 / 0.083 ms: the thread per voxel re-gathers the same taps
// for every hypothesis, which a later version can share.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxViews = 16;

struct SrcPtrs {
  const void* p[kMaxViews];
};

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

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  reinterpret_cast<uint4*>(p)[0] = raw;
}

// warp[c] += wt * src[c] for one tap's contiguous C-vector
template <typename T, int C>
__device__ __forceinline__ void accum_tap(const T* p, float wt, float* warp) {
#pragma unroll
  for (int k = 0; k < C; k += 8) {
    float v[8];
    load8(p + k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) warp[k + j] = fmaf(wt, v[j], warp[k + j]);
  }
}

// params: w1[C], then b1, w2, b2, 1/(N-1)
template <typename T, int C>
__global__ void __launch_bounds__(128)
fused_costvol_kernel(const T* __restrict__ ref, long long ref_bstride,
                     SrcPtrs src, long long src_bstride, int V,
                     const float* __restrict__ geom,    // [V, B, 12]
                     const float* __restrict__ dv,      // [B, D] or [B, D, H, W]
                     int dv_per_pixel,
                     const float* __restrict__ params,  // [C + 4]
                     T* __restrict__ out,               // [B, D, H, W, C]
                     int B, int D, int H, int W,
                     float sx, float ox, float sy, float oy) {
  const long long n = (long long)B * D * H * W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const int d = (int)((i / ((long long)W * H)) % D);
  const int b = (int)(i / ((long long)W * H * D));

  const float depth = dv_per_pixel ? dv[i] : dv[(long long)b * D + d];
  const long long pix = (long long)y * W + x;

  float refv[C];
#pragma unroll
  for (int k = 0; k < C; k += 8) load8(ref + b * ref_bstride + pix * C + k, refv + k);

  const float b1 = params[C], w2 = params[C + 1], b2 = params[C + 2];
  const float inv_nm1 = params[C + 3];
  const float xf = (float)x, yf = (float)y;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  for (int v = 0; v < V; ++v) {
    const float* g = geom + ((long long)v * B + b) * 12;
    const float nx = (g[0] * xf + (g[1] * yf + g[2])) * depth + g[9];
    const float ny = (g[3] * xf + (g[4] * yf + g[5])) * depth + g[10];
    const float nz = (g[6] * xf + (g[7] * yf + g[8])) * depth + g[11];
    const float px = nx / nz * sx + ox;
    const float py = ny / nz * sy + oy;

    float warp[C];
#pragma unroll
    for (int c = 0; c < C; ++c) warp[c] = 0.f;
    // bounds are tested in float before any cast to int: a non-finite or
    // huge coordinate samples to zero and never wraps into a valid index
    // (isfinite is implied by the comparisons, which are false for NaN)
    if (px > -1.f && px < (float)W && py > -1.f && py < (float)H) {
      const float x0f = floorf(px), y0f = floorf(py);
      const float wx = px - x0f, wy = py - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
      const T* base = reinterpret_cast<const T*>(src.p[v]) + b * src_bstride;
      const bool xa = x0 >= 0, xb = x0 + 1 <= W - 1;
      const bool ya = y0 >= 0, yb = y0 + 1 <= H - 1;
      if (ya && xa) accum_tap<T, C>(base + ((long long)y0 * W + x0) * C, (1.f - wx) * (1.f - wy), warp);
      if (ya && xb) accum_tap<T, C>(base + ((long long)y0 * W + x0 + 1) * C, wx * (1.f - wy), warp);
      if (yb && xa) accum_tap<T, C>(base + ((long long)(y0 + 1) * W + x0) * C, (1.f - wx) * wy, warp);
      if (yb && xb) accum_tap<T, C>(base + ((long long)(y0 + 1) * W + x0 + 1) * C, wx * wy, warp);
    }

    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float df = refv[c] - warp[c];
      warp[c] = df * df;  // warp now holds d2
      s = fmaf(warp[c], params[c], s);
    }
    const float wgt = fmaxf(w2 * fmaxf(s + b1, 0.f) + b2, 0.f) + 1.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = fmaf(wgt, warp[c], acc[c]);
  }

#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] *= inv_nm1;
  T* o = out + i * C;
#pragma unroll
  for (int k = 0; k < C; k += 8) store8(o + k, acc + k);
}

template <typename T, int C>
cudaError_t launch(const void* ref, long long ref_bstride, const SrcPtrs& src,
                   long long src_bstride, int V, const float* geom, const float* dv,
                   int dv_per_pixel, const float* params, void* out, int B, int D,
                   int H, int W, float sx, float ox, float sy, float oy,
                   cudaStream_t stream) {
  const long long n = (long long)B * D * H * W;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  fused_costvol_kernel<T, C><<<(unsigned)blocks, threads, 0, stream>>>(
      reinterpret_cast<const T*>(ref), ref_bstride, src, src_bstride, V, geom, dv,
      dv_per_pixel, params, reinterpret_cast<T*>(out), B, D, H, W, sx, ox, sy, oy);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_c(int C, const void* ref, long long ref_bstride, const SrcPtrs& src,
                       long long src_bstride, int V, const float* geom, const float* dv,
                       int dv_per_pixel, const float* params, void* out, int B, int D,
                       int H, int W, float sx, float ox, float sy, float oy,
                       cudaStream_t stream) {
  switch (C) {
    case 8:
      return launch<T, 8>(ref, ref_bstride, src, src_bstride, V, geom, dv, dv_per_pixel,
                          params, out, B, D, H, W, sx, ox, sy, oy, stream);
    case 16:
      return launch<T, 16>(ref, ref_bstride, src, src_bstride, V, geom, dv, dv_per_pixel,
                           params, out, B, D, H, W, sx, ox, sy, oy, stream);
    case 32:
      return launch<T, 32>(ref, ref_bstride, src, src_bstride, V, geom, dv, dv_per_pixel,
                           params, out, B, D, H, W, sx, ox, sy, oy, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// src_ptrs is a HOST array of V device pointers, one [H, W, C] plane per
// (view, batch) at src_ptrs[v] + b * src_bstride elements. Returns the
// launch's cudaGetLastError() (cudaErrorInvalidValue for an unsupported
// C, V or dtype).
extern "C" int fused_costvol_launch(const void* ref, long long ref_bstride,
                                    const void* const* src_ptrs, long long src_bstride,
                                    int V, const float* geom, const float* dv,
                                    int dv_per_pixel, const float* params, void* out,
                                    int B, int D, int H, int W, int C, int dtype,
                                    float sx, float ox, float sy, float oy,
                                    void* stream) {
  if (V < 1 || V > kMaxViews) return (int)cudaErrorInvalidValue;
  SrcPtrs src;
  for (int v = 0; v < kMaxViews; ++v) src.p[v] = v < V ? src_ptrs[v] : nullptr;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_c<float>(C, ref, ref_bstride, src, src_bstride, V, geom, dv,
                            dv_per_pixel, params, out, B, D, H, W, sx, ox, sy, oy, s);
  else if (dtype == 1)
    err = dispatch_c<__nv_bfloat16>(C, ref, ref_bstride, src, src_bstride, V, geom, dv,
                                    dv_per_pixel, params, out, B, D, H, W, sx, ox, sy,
                                    oy, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
