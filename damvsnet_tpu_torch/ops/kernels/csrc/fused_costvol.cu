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
#include "sampling.cuh"

namespace {

using sweep::load8;
using sweep::store8;

constexpr int kMaxViews = 16;

struct SrcPtrs {
  const void* p[kMaxViews];
};

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
    float px, py;
    sweep::project(geom + ((long long)v * B + b) * 12, xf, yf, depth, sx, ox, sy, oy, px, py);
    float warp[C];
    sweep::bilinear_zeros<T, C>(reinterpret_cast<const T*>(src.p[v]) + b * src_bstride,
                                px, py, H, W, warp);

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
