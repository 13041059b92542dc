// Backward of the fused adaptive cost volume (K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel damvsnet_tpu/ops/pallas/fused_costvol_vjp.py
// (_kernel_bwd through _fused_backward, the VJP of the training path). With
// the forward of csrc/fused_costvol.cu per voxel (b, d, y, x) and view v
//
//     diff = ref - warp_v,  d2 = diff^2,  s = <w1, d2>,  r = relu(s + b1)
//     g = w2 * r + b2,      w = relu(g),  out = sum_v (w + 1) * d2 * inv
//
// and the cotangent ct of out (q = <ct, d2>), it computes
//
//     dL/dd2_c = inv * [ct_c * (w + 1) + q * 1[g>0] * w2 * 1[s+b1>0] * w1_c]
//     dref     = + 2 * diff * dL/dd2,  summed over d and v
//     dsrc_v   = - 2 * diff * dL/dd2,  scattered through the forward's four
//                zero-padded bilinear taps with the forward's tap weights
//     dw1_c = sum ds * d2_c,  db1 = sum ds,  dw2 = sum qg * r,  db2 = sum qg
//                (qg = q * inv * 1[g>0], ds = qg * w2 * 1[s+b1>0]),
//                summed over every voxel and view.
//
// Depth hypotheses and geometry get no gradient (the reference builds its
// sampling grid under no_grad), nor does inv = 1/(N-1).
//
// The TPU kernel's band DMAs, read-modify-write band accumulation and
// backward overflow flag exist because a TPU grid runs in order and cannot
// gather. Here every tap is gathered and scattered directly: nothing can
// overflow.
//
// Design: one thread per reference pixel (b, y, x), looping over the
// hypotheses d and, inside, the views v. The thread recomputes the
// forward's taps, diff and weight in fp32 registers (the same projection
// code as the forward, so both pick the same taps), reads the cotangent
// C-vector twice (the second read hits L1), accumulates dref in registers
// and writes it once (no atomics on dref), and adds the source gradient
// into an fp32 [V, B, H, W, C] buffer that the wrapper zeroes, four
// channels per 16-byte vector atomic. The weight-net partials stay in
// registers, are reduced over the block (warp shuffles, then shared
// memory) and added with one atomic per value per block into an fp32
// [C + 3] buffer. Everything is fp32 whatever the feature dtype; the
// wrapper casts dref and dsrc to the feature dtype.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores), training stage 1 (B=4, V=4, D=64, 128x160, C=32, bf16): the
// cotangent is the dominant byte stream (335 MB; 413 MB with the features
// and the fp32 gradients, 0.12 ms); the fp32 arithmetic is about
// (14C + 60) operations per voxel and view to recompute the forward plus
// about 14C + 10 for the backward (the 4 taps' scatter included), 20 GFLOP
// (0.30 ms). So the kernel is bound by operations at C=32, before any cost
// of the atomics; chip_smoke.py computes both bounds from each run's
// shapes and measures the kernel beside them.
#include "sampling.cuh"

namespace {

using sweep::load8;
using sweep::store8;

constexpr int kMaxViews = 16;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct SrcPtrs {
  const void* p[kMaxViews];
};

// p[0..3] += (a, b, c, d); p is 16-byte aligned (C is a multiple of 8)
__device__ __forceinline__ void atomic_add4(float* p, float a, float b, float c, float d) {
#if CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
#else
  atomicAdd(p, a);
  atomicAdd(p + 1, b);
  atomicAdd(p + 2, c);
  atomicAdd(p + 3, d);
#endif
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The forward's four zero-padded bilinear taps of (px, py): element offsets
// of the tap's C-vector in the [H, W, C] plane (-1: no tap) and weights.
// Identical tests to sweep::bilinear_zeros (sampling.cuh), so forward and
// backward pick the same taps; bounds are tested in float before any cast
// to int.
struct Taps {
  long long off[4];
  float wt[4];
};

template <int C>
__device__ __forceinline__ Taps make_taps(float px, float py, int H, int W) {
  Taps t;
#pragma unroll
  for (int k = 0; k < 4; ++k) { t.off[k] = -1; t.wt[k] = 0.f; }
  if (px > -1.f && px < (float)W && py > -1.f && py < (float)H) {
    const float x0f = floorf(px), y0f = floorf(py);
    const float wx = px - x0f, wy = py - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
    const bool xa = x0 >= 0, xb = x0 + 1 <= W - 1;
    const bool ya = y0 >= 0, yb = y0 + 1 <= H - 1;
    if (ya && xa) { t.off[0] = ((long long)y0 * W + x0) * C; t.wt[0] = (1.f - wx) * (1.f - wy); }
    if (ya && xb) { t.off[1] = ((long long)y0 * W + x0 + 1) * C; t.wt[1] = wx * (1.f - wy); }
    if (yb && xa) { t.off[2] = ((long long)(y0 + 1) * W + x0) * C; t.wt[2] = (1.f - wx) * wy; }
    if (yb && xb) { t.off[3] = ((long long)(y0 + 1) * W + x0 + 1) * C; t.wt[3] = wx * wy; }
  }
  return t;
}

// params: w1[C], then b1, w2, b2, 1/(N-1). dparams: dw1[C], db1, dw2, db2.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
fused_costvol_bwd_kernel(const T* __restrict__ ref, long long ref_bstride,
                         SrcPtrs src, long long src_bstride, int V,
                         const float* __restrict__ geom,    // [V, B, 12]
                         const float* __restrict__ dv,      // [B, D] or [B, D, H, W]
                         int dv_per_pixel,
                         const float* __restrict__ params,  // [C + 4]
                         const T* __restrict__ cot,         // [B, D, H, W, C]
                         float* __restrict__ dref,          // [B, H, W, C]
                         float* __restrict__ dsrc,          // [V, B, H, W, C], zeroed
                         float* __restrict__ dparams,       // [C + 3], zeroed
                         int B, int D, int H, int W,
                         float sx, float ox, float sy, float oy) {
  __shared__ float red[kWarps][C + 3];
  const long long npix = (long long)B * H * W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  float dw1[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dw1[c] = 0.f;
  float db1 = 0.f, dw2 = 0.f, db2 = 0.f;

  if (i < npix) {  // no early return: every thread joins the block reduction
    const int x = (int)(i % W);
    const int y = (int)((i / W) % H);
    const int b = (int)(i / ((long long)W * H));
    const long long pix = (long long)y * W + x;
    const long long plane = (long long)H * W * C;
    const T* refp = ref + b * ref_bstride + pix * C;
    const float b1 = params[C], w2 = params[C + 1], b2 = params[C + 2];
    const float inv_nm1 = params[C + 3];
    const float xf = (float)x, yf = (float)y;

    float gref[C];
#pragma unroll
    for (int c = 0; c < C; ++c) gref[c] = 0.f;

    for (int d = 0; d < D; ++d) {
      const float depth = dv_per_pixel ? dv[((long long)b * D + d) * H * W + pix]
                                       : dv[(long long)b * D + d];
      const T* ctp = cot + (((long long)b * D + d) * H * W + pix) * C;
      for (int v = 0; v < V; ++v) {
        const float* g = geom + ((long long)v * B + b) * 12;
        float px, py;
        sweep::project(g, xf, yf, depth, sx, ox, sy, oy, px, py);
        const Taps t = make_taps<C>(px, py, H, W);
        const T* base = reinterpret_cast<const T*>(src.p[v]) + b * src_bstride;

        float diff[C];  // the warp, then diff, then dL/dwarp
#pragma unroll
        for (int c = 0; c < C; ++c) diff[c] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (t.off[k] < 0) continue;
#pragma unroll
          for (int c0 = 0; c0 < C; c0 += 8) {
            float s8[8];
            load8(base + t.off[k] + c0, s8);
#pragma unroll
            for (int j = 0; j < 8; ++j) diff[c0 + j] = fmaf(t.wt[k], s8[j], diff[c0 + j]);
          }
        }

        // pass 1: diff, s = <w1, d2>, q = <ct, d2>
        float s = 0.f, q = 0.f;
#pragma unroll
        for (int c0 = 0; c0 < C; c0 += 8) {
          float r8[8], ct8[8];
          load8(refp + c0, r8);
          load8(ctp + c0, ct8);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float df = r8[j] - diff[c0 + j];
            diff[c0 + j] = df;
            const float d2 = df * df;
            s = fmaf(d2, params[c0 + j], s);
            q = fmaf(ct8[j], d2, q);
          }
        }
        const float r1 = s + b1;
        const float relu1 = fmaxf(r1, 0.f);
        const float gpre = w2 * relu1 + b2;
        const float wgt1 = fmaxf(gpre, 0.f) + 1.f;
        const float qg = gpre > 0.f ? q * inv_nm1 : 0.f;  // dL/dg
        const float ds = r1 > 0.f ? qg * w2 : 0.f;          // dL/ds
        db2 += qg;
        dw2 += qg * relu1;
        db1 += ds;

        // pass 2: dL/dd2, dref, dw1, and dL/dwarp into diff
        const float ctw = inv_nm1 * wgt1;
#pragma unroll
        for (int c0 = 0; c0 < C; c0 += 8) {
          float ct8[8];
          load8(ctp + c0, ct8);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = c0 + j;
            const float df = diff[c];
            dw1[c] = fmaf(df * df, ds, dw1[c]);
            const float dd2 = fmaf(ds, params[c], ct8[j] * ctw);
            const float ddiff = 2.f * df * dd2;
            gref[c] += ddiff;
            diff[c] = -ddiff;
          }
        }

        float* dbase = dsrc + ((long long)v * B + b) * plane;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (t.off[k] < 0) continue;
          const float wt = t.wt[k];
          float* p = dbase + t.off[k];
#pragma unroll
          for (int c = 0; c < C; c += 4)
            atomic_add4(p + c, wt * diff[c], wt * diff[c + 1], wt * diff[c + 2], wt * diff[c + 3]);
        }
      }
    }
    float* o = dref + i * C;
#pragma unroll
    for (int c0 = 0; c0 < C; c0 += 8) store8(o + c0, gref + c0);
  }

  // block reduction of the weight-net partials, one atomic per value
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float r = warp_sum(dw1[c]);
    if (lane == 0) red[warp][c] = r;
  }
  {
    const float r0 = warp_sum(db1), r1 = warp_sum(dw2), r2 = warp_sum(db2);
    if (lane == 0) {
      red[warp][C] = r0;
      red[warp][C + 1] = r1;
      red[warp][C + 2] = r2;
    }
  }
  __syncthreads();
  if (threadIdx.x < C + 3) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][threadIdx.x];
    atomicAdd(dparams + threadIdx.x, sum);
  }
}

template <typename T, int C>
cudaError_t launch(const void* ref, long long ref_bstride, const SrcPtrs& src,
                   long long src_bstride, int V, const float* geom, const float* dv,
                   int dv_per_pixel, const float* params, const void* cot, float* dref,
                   float* dsrc, float* dparams, int B, int D, int H, int W, float sx,
                   float ox, float sy, float oy, cudaStream_t stream) {
  const long long npix = (long long)B * H * W;
  const long long blocks = (npix + kThreads - 1) / kThreads;
  fused_costvol_bwd_kernel<T, C><<<(unsigned)blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const T*>(ref), ref_bstride, src, src_bstride, V, geom, dv,
      dv_per_pixel, params, reinterpret_cast<const T*>(cot), dref, dsrc, dparams, B, D,
      H, W, sx, ox, sy, oy);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_c(int C, const void* ref, long long ref_bstride, const SrcPtrs& src,
                       long long src_bstride, int V, const float* geom, const float* dv,
                       int dv_per_pixel, const float* params, const void* cot, float* dref,
                       float* dsrc, float* dparams, int B, int D, int H, int W, float sx,
                       float ox, float sy, float oy, cudaStream_t stream) {
  switch (C) {
    case 8:
      return launch<T, 8>(ref, ref_bstride, src, src_bstride, V, geom, dv, dv_per_pixel,
                          params, cot, dref, dsrc, dparams, B, D, H, W, sx, ox, sy, oy,
                          stream);
    case 16:
      return launch<T, 16>(ref, ref_bstride, src, src_bstride, V, geom, dv, dv_per_pixel,
                           params, cot, dref, dsrc, dparams, B, D, H, W, sx, ox, sy, oy,
                           stream);
    case 32:
      return launch<T, 32>(ref, ref_bstride, src, src_bstride, V, geom, dv, dv_per_pixel,
                           params, cot, dref, dsrc, dparams, B, D, H, W, sx, ox, sy, oy,
                           stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16
// (of ref, the sources and the cotangent). src_ptrs is a HOST array of V
// device pointers, one [H, W, C] plane per (view, batch) at src_ptrs[v] +
// b * src_bstride elements. dsrc and dparams must be zeroed by the caller.
// Returns the launch's cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported C, V or dtype).
extern "C" int fused_costvol_bwd_launch(const void* ref, long long ref_bstride,
                                        const void* const* src_ptrs, long long src_bstride,
                                        int V, const float* geom, const float* dv,
                                        int dv_per_pixel, const float* params,
                                        const void* cot, float* dref, float* dsrc,
                                        float* dparams, int B, int D, int H, int W, int C,
                                        int dtype, float sx, float ox, float sy, float oy,
                                        void* stream) {
  if (V < 1 || V > kMaxViews) return (int)cudaErrorInvalidValue;
  SrcPtrs src;
  for (int v = 0; v < kMaxViews; ++v) src.p[v] = v < V ? src_ptrs[v] : nullptr;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_c<float>(C, ref, ref_bstride, src, src_bstride, V, geom, dv, dv_per_pixel,
                            params, cot, dref, dsrc, dparams, B, D, H, W, sx, ox, sy, oy, s);
  else if (dtype == 1)
    err = dispatch_c<__nv_bfloat16>(C, ref, ref_bstride, src, src_bstride, V, geom, dv,
                                    dv_per_pixel, params, cot, dref, dsrc, dparams, B, D, H,
                                    W, sx, ox, sy, oy, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
