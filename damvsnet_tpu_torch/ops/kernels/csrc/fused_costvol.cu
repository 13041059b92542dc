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
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): the output is the dominant byte stream (stage 1 at 1152x864:
// 64*216*288*32 bf16 = 255 MB plus 20 MB of features, 0.082 ms); the fp32
// arithmetic is about (14*C + 60) operations per voxel and view, 8.2 GFLOP
// at stage 1 (0.123 ms), so in bf16 the kernel is bound by operations at
// every stage, in fp32 by bytes. chip_smoke.py computes both bounds from
// each run's shapes.
//
// What held the first version back (one thread per voxel, 1.06 / 1.29 /
// 0.86 ms per serving stage in bf16 on an H100 80GB HBM3 at 700 W against
// bounds of 0.123 / 0.137 / 0.083): a thread gathered each tap as C*elem/16
// separate 16-byte loads 64 bytes apart from its neighbours' (a quarter of
// each L1 wavefront used), stored its C-vector the same way, and redid per
// voxel what belongs to its pixel: the reference C-vector, the 12 geometry
// floats and rot * [x, y, 1] of every view, and 64-bit tap offsets.
//
// Design: the C-vector of a voxel is split across L = C / kPiece lanes, one
// 16-byte piece each (8 bf16 or 4 fp32 channels), so a warp's gathers and
// stores cover neighbouring voxels' contiguous C-vectors; <w1, d2> is
// reduced over the L lanes with xor shuffles (every lane gets the same
// sum, so the lanes agree on the weight). A block holds kThreads / L
// pixels of one batch element; a lane group owns one pixel and a run of
// kRun hypotheses. The block computes each pixel's ray rot * [x, y, 1] per
// view once, into shared memory, beside the views' translations; the
// reference piece and the w1 piece stay in registers over the run. Offsets
// inside a plane are 32-bit (the wrapper checks H * W * C < 2^31); the next
// hypothesis' depth is loaded a step ahead. Accumulation is fp32 whatever
// the feature dtype, rounded once. Measured on that card
// (scripts/ab_kernels_torch.py, device time alone, bf16): 0.59 / 0.65 /
// 0.61 ms per serving stage against the first version's 0.83 / 1.13 /
// 0.66; still 4.8 / 4.8 / 7.4x its bound, stage 3 (C = 8, one lane a
// pixel, D = 8) gaining least.
#include "common.cuh"
#include "sampling.cuh"

namespace {

using sweep::kPiece;

constexpr int kThreads = 128;
constexpr int kRun = 8;  // hypotheses per lane group

// params: w1[C], then b1, w2, b2, 1/(N-1)
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
fused_costvol_kernel(const T* __restrict__ ref, long long ref_bstride,
                     SrcPtrs src, long long src_bstride, int V,
                     const float* __restrict__ geom,    // [V, B, 12]
                     const float* __restrict__ dv,      // [B, D] or [B, D, H, W]
                     int dv_per_pixel,
                     const float* __restrict__ params,  // [C + 4]
                     T* __restrict__ out,               // [B, D, H, W, C]
                     int B, int D, int H, int W,
                     float sx, float ox, float sy, float oy) {
  constexpr int K = kPiece<T>;
  constexpr int L = C / K;          // lanes per pixel
  constexpr int P = kThreads / L;   // pixels per block
  __shared__ float ray[kMaxViews][3][P];
  __shared__ float trans[kMaxViews][3];
  __shared__ const T* srcs[kMaxViews];

  const int b = blockIdx.y;
  const int HW = H * W;
  const int lp = threadIdx.x / L, piece = threadIdx.x % L, c0 = piece * K;
  const int pix = blockIdx.x * P + lp;
  const bool live = pix < HW;
  const int y = live ? pix / W : 0, x = live ? pix - y * W : 0;

  // per pixel and view, once: the lanes of a pixel split the views
  for (int v = piece; v < V; v += L) {
    float r[3];
    sweep::project_ray(geom + ((long long)v * B + b) * 12, (float)x, (float)y, r);
    ray[v][0][lp] = r[0];
    ray[v][1][lp] = r[1];
    ray[v][2][lp] = r[2];
  }
  // constant indices: a dynamic index into the parameter struct would copy
  // it to the stack
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v)
    if (threadIdx.x == v && v < V) srcs[v] = reinterpret_cast<const T*>(src.p[v]) + b * src_bstride;
  if (threadIdx.x < 3 * V)
    trans[threadIdx.x / 3][threadIdx.x % 3] =
        geom[((long long)(threadIdx.x / 3) * B + b) * 12 + 9 + threadIdx.x % 3];
  __syncthreads();

  float refv[K], w1[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    refv[j] = 0.f;
    w1[j] = params[c0 + j];
  }
  if (live) sweep::load_n<K>(ref + b * ref_bstride + pix * C + c0, refv);
  const float b1 = params[C], w2 = params[C + 1], b2 = params[C + 2];
  const float inv_nm1 = params[C + 3];

  // the next hypothesis' depth is loaded a step ahead
  auto depth_at = [&](int d) {
    const long long bd = (long long)b * D + d;
    return dv_per_pixel ? (live ? dv[bd * HW + pix] : 1.f) : dv[bd];
  };
  const int d_begin = blockIdx.z * kRun, d_end = min(D, d_begin + kRun);
  float next = depth_at(d_begin);
  for (int d = d_begin; d < d_end; ++d) {
    const long long bd = (long long)b * D + d;
    const float depth = next;
    if (d + 1 < d_end) next = depth_at(d + 1);
    float acc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = 0.f;

    for (int v = 0; v < V; ++v) {
      const float r[3] = {ray[v][0][lp], ray[v][1][lp], ray[v][2][lp]};
      float px, py;
      sweep::project_depth(r, trans[v], depth, sx, ox, sy, oy, px, py);
      const sweep::Taps t = sweep::bilinear_taps(px, py, H, W);
      const T* base = srcs[v] + c0;
      float d2[K];  // the warp, then d2
#pragma unroll
      for (int j = 0; j < K; ++j) d2[j] = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!live || !(t.ok & (1u << k))) continue;
        float s8[K];
        sweep::load_n<K>(base + sweep::tap_pixel(t, k, W) * C, s8);
#pragma unroll
        for (int j = 0; j < K; ++j) d2[j] = fmaf(t.wt[k], s8[j], d2[j]);
      }
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float df = refv[j] - d2[j];
        d2[j] = df * df;
        s = fmaf(d2[j], w1[j], s);
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float wgt = fmaxf(w2 * fmaxf(s + b1, 0.f) + b2, 0.f) + 1.f;
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] = fmaf(wgt, d2[j], acc[j]);
    }

#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] *= inv_nm1;
    if (live) sweep::store_piece(out + (bd * HW + pix) * C + c0, acc);
  }
}

template <typename T, int C>
cudaError_t launch(const void* ref, long long ref_bstride, const SrcPtrs& src,
                   long long src_bstride, int V, const float* geom, const float* dv,
                   int dv_per_pixel, const float* params, void* out, int B, int D,
                   int H, int W, float sx, float ox, float sy, float oy,
                   cudaStream_t stream) {
  constexpr int P = kThreads / (C / kPiece<T>);
  const dim3 grid((unsigned)((H * W + P - 1) / P), (unsigned)B, (unsigned)((D + kRun - 1) / kRun));
  fused_costvol_kernel<T, C><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const T*>(ref), ref_bstride, src, src_bstride, V, geom, dv,
      dv_per_pixel, params, reinterpret_cast<T*>(out), B, D, H, W, sx, ox, sy, oy);
  return cudaGetLastError();
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
  SrcPtrs src;
  if (!src_planes(src_ptrs, V, src)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)dispatch_dtype_c(dtype, C, [&](auto t, auto c) {
    return launch<typename decltype(t)::type, decltype(c)::value>(
        ref, ref_bstride, src, src_bstride, V, geom, dv, dv_per_pixel, params, out, B, D, H,
        W, sx, ox, sy, oy, s);
  });
}
