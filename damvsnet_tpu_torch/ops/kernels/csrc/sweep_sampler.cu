// Plane-sweep sampler and variance cost volume for Hopper (sm_90a).
//
// Replaces the TPU kernel damvsnet_tpu/ops/pallas/sweep_sampler.py
// (sample_bilinear_band, kernel body _kernel, entry plane_sweep_warp_pallas)
// and, in the variance entry, that sampler together with the elementwise
// epilogue XLA fuses behind it (damvsnet_tpu/ops/costvol.py:63-77). Two
// entry points share one kernel body:
//
//   sweep_sampler_launch: one source view; for every output voxel (b, d, y, x)
//       (px, py) = project (x, y) at depth dv through the view's 12-float
//                  relative homography [rot row-major | trans], then the grid
//                  round trip px = u * sx + ox (align_corners selects sx, ox)
//       out      = 4-tap zero-padded bilinear sample of src (C channels),
//                  rounded once to the source dtype;
//   sweep_variance_launch: the reference and V source views; per voxel, in
//       fp32 registers, with warp_v the fp32 sample of view v (never rounded)
//       s   = ref + sum_v warp_v,  q = ref^2 + sum_v warp_v^2
//       out = q / n - (s / n)^2,  n = V + 1, rounded once to the feature dtype.
//
// The TPU kernel's band DMA windows, hat-function matmuls and overflow flag
// exist only because the TPU has no fast gather; here every tap is gathered
// directly, so nothing can overflow and there is no flag. Projection and
// taps come from sampling.cuh, so K1, K3 and both entries pick the same taps.
//
// What held the first version back (one thread per output voxel: 0.779 /
// 0.665 / 0.476 ms of device time for a serving stage's 4 launches in bf16
// on an H100 80GB HBM3 at 700 W, 25-45 % of the bound): a thread stored its
// whole C-vector as 16-byte pieces C * elem bytes apart from its
// neighbour's (a quarter of each store wavefront used at C = 32 in bf16),
// and redid per voxel what belongs to its pixel (the 12 geometry floats and
// rot * [x, y, 1]); the variance sums then ran as eager fp32 passes over the
// whole volume, once per view.
//
// Design (K1's, fused_costvol.cu): a voxel's C-vector is split across
// L = C / kPiece lanes, one 16-byte piece each, so a warp's gathers and
// stores cover neighbouring voxels' contiguous C-vectors. A block holds
// kThreads / L pixels of one batch element; a lane group owns one pixel and
// a run of kRun hypotheses (grid z). The block computes each pixel's ray
// rot * [x, y, 1] per view once, into shared memory (3 V floats a pixel,
// dynamic), beside the views' translations; the reference piece stays in
// registers over the run. Offsets inside a plane are 32-bit (the wrappers
// check H * W * C < 2^31); the next hypothesis' depth is loaded a step
// ahead. The variance entry gathers every view of a voxel before it writes,
// so the volume is written once and no per-view volume exists. There the L
// lanes of a pixel also split the views' projections: lane l projects views
// l, l + L, ..., and every lane takes a view's tap pixel, weights and mask
// from the lane that projected it (6 shuffles in place of the projection's
// two divisions and the taps' tests, per lane). In the sampler (V = 1) the
// split only idled lanes and was slower, so there each lane projects.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): the sampler moves the output volume (stage 1 at 1152x864:
// 64*216*288*32 bf16 = 255 MB, 0.076 ms) and does ~(8C + 30) operations a
// voxel, so it is bound by bytes. The variance entry writes the same volume
// once and does ~V(10C + 30) + 5C operations a voxel, so in bf16 it is
// bound by operations at stages 1-2 and by bytes at stage 3. chip_smoke.py
// computes both bounds from each run's shapes and measures the kernels
// beside them.
#include "common.cuh"
#include "sampling.cuh"

namespace {

using sweep::kPiece;

constexpr int kThreads = 128;
constexpr int kRun = 8;  // hypotheses per lane group

// kVariance: the variance of {ref, warp_1..warp_V}; else the warp of view 0
// (V == 1, ref unused).
template <typename T, int C, bool kVariance>
__device__ __forceinline__ void sweep_body(const T* __restrict__ ref, long long ref_bstride,
                                           const SrcPtrs& src, long long src_bstride, int V,
                                           const float* __restrict__ geom,  // [V, B, 12]
                                           const float* __restrict__ dv,    // [B, D] or [B, D, H, W]
                                           int dv_per_pixel,
                                           T* __restrict__ out,             // [B, D, H, W, C]
                                           int B, int D, int H, int W,
                                           float sx, float ox, float sy, float oy) {
  constexpr int K = kPiece<T>;
  constexpr int L = C / K;          // lanes per pixel
  constexpr int P = kThreads / L;   // pixels per block
  constexpr int S = kVariance ? L : 1;  // lanes that split a pixel's projections
  extern __shared__ float ray[];    // [V][3][P]
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
#pragma unroll
    for (int k = 0; k < 3; ++k) ray[(v * 3 + k) * P + lp] = r[k];
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

  float refv[K];
#pragma unroll
  for (int j = 0; j < K; ++j) refv[j] = 0.f;
  if constexpr (kVariance) {
    if (live) sweep::load_n<K>(ref + b * ref_bstride + pix * C + c0, refv);
  }
  // x * (1 / n) for x / n: the fp32 divisions and their slow path cost the
  // variance entry 17 % at stage 1 (scripts/ab_kernels_torch.py, H100); the
  // product is within an ulp of the quotient
  const float inv_n = 1.f / (float)(V + 1);

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
    float s[K], q[K];  // the sums; the sampler keeps its warp in s
#pragma unroll
    for (int j = 0; j < K; ++j) {
      s[j] = refv[j];
      q[j] = refv[j] * refv[j];
    }

    // views in groups of S: lane `piece` projects view v0 + piece % S, then
    // the pixel's lanes take each view's taps from the lane that projected
    // it (S = 1: every lane projects every view itself)
    for (int v0 = 0; v0 < V; v0 += S) {
      const int vp = v0 + piece % S;
      int p0 = 0;  // tap 0's pixel; ok's bit k marks tap k present
      unsigned ok = 0u;
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (vp < V) {
        const float r[3] = {ray[(vp * 3) * P + lp], ray[(vp * 3 + 1) * P + lp],
                            ray[(vp * 3 + 2) * P + lp]};
        float px, py;
        sweep::project_depth(r, trans[vp], depth, sx, ox, sy, oy, px, py);
        const sweep::Taps t = sweep::bilinear_taps(px, py, H, W);
        p0 = sweep::tap_pixel(t, 0, W);
        ok = live ? t.ok : 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) wt[k] = t.wt[k];
      }
      const int nv = min(S, V - v0);
      for (int u = 0; u < nv; ++u) {
        int tp0 = p0;
        unsigned tok = ok;
        float twt[4] = {wt[0], wt[1], wt[2], wt[3]};
        if constexpr (S > 1) {
          const int from = ((int)threadIdx.x & 31 & ~(L - 1)) | u;
          tp0 = __shfl_sync(0xffffffffu, p0, from);
          tok = __shfl_sync(0xffffffffu, ok, from);
#pragma unroll
          for (int k = 0; k < 4; ++k) twt[k] = __shfl_sync(0xffffffffu, wt[k], from);
        }
        const T* base = srcs[v0 + u] + c0;
        float wv[K];
#pragma unroll
        for (int j = 0; j < K; ++j) wv[j] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!(tok & (1u << k))) continue;
          float tap[K];
          sweep::load_n<K>(base + (tp0 + (k >> 1) * W + (k & 1)) * C, tap);
#pragma unroll
          for (int j = 0; j < K; ++j) wv[j] = fmaf(twt[k], tap[j], wv[j]);
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if constexpr (kVariance) {
            s[j] += wv[j];
            q[j] = fmaf(wv[j], wv[j], q[j]);
          } else {
            s[j] = wv[j];
          }
        }
      }
    }

    if constexpr (kVariance) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float mean = s[j] * inv_n;
        s[j] = q[j] * inv_n - mean * mean;
      }
    }
    if (live) sweep::store_piece(out + (bd * HW + pix) * C + c0, s);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
sweep_sampler_kernel(SrcPtrs src, long long src_bstride, const float* __restrict__ geom,
                     const float* __restrict__ dv, int dv_per_pixel, T* __restrict__ out,
                     int B, int D, int H, int W, float sx, float ox, float sy, float oy) {
  sweep_body<T, C, false>(nullptr, 0, src, src_bstride, 1, geom, dv, dv_per_pixel, out, B, D,
                          H, W, sx, ox, sy, oy);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
sweep_variance_kernel(const T* __restrict__ ref, long long ref_bstride, SrcPtrs src,
                      long long src_bstride, int V, const float* __restrict__ geom,
                      const float* __restrict__ dv, int dv_per_pixel, T* __restrict__ out,
                      int B, int D, int H, int W, float sx, float ox, float sy, float oy) {
  sweep_body<T, C, true>(ref, ref_bstride, src, src_bstride, V, geom, dv, dv_per_pixel, out, B,
                         D, H, W, sx, ox, sy, oy);
}

struct Args {
  const void* ref;
  long long ref_bstride;
  SrcPtrs src;
  long long src_bstride;
  int V;
  const float* geom;
  const float* dv;
  int dv_per_pixel;
  void* out;
  int B, D, H, W;
  float sx, ox, sy, oy;
};

template <typename T, int C>
cudaError_t launch(const Args& a, bool variance, cudaStream_t stream) {
  constexpr int P = kThreads / (C / kPiece<T>);
  const dim3 grid((unsigned)((a.H * a.W + P - 1) / P), (unsigned)a.B,
                  (unsigned)((a.D + kRun - 1) / kRun));
  const size_t shared = sizeof(float) * 3 * a.V * P;
  T* out = reinterpret_cast<T*>(a.out);
  if (variance)
    sweep_variance_kernel<T, C><<<grid, kThreads, shared, stream>>>(
        reinterpret_cast<const T*>(a.ref), a.ref_bstride, a.src, a.src_bstride, a.V, a.geom,
        a.dv, a.dv_per_pixel, out, a.B, a.D, a.H, a.W, a.sx, a.ox, a.sy, a.oy);
  else
    sweep_sampler_kernel<T, C><<<grid, kThreads, shared, stream>>>(
        a.src, a.src_bstride, a.geom, a.dv, a.dv_per_pixel, out, a.B, a.D, a.H, a.W, a.sx,
        a.ox, a.sy, a.oy);
  return cudaGetLastError();
}

cudaError_t dispatch(int C, int dtype, const Args& a, bool variance, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return dispatch_dtype_c(dtype, C, [&](auto t, auto c) {
    return launch<typename decltype(t)::type, decltype(c)::value>(a, variance, s);
  });
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Each returns the launch's cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported C, V or dtype).
//
// The sampler: src holds one [H, W, C] plane per batch element at
// src + b * src_bstride elements; geom is [1, B, 12].
extern "C" int sweep_sampler_launch(const void* src, long long src_bstride, const float* geom,
                                    const float* dv, int dv_per_pixel, void* out, int B,
                                    int D, int H, int W, int C, int dtype, float sx, float ox,
                                    float sy, float oy, void* stream) {
  Args a{nullptr, 0, {}, src_bstride, 1, geom, dv, dv_per_pixel, out,
         B, D, H, W, sx, ox, sy, oy};
  a.src.p[0] = src;
  return (int)dispatch(C, dtype, a, false, stream);
}

// The variance: src_ptrs is a HOST array of V device pointers, one [H, W, C]
// plane per (view, batch) at src_ptrs[v] + b * src_bstride elements; the
// reference's at ref + b * ref_bstride; geom is [V, B, 12].
extern "C" int sweep_variance_launch(const void* ref, long long ref_bstride,
                                     const void* const* src_ptrs, long long src_bstride,
                                     int V, const float* geom, const float* dv,
                                     int dv_per_pixel, void* out, int B, int D, int H, int W,
                                     int C, int dtype, float sx, float ox, float sy, float oy,
                                     void* stream) {
  Args a{ref, ref_bstride, {}, src_bstride, V, geom, dv, dv_per_pixel, out,
         B, D, H, W, sx, ox, sy, oy};
  if (!src_planes(src_ptrs, V, a.src)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(C, dtype, a, true, stream);
}
