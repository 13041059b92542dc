// Plane-sweep bilinear sampler for Hopper (sm_90a).
//
// Replaces the TPU kernel damvsnet_tpu/ops/pallas/sweep_sampler.py
// (sample_bilinear_band, kernel body _kernel, entry plane_sweep_warp_pallas):
// for every output voxel (b, d, y, x) of one source view
//
//     (px, py) = project (x, y) at depth dv through the view's 12-float
//                relative homography [rot row-major | trans], then the grid
//                round trip px = u * sx + ox (align_corners selects sx, ox)
//     out      = 4-tap zero-padded bilinear sample of src (C channels)
//
// in the source dtype. The TPU kernel's band DMA windows, hat-function
// matmuls and overflow flag exist only because the TPU has no fast gather;
// here every tap is gathered directly, so nothing can overflow and there is
// no flag. Projection and taps are the code of the fused cost volume
// (sampling.cuh), so both kernels sample alike.
//
// Design: one thread per output voxel (64-bit index). The thread projects
// its pixel, gathers each in-image tap as one contiguous C-vector from the
// channels-last source with 16-byte loads, accumulates in fp32 registers
// and writes one contiguous C-vector, rounded once to the source dtype.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): the output is the dominant byte stream (stage 1 at 1152x864:
// 64*216*288*32 bf16 = 255 MB against 4 MB of source, 0.077 ms); the
// gathered taps of neighbouring threads overlap and stay in L1/L2. The
// arithmetic is about 8C + 30 operations per voxel (1.2 GFLOP at stage 1,
// 0.017 ms), so the kernel is bound by bytes at every stage. chip_smoke.py
// computes both bounds from each run's shapes and measures the kernel
// beside them.
#include "sampling.cuh"

namespace {

template <typename T, int C>
__global__ void __launch_bounds__(128)
sweep_sampler_kernel(const T* __restrict__ src, long long src_bstride,
                     const float* __restrict__ geom,  // [B, 12]
                     const float* __restrict__ dv,    // [B, D] or [B, D, H, W]
                     int dv_per_pixel,
                     T* __restrict__ out,             // [B, D, H, W, C]
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
  float px, py;
  sweep::project(geom + (long long)b * 12, (float)x, (float)y, depth, sx, ox, sy, oy, px, py);
  float acc[C];
  sweep::bilinear_zeros<T, C>(src + b * src_bstride, px, py, H, W, acc);

  T* o = out + i * C;
#pragma unroll
  for (int k = 0; k < C; k += 8) sweep::store8(o + k, acc + k);
}

template <typename T, int C>
cudaError_t launch(const void* src, long long src_bstride, const float* geom, const float* dv,
                   int dv_per_pixel, void* out, int B, int D, int H, int W, float sx,
                   float ox, float sy, float oy, cudaStream_t stream) {
  const long long n = (long long)B * D * H * W;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  sweep_sampler_kernel<T, C><<<(unsigned)blocks, threads, 0, stream>>>(
      reinterpret_cast<const T*>(src), src_bstride, geom, dv, dv_per_pixel,
      reinterpret_cast<T*>(out), B, D, H, W, sx, ox, sy, oy);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_c(int C, const void* src, long long src_bstride, const float* geom,
                       const float* dv, int dv_per_pixel, void* out, int B, int D, int H,
                       int W, float sx, float ox, float sy, float oy, cudaStream_t stream) {
  switch (C) {
    case 8:
      return launch<T, 8>(src, src_bstride, geom, dv, dv_per_pixel, out, B, D, H, W, sx, ox,
                          sy, oy, stream);
    case 16:
      return launch<T, 16>(src, src_bstride, geom, dv, dv_per_pixel, out, B, D, H, W, sx, ox,
                           sy, oy, stream);
    case 32:
      return launch<T, 32>(src, src_bstride, geom, dv, dv_per_pixel, out, B, D, H, W, sx, ox,
                           sy, oy, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// src holds one [H, W, C] plane per batch element at src + b * src_bstride
// elements. Returns the launch's cudaGetLastError() (cudaErrorInvalidValue
// for an unsupported C or dtype).
extern "C" int sweep_sampler_launch(const void* src, long long src_bstride, const float* geom,
                                    const float* dv, int dv_per_pixel, void* out, int B,
                                    int D, int H, int W, int C, int dtype, float sx, float ox,
                                    float sy, float oy, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_c<float>(C, src, src_bstride, geom, dv, dv_per_pixel, out, B, D, H, W, sx,
                            ox, sy, oy, s);
  else if (dtype == 1)
    err = dispatch_c<__nv_bfloat16>(C, src, src_bstride, geom, dv, dv_per_pixel, out, B, D,
                                    H, W, sx, ox, sy, oy, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
