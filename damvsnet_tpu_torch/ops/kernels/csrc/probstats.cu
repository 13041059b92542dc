// Probability-volume statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel damvsnet_tpu/ops/pallas/probstats.py
// (prob_volume_stats_pallas, kernel body _kernel): per pixel, over the D
// hypotheses of the regularized cost, in fp32
//
//     prob   = softmax_D(cost)
//     depth  = sum_d prob * dv
//     conf   = sum of prob over d in [idx-1, idx+2],
//              idx = clip(trunc(sum_d prob * d), 0, D-1)
//     sigma3 = 3 * sqrt(sum_d prob * (dv - depth)^2)
//
// Design: one thread per pixel. [B, D, H, W] puts the pixels of one d next
// to each other, so every loop over d reads and writes coalesced across the
// threads of a warp. Four passes over d (max, exp-sum, prob + depth + index,
// variance); the passes re-read from L1/L2 rather than hold D values in
// registers, so any D works. The variance and the window sum read back the
// probabilities this thread wrote.
//
// Bound on an H100 SXM: bytes. Each call reads cost and dv and writes prob
// and three maps; stage 3 at 1152x864 moves 107 MB (0.032 ms at
// 3.35 TB/s). chip_smoke.py computes the bound from each run's shapes; on
// an H100 80GB HBM3 at 700 W it measured 0.043 / 0.083 / 0.051 ms for
// stages 1/2/3 against bounds of 0.010 / 0.029 / 0.032 ms.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void __launch_bounds__(256)
probstats_kernel(const float* __restrict__ cost,  // [B, D, HW]
                 const float* __restrict__ dv,    // [B, D] or [B, D, HW]
                 int dv_per_pixel,
                 float* __restrict__ prob,        // [B, D, HW]
                 float* __restrict__ depth,       // [B, HW]
                 float* __restrict__ conf,
                 float* __restrict__ sigma,
                 int B, int D, long long HW) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * HW) return;
  const long long b = i / HW;
  const long long p = i - b * HW;
  const float* c = cost + b * D * HW + p;
  float* pr = prob + b * D * HW + p;
  const float* dvp = dv_per_pixel ? dv + b * D * HW + p : dv + b * D;
  const long long dstride = dv_per_pixel ? HW : 1;

  float m = -INFINITY;
  for (int d = 0; d < D; ++d) m = fmaxf(m, c[d * HW]);
  float s = 0.f;
  for (int d = 0; d < D; ++d) s += expf(c[d * HW] - m);

  float dep = 0.f, idx_f = 0.f;
  for (int d = 0; d < D; ++d) {
    const float q = expf(c[d * HW] - m) / s;
    pr[d * HW] = q;
    dep = fmaf(q, dvp[d * dstride], dep);
    idx_f = fmaf(q, (float)d, idx_f);
  }

  float var = 0.f;
  for (int d = 0; d < D; ++d) {
    const float e = dvp[d * dstride] - dep;
    var = fmaf(pr[d * HW], e * e, var);
  }

  // trunc toward zero after clamping in float (fmaxf maps NaN to 0)
  const int idx = (int)fminf(fmaxf(idx_f, 0.f), (float)(D - 1));
  float cf = 0.f;
  for (int d = idx - 1; d <= idx + 2; ++d)
    if (d >= 0 && d < D) cf += pr[d * HW];

  depth[i] = dep;
  conf[i] = cf;
  sigma[i] = 3.f * sqrtf(var);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the launch's
// cudaGetLastError().
extern "C" int probstats_launch(const float* cost, const float* dv, int dv_per_pixel,
                                float* prob, float* depth, float* conf, float* sigma,
                                int B, int D, long long HW, void* stream) {
  if (B < 1 || D < 1 || HW < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * HW;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  probstats_kernel<<<(unsigned)blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      cost, dv, dv_per_pixel, prob, depth, conf, sigma, B, D, HW);
  return (int)cudaGetLastError();
}
