// Probability-volume statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel damvsnet_tpu/ops/pallas/probstats.py
// (prob_volume_stats_pallas, kernel body _kernel): per pixel, over the D
// hypotheses of the regularized cost (fp32 or bf16, converted exactly in
// registers), in fp32
//
//     prob   = softmax_D(cost)
//     depth  = sum_d prob * dv
//     conf   = sum of prob over d in [idx-1, idx+2],
//              idx = clip(trunc(sum_d prob * d), 0, D-1)
//     sigma3 = 3 * sqrt(sum_d prob * (dv - depth)^2)     (two-pass variance)
//
// What held the first version back (one thread per pixel, four dependent
// passes over d, each re-reading cost or prob from L1/L2; 0.043 / 0.083 /
// 0.051 ms at the serving stages on an H100 80GB HBM3 at 700 W against
// bounds of 0.010 / 0.029 / 0.032): at stage 1 (D = 64, 216x288) only 62 k
// threads in 243 blocks, under two blocks an SM, each thread a chain of
// dependent loads; and the cascade made an fp32 copy of the bf16 cost in a
// launch of its own for it to read.
//
// Design: a block holds 32 consecutive pixels (one a lane) x kWarps warps;
// warp w owns the hypotheses d = w + kWarps * i of those pixels, so every
// load and store of a d-plane is coalesced across the lanes. For the common
// D (8, 32, 64) the D / kWarps costs and depths of a thread stay in
// registers: the cost is read once, prob written once, and the variance
// and the window sum reuse the registers. The maximum, the exp-sum, depth
// and index, then variance and window sum are combined over the warps
// through shared memory (four barriers), each thread adding the warps'
// partials in warp order, so every thread of a pixel holds the same
// depth and window index. Any other D runs the same passes with a loop
// that re-reads its costs and depths from L1/L2 and recomputes prob from
// them (prob is still written once and never read back).
//
// Bound on an H100 SXM: bytes. Each call reads cost and dv and writes prob
// and three maps; stage 3 at 1152x864 with a bf16 cost moves 91 MB (0.027
// ms at 3.35 TB/s). chip_smoke.py computes the bound from each run's
// shapes and element sizes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPixels = 32;  // pixels per block, one a lane

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Add {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// Every warp's partials of this thread's pixel, combined in warp order.
// Each call takes its own shared array, so no barrier guards its reuse.
template <int kWarps, typename Op>
__device__ __forceinline__ float across_warps(float (&part)[kWarps][kPixels], float x, Op op) {
  part[threadIdx.y][threadIdx.x] = x;
  __syncthreads();
  float r = part[0][threadIdx.x];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = op(r, part[w][threadIdx.x]);
  return r;
}

// Two sums behind one barrier.
template <int kWarps>
__device__ __forceinline__ void sum2_across_warps(float (&pa)[kWarps][kPixels],
                                                  float (&pb)[kWarps][kPixels], float& a,
                                                  float& b) {
  pa[threadIdx.y][threadIdx.x] = a;
  pb[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  a = pa[0][threadIdx.x];
  b = pb[0][threadIdx.x];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    a += pa[w][threadIdx.x];
    b += pb[w][threadIdx.x];
  }
}

// kD > 0: D == kD and each thread keeps its kD / kWarps values in
// registers; kD == 0: any D, values re-read per pass.
template <typename T, int kD, int kWarps>
__global__ void __launch_bounds__(kPixels * kWarps)
probstats_kernel(const T* __restrict__ cost,      // [B, D, HW]
                 const float* __restrict__ dv,    // [B, D] or [B, D, HW]
                 int dv_per_pixel,
                 float* __restrict__ prob,        // [B, D, HW]
                 float* __restrict__ depth,       // [B, HW]
                 float* __restrict__ conf,
                 float* __restrict__ sigma,
                 int D, long long HW) {
  __shared__ float part[6][kWarps][kPixels];
  constexpr int kN = kD > 0 ? kD / kWarps : 1;
  static_assert(kD % kWarps == 0, "kWarps divides kD");
  const int w = threadIdx.y;
  const long long b = blockIdx.y;
  const long long p = (long long)blockIdx.x * kPixels + threadIdx.x;
  const bool live = p < HW;
  const long long pc = live ? p : 0;  // a dead lane reads pixel 0 and writes nothing
  const T* c = cost + b * D * HW + pc;
  float* pr = prob + b * D * HW + p;
  const float* dvp = dv_per_pixel ? dv + b * D * HW + pc : dv + b * D;
  const long long dstride = dv_per_pixel ? HW : 1;
  // this warp's hypotheses: d = w + kWarps * i, i < n
  const int n = kD > 0 ? kN : (D - w + kWarps - 1) / kWarps;
  auto hyp = [&](int i) { return w + kWarps * i; };

  float cv[kN], dvv[kN];  // kD > 0: the costs (then exp, then prob) and depths
  float m = -INFINITY;
  if constexpr (kD > 0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      cv[i] = to_float(c[hyp(i) * HW]);
      dvv[i] = dvp[hyp(i) * dstride];
      m = fmaxf(m, cv[i]);
    }
  } else {
    for (int i = 0; i < n; ++i) m = fmaxf(m, to_float(c[hyp(i) * HW]));
  }
  m = across_warps<kWarps>(part[0], m, Max());

  float s = 0.f;
  if constexpr (kD > 0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      cv[i] = expf(cv[i] - m);
      s += cv[i];
    }
  } else {
    for (int i = 0; i < n; ++i) s += expf(to_float(c[hyp(i) * HW]) - m);
  }
  s = across_warps<kWarps>(part[1], s, Add());

  float dep = 0.f, idx_f = 0.f;
  auto prob_pass = [&](float q, int d, float dval) {
    if (live) pr[d * HW] = q;
    dep = fmaf(q, dval, dep);
    idx_f = fmaf(q, (float)d, idx_f);
  };
  if constexpr (kD > 0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      cv[i] = cv[i] / s;
      prob_pass(cv[i], hyp(i), dvv[i]);
    }
  } else {
    for (int i = 0; i < n; ++i)
      prob_pass(expf(to_float(c[hyp(i) * HW]) - m) / s, hyp(i), dvp[hyp(i) * dstride]);
  }
  sum2_across_warps<kWarps>(part[2], part[3], dep, idx_f);

  // trunc toward zero after clamping in float (fmaxf maps NaN to 0)
  const int idx = (int)fminf(fmaxf(idx_f, 0.f), (float)(D - 1));
  float var = 0.f, cf = 0.f;
  auto stats_pass = [&](float q, int d, float dval) {
    const float e = dval - dep;
    var = fmaf(q, e * e, var);
    if (d >= idx - 1 && d <= idx + 2) cf += q;
  };
  if constexpr (kD > 0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) stats_pass(cv[i], hyp(i), dvv[i]);
  } else {
    for (int i = 0; i < n; ++i)
      stats_pass(expf(to_float(c[hyp(i) * HW]) - m) / s, hyp(i), dvp[hyp(i) * dstride]);
  }
  sum2_across_warps<kWarps>(part[4], part[5], var, cf);

  if (w == 0 && live) {
    depth[b * HW + p] = dep;
    conf[b * HW + p] = cf;
    sigma[b * HW + p] = 3.f * sqrtf(var);
  }
}

template <typename T, int kD, int kWarps>
cudaError_t launch(const void* cost, const float* dv, int dv_per_pixel, float* prob,
                   float* depth, float* conf, float* sigma, int B, int D, long long HW,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((HW + kPixels - 1) / kPixels), (unsigned)B);
  probstats_kernel<T, kD, kWarps><<<grid, dim3(kPixels, kWarps), 0, stream>>>(
      reinterpret_cast<const T*>(cost), dv, dv_per_pixel, prob, depth, conf, sigma, D, HW);
  return cudaGetLastError();
}

// warps per block: D / kWarps values a thread (4 at D = 8, 8 at D = 32, 64)
template <typename T>
cudaError_t dispatch_d(const void* cost, const float* dv, int dv_per_pixel, float* prob,
                       float* depth, float* conf, float* sigma, int B, int D, long long HW,
                       cudaStream_t s) {
  switch (D) {
    case 8:
      return launch<T, 8, 2>(cost, dv, dv_per_pixel, prob, depth, conf, sigma, B, D, HW, s);
    case 32:
      return launch<T, 32, 4>(cost, dv, dv_per_pixel, prob, depth, conf, sigma, B, D, HW, s);
    case 64:
      return launch<T, 64, 8>(cost, dv, dv_per_pixel, prob, depth, conf, sigma, B, D, HW, s);
    default:
      return launch<T, 0, 8>(cost, dv, dv_per_pixel, prob, depth, conf, sigma, B, D, HW, s);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype (of the cost): 0 = float32,
// 1 = bfloat16. Returns the launch's cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported dtype or an empty shape).
extern "C" int probstats_launch(const void* cost, int dtype, const float* dv, int dv_per_pixel,
                                float* prob, float* depth, float* conf, float* sigma, int B,
                                int D, long long HW, void* stream) {
  if (B < 1 || D < 1 || HW < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(cost, dv, dv_per_pixel, prob, depth, conf, sigma, B, D, HW, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(cost, dv, dv_per_pixel, prob, depth, conf, sigma, B,
                                          D, HW, s);
  return (int)cudaErrorInvalidValue;
}
