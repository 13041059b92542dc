// FMT's linear attention for Hopper (sm_90a), where no gradient is needed:
// TransMVSNet's elu(x)+1 kernelized attention at its widths (8 heads of 4),
// `linear_attention` at nn/fmt.py, 12 calls a served FMT request.
//
// Replaces no TPU kernel: the JAX package leaves this math to XLA's einsums.
// It was added because the port's einsum chain ran the two summaries as
// fp32 cuBLAS products with a 62,208-token inner dimension and a 4 x 4 or
// 4-wide output a head (sm80_xmma_gemm_f32f32, gemmSN_NN, gemvx), for which
// cuBLAS has no good tiling: 17.6 ms of an fmt_serve request on an H100
// 80GB HBM3 at 700 W, beside ~20 launches of casts, elu, permute copies and
// repeat_interleave a call.
//
//   phi(x)          = elu(x) + 1
//   KV[n, h, m, d]  = sum over s of phi(k[n, s, h, d]) * v[n, s, h, m]
//   ksum[n, h, d]   = sum over s of phi(k[n, s, h, d])
//   out[i, l, h, m] = (sum over d of phi(q[i, l, h, d]) * KV[n, h, m, d])
//                     * 1 / (sum over d of phi(q[i, l, h, d]) * ksum[n, h, d] + eps)
//
// with n = i / (Bq / Bk): the query batch entries of one key batch entry
// share its summaries. q, k and v are read in their own dtype (fp32 or bf16,
// converted exactly to fp32); phi, both sums and the normaliser are fp32,
// and the output is rounded once to the dtype, as the plain chain does.
//
// Bound on an H100 SXM: a token's 32 channels are 64 bytes in bf16; k and v
// are read once, q read once and the output written once. At a served
// request's 12 calls (120 planes of 62,208 tokens) that is 477.8 MB, 0.143
// ms at 3.35 TB/s; its ~1.5 G fp32 operations take 0.022 ms at 67 TFLOP/s.
// So the design reads each byte once, whole heads at a time, and keeps
// enough loads in flight.
//
// Design: two kernels on the caller's stream, no atomics, so two runs give
// the same bits. A thread owns one head of a token: 8 bytes in bf16, 16 in
// fp32, 8 threads a token, so neighbouring threads read neighbouring bytes.
//   * linear_attn_summary_kernel: the key tokens of each batch entry are cut
//     into at most kMaxSplits contiguous chunks, one block of 256 threads a
//     chunk (grid: chunks x Bk), so even a key batch of 1 fills the SMs. A
//     thread sums its tokens' 16 products and 4 keys of its head in fp32
//     registers, with kUnroll tokens' loads in flight. The block then sums
//     its threads in a fixed order (a butterfly over the warp's 4 lanes of
//     one head, then the warps in order through shared memory) and writes
//     the chunk's 160 partial sums (KV, then ksum, 8 heads) to a scratch
//     buffer.
//   * linear_attn_apply_kernel: a block of 256 threads owns kApplyIters x 32
//     query tokens of one batch entry. It first sums the key entry's
//     partials into shared memory in a fixed order (each warp every 8th
//     chunk, then the warps in order; every block of that entry sums them
//     alike, so all see the same bits), then each thread holds its head's
//     KV and ksum in registers, reads its head of q, and writes its head of
//     the output, [Bq, L, H, M] contiguous.
//
// Tuning in bf16 on an H100 80GB HBM3 at 700 W (48 variants: one or two
// heads a thread, kMaxSplits 64 / 128, kApplyIters 4 / 8, kUnroll 2 / 4 /
// 8): the constants below were the best, 0.32 ms of device time for a
// request's 12 calls (the plain chain: 21.4 ms). phi(x) = exp(x) below 0
// takes a third of expm1f's instructions, without which both kernels were
// bound by instructions (0.50 ms); two heads a thread (16-byte vectors) held
// 80-105 registers and so fewer warps an SM.
#include "common.cuh"

namespace {

constexpr int kHeads = 8;
constexpr int kDim = 4;                          // a head's width, of q, k and v alike
constexpr int kChannels = kHeads * kDim;         // 32 a token
constexpr int kHeadSummary = kDim * kDim;        // KV[h]: 16
constexpr int kKsum = kHeads * kHeadSummary;     // ksum's offset in a summary: 128
constexpr int kSummary = kKsum + kHeads * kDim;  // 160 floats a key batch entry
constexpr int kMaxSplits = 128;                  // chunks of a key batch entry (MAX_SPLITS)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTokensPerPass = kThreads / kHeads;  // 32: a thread a head
constexpr int kUnroll = 4;                       // tokens' loads in flight a thread
constexpr int kApplyIters = 8;                   // passes of an apply block
static_assert(kSummary % 32 == 0, "the apply kernel's lanes cover the summary in 32s");

// One head of a token as loaded: 8 bytes in bf16, 16 in fp32.
template <typename T>
struct Head {
  static constexpr int kWords = kDim * static_cast<int>(sizeof(T)) / 4;
  using Vec = std::conditional_t<kWords == 4, uint4, uint2>;
};

__device__ __forceinline__ void words(const uint4& u, uint32_t (&w)[4]) {
  w[0] = u.x;
  w[1] = u.y;
  w[2] = u.z;
  w[3] = u.w;
}
__device__ __forceinline__ void words(const uint2& u, uint32_t (&w)[2]) {
  w[0] = u.x;
  w[1] = u.y;
}
__device__ __forceinline__ void vector(const uint32_t (&w)[4], uint4& u) {
  u = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void vector(const uint32_t (&w)[2], uint2& u) {
  u = make_uint2(w[0], w[1]);
}

template <typename T>
__device__ __forceinline__ void unpack(const typename Head<T>::Vec& u, float (&f)[kDim]) {
  uint32_t w[Head<T>::kWords];
  words(u, w);
#pragma unroll
  for (int i = 0; i < Head<T>::kWords; ++i) {
    if constexpr (sizeof(T) == 2) {  // bf16 -> fp32 is exact: the bits move up
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      f[i] = __uint_as_float(w[i]);
    }
  }
}

// 4 fp32 values rounded once to T, as one head
template <typename T>
__device__ __forceinline__ typename Head<T>::Vec pack(const float (&f)[kDim]) {
  uint32_t w[Head<T>::kWords];
#pragma unroll
  for (int i = 0; i < Head<T>::kWords; ++i) {
    if constexpr (sizeof(T) == 2) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]));
      w[i] = lo | (hi << 16);
    } else {
      w[i] = __float_as_uint(f[i]);
    }
  }
  typename Head<T>::Vec u;
  vector(w, u);
  return u;
}

// elu(x) + 1 in fp32: x + 1 above 0, else exp(x), which F.elu(x) + 1.0
// computes as expm1(x) + 1 (two roundings where this has one)
__device__ __forceinline__ float phi(float x) { return x > 0.f ? x + 1.f : expf(x); }

// The tokens of each chunk of a key batch entry of S tokens (a multiple of
// a pass, at most kMaxSplits chunks), and the chunks: both kernels read them.
__host__ __device__ __forceinline__ int chunk_tokens(int S) {
  const int passes = (S + kTokensPerPass - 1) / kTokensPerPass;
  const int splits = passes < kMaxSplits ? passes : kMaxSplits;
  return (passes + splits - 1) / splits * kTokensPerPass;
}

__host__ __device__ __forceinline__ int num_chunks(int S) {
  const int c = chunk_tokens(S);
  return (S + c - 1) / c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_attn_summary_kernel(const T* __restrict__ k,      // [Bk, S, 8, 4], contiguous
                           const T* __restrict__ v,      // [Bk, S, 8, 4], contiguous
                           float* __restrict__ partial,  // [Bk, kMaxSplits, 160]
                           int S) {
  using V = typename Head<T>::Vec;
  __shared__ float s_red[kWarps][kSummary];

  const int n = blockIdx.y, chunk = blockIdx.x;
  const int h = threadIdx.x % kHeads, row = threadIdx.x / kHeads;
  const int chunk_len = chunk_tokens(S);
  const int s0 = chunk * chunk_len, s1 = min(s0 + chunk_len, S);
  const long long base = static_cast<long long>(n) * S * kChannels + h * kDim;
  const V* kp = reinterpret_cast<const V*>(k + base);
  const V* vp = reinterpret_cast<const V*>(v + base);

  float kv[kHeadSummary], ks[kDim];
#pragma unroll
  for (int i = 0; i < kHeadSummary; ++i) kv[i] = 0.f;
#pragma unroll
  for (int d = 0; d < kDim; ++d) ks[d] = 0.f;

  for (int t0 = s0 + row; t0 < s1; t0 += kUnroll * kTokensPerPass) {
    V kq[kUnroll], vq[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kTokensPerPass;
      if (t < s1) {
        kq[u] = __ldg(kp + static_cast<long long>(t) * kHeads);
        vq[u] = __ldg(vp + static_cast<long long>(t) * kHeads);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u * kTokensPerPass < s1) {
        float kf[kDim], vf[kDim];
        unpack<T>(kq[u], kf);
        unpack<T>(vq[u], vf);
#pragma unroll
        for (int d = 0; d < kDim; ++d) {
          const float p = phi(kf[d]);
          ks[d] += p;
#pragma unroll
          for (int m = 0; m < kDim; ++m) kv[m * kDim + d] = fmaf(p, vf[m], kv[m * kDim + d]);
        }
      }
    }
  }

  // the warp's 4 lanes of one head (lane % 8 alike), in a fixed butterfly
#pragma unroll
  for (int o = kHeads; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < kHeadSummary; ++i) kv[i] += __shfl_xor_sync(0xffffffffu, kv[i], o);
#pragma unroll
    for (int d = 0; d < kDim; ++d) ks[d] += __shfl_xor_sync(0xffffffffu, ks[d], o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < kHeads) {  // lane == h: one lane a head writes the warp's sums
#pragma unroll
    for (int i = 0; i < kHeadSummary; ++i) s_red[warp][h * kHeadSummary + i] = kv[i];
#pragma unroll
    for (int d = 0; d < kDim; ++d) s_red[warp][kKsum + h * kDim + d] = ks[d];
  }
  __syncthreads();
  if (threadIdx.x < kSummary) {  // the warps in order
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_red[w][threadIdx.x];
    partial[(static_cast<long long>(n) * kMaxSplits + chunk) * kSummary + threadIdx.x] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_attn_apply_kernel(const T* __restrict__ q,            // [Bq, L, 8, 4], contiguous
                         const float* __restrict__ partial,  // [Bk, kMaxSplits, 160]
                         T* __restrict__ out,                // [Bq, L, 8, 4], contiguous
                         int rep, int Lq, int S, float eps) {
  using V = typename Head<T>::Vec;
  __shared__ float s_red[kWarps][kSummary];
  __shared__ float s_sum[kSummary];

  const int i = blockIdx.y, n = i / rep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  {  // the key entry's chunks: warp w sums chunks w, w + kWarps, ... in order,
     // its lanes over the 160 sums; then the warps in order
    const float* p = partial + static_cast<long long>(n) * kMaxSplits * kSummary;
    const int chunks = num_chunks(S);
    float sum[kSummary / 32] = {};
#pragma unroll 4
    for (int c = warp; c < chunks; c += kWarps) {
#pragma unroll
      for (int j = 0; j < kSummary / 32; ++j) sum[j] += p[c * kSummary + j * 32 + lane];
    }
#pragma unroll
    for (int j = 0; j < kSummary / 32; ++j) s_red[warp][j * 32 + lane] = sum[j];
    __syncthreads();
    if (threadIdx.x < kSummary) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += s_red[w][threadIdx.x];
      s_sum[threadIdx.x] = total;
    }
    __syncthreads();
  }

  const int h = threadIdx.x % kHeads, row = threadIdx.x / kHeads;
  float kv[kHeadSummary], ks[kDim];
#pragma unroll
  for (int j = 0; j < kHeadSummary; ++j) kv[j] = s_sum[h * kHeadSummary + j];
#pragma unroll
  for (int d = 0; d < kDim; ++d) ks[d] = s_sum[kKsum + h * kDim + d];

  const long long base = static_cast<long long>(i) * Lq * kChannels + h * kDim;
  const V* qp = reinterpret_cast<const V*>(q + base);
  V* op = reinterpret_cast<V*>(out + base);
  constexpr int kPerBlock = kApplyIters * kTokensPerPass;
  const int l0 = static_cast<int>(blockIdx.x) * kPerBlock;
  const int l1 = min(l0 + kPerBlock, Lq);

  for (int t0 = l0 + row; t0 < l1; t0 += kUnroll * kTokensPerPass) {
    V qq[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kTokensPerPass;
      if (t < l1) qq[u] = __ldg(qp + static_cast<long long>(t) * kHeads);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kTokensPerPass;
      if (t < l1) {
        float qf[kDim], p[kDim], o[kDim];
        unpack<T>(qq[u], qf);
#pragma unroll
        for (int d = 0; d < kDim; ++d) p[d] = phi(qf[d]);
        float den = 0.f;
#pragma unroll
        for (int d = 0; d < kDim; ++d) den = fmaf(p[d], ks[d], den);
        const float z = 1.f / (den + eps);
#pragma unroll
        for (int m = 0; m < kDim; ++m) {
          float num = 0.f;
#pragma unroll
          for (int d = 0; d < kDim; ++d) num = fmaf(p[d], kv[m * kDim + d], num);
          o[m] = num * z;
        }
        op[static_cast<long long>(t) * kHeads] = pack<T>(o);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, float* partial, void* out,
                   int Bq, int Bk, int Lq, int S, float eps, cudaStream_t stream) {
  const dim3 sgrid((unsigned)num_chunks(S), (unsigned)Bk);
  linear_attn_summary_kernel<T><<<sgrid, kThreads, 0, stream>>>(
      reinterpret_cast<const T*>(k), reinterpret_cast<const T*>(v), partial, S);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kPerBlock = kApplyIters * kTokensPerPass;
  const dim3 agrid((unsigned)((Lq + kPerBlock - 1) / kPerBlock), (unsigned)Bq);
  linear_attn_apply_kernel<T><<<agrid, kThreads, 0, stream>>>(
      reinterpret_cast<const T*>(q), partial, reinterpret_cast<T*>(out), Bq / Bk, Lq, S, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. q [Bq, L, 8, 4], k and v
// [Bk, S, 8, 4], out [Bq, L, 8, 4], all contiguous and 16-byte aligned, of
// one dtype: 0 = float32, 1 = bfloat16. partial: fp32 scratch of
// Bk x kMaxSplits x 160 floats. Launches both kernels on the stream; returns
// the first launch error (cudaErrorInvalidValue for an unsupported dtype, an
// empty shape or a Bk that does not divide Bq).
extern "C" int linear_attention_launch(const void* q, const void* k, const void* v, int dtype,
                                       void* partial, void* out, int Bq, int Bk, int L, int S,
                                       float eps, void* stream) {
  if (Bq < 1 || Bk < 1 || L < 1 || S < 1 || Bq % Bk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* p = reinterpret_cast<float*>(partial);
  return (int)dispatch_dtype(dtype, [&](auto t) {
    return launch<typename decltype(t)::type>(q, k, v, p, out, Bq, Bk, L, S, eps, s);
  });
}
