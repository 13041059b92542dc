// CostRegNet's final convolution for Hopper (sm_90a): Conv3d(8, 1, 3,
// padding=1, bias=False), the `prob` head at nn/costreg.py, on the serving
// route.
//
// Replaces no TPU kernel: the JAX package leaves this convolution to XLA.
// It was added because cuDNN has no tensor-core engine for one output
// channel in bf16 and falls back to its legacy NCDHW fp32 implicit GEMM
// (implicit_convolveNd_sgemm), after transposing the channels-last volume:
// 19.9 ms a DTU request (1152x864, D = 64 / 32 / 8) on an H100 80GB HBM3 at
// 700 W, for work whose least time is ~0.13 ms.
//
//     out[b, 0, d, h, w] = sum over c < 8 and kd, kh, kw < 3 of
//         weight[0, c, kd, kh, kw] * x[b, c, d + kd - 1, h + kh - 1, w + kw - 1]
//
// with zero padding, the inputs and the weight in the compute dtype (fp32 or
// bf16, converted exactly to fp32), the 216 products summed in fp32 and the
// sum rounded once to the compute dtype.
//
// Layout: the volume reaches the head as channels_last_3d (the cascade's
// cost volume is a permute(0, 4, 1, 2, 3) view of [B, D, H, W, C], and every
// block of the U-Net keeps that memory format), so a voxel's 8 channels are
// one 16-byte vector in bf16. Any other strides (a contiguous NCDHW volume)
// take the same kernel with the channels gathered one by one (kVec false).
// The output is one contiguous [B, D, H, W] buffer.
//
// Bound on an H100 SXM: per output voxel 216 fp32 FMAs (432 operations) and
// 8 input values read once, the output written once. At the three serving
// stages (19.9 M outputs) that is 8.6 G operations, 0.128 ms at 67 TFLOP/s,
// against 358 MB in bf16, 0.107 ms at 3.35 TB/s: bound by operations, so
// the design keeps the FMA pipe fed and reads each input from device memory
// about once.
//
// Design: a stencil, not a GEMM (one output channel leaves a matrix unit
// nothing to do). A block of 128 threads owns a 32 x 32 (H, W) tile of
// outputs and a chunk of D; a thread owns 8 outputs along W of one row.
// The block walks the input planes of its chunk (plus one halo plane on each
// side) in order: each plane's 34 x 34 tile (the outputs' tile and a
// one-voxel halo, zero outside the volume) is staged in shared memory as
// fp32, channel-planar ([c][row][col], rows padded to 36 floats, so that
// the threads' 16-byte reads hit distinct banks), while the next plane's
// loads are already in flight in registers. From each plane a thread adds
// into the three outputs along D that the plane touches (kd = 2, 1, 0 for
// outputs d - 1, d, d + 1), kept in a rolling window of three accumulator
// rows, and stores the one that is finished. Each channel's 3 x 10 input
// values are read from shared memory once and used by 8 x 27 FMAs; the
// weights sit in shared memory as (kd0, kd1, kd2) vectors, broadcast to
// every thread. At the chunk's ends only the taps whose output lies in the
// chunk are computed, so no FMA is wasted on the halo planes.
//
// Measured in bf16 on an H100 80GB HBM3 at 700 W: 0.067 / 0.127 / 0.114 ms
// of device time at the serving stages, 42 % of the bound (cuDNN: 19.96
// ms). A chunk of 8 planes along D (kDChunk) was the best of 1-64 at
// stages 1 and 3 and within 5 % of 16 at stage 2. 123 registers a thread
// leave 4 blocks an SM; each plane costs two barriers and the staging
// between compute phases.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kC = 8;          // input channels
constexpr int kOut = 8;        // outputs a thread, along W
constexpr int kTX = 4;         // threads across W
constexpr int kTY = 32;        // threads down H, one row each
constexpr int kThreads = kTX * kTY;
constexpr int kTW = kTX * kOut;  // tile of outputs: 32 x 32
constexpr int kTH = kTY;
constexpr int kSW = kTW + 2;     // staged tile with its halo: 34 x 34
constexpr int kSH = kTH + 2;
constexpr int kPitch = 36;       // floats a staged row (16-byte rows, bank shift 4)
constexpr int kStaged = kSW * kSH;
constexpr int kPerThread = (kStaged + kThreads - 1) / kThreads;
constexpr int kDChunk = 8;       // output planes along D a block

// One voxel's 8 channels as loaded: 16 bytes in bf16, 32 in fp32.
template <typename T>
struct Pix {
  static constexpr int kWords = kC * sizeof(T) / 16;
  uint4 w[kWords];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, bool kVec>
__device__ __forceinline__ Pix<T> load_pix(const T* p, long long sc) {
  Pix<T> r;
  if constexpr (kVec) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < Pix<T>::kWords; ++i) r.w[i] = __ldg(q + i);
  } else {
    T v[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) v[c] = p[c * sc];
    memcpy(r.w, v, sizeof(v));
  }
  return r;
}

// 32-bit word i of a voxel's vector (i < 4 * kWords; resolved at compile time)
template <typename T>
__device__ __forceinline__ uint32_t word(const Pix<T>& p, int i) {
  const uint4& q = p.w[i / 4];
  return i % 4 == 0 ? q.x : i % 4 == 1 ? q.y : i % 4 == 2 ? q.z : q.w;
}

template <typename T>
__device__ __forceinline__ void unpack(const Pix<T>& p, float (&f)[kC]) {
#pragma unroll
  for (int i = 0; i < kC * (int)sizeof(T) / 4; ++i) {
    const uint32_t u = word(p, i);
    if constexpr (sizeof(T) == 2) {  // bf16 -> fp32 is exact: the bits move up
      f[2 * i] = __uint_as_float(u << 16);
      f[2 * i + 1] = __uint_as_float(u & 0xffff0000u);
    } else {
      f[i] = __uint_as_float(u);
    }
  }
}

// 8 fp32 values rounded once to T, as one vector.
template <typename T>
__device__ __forceinline__ Pix<T> pack(const float (&f)[kOut]) {
  uint32_t u[kC * sizeof(T) / 4];
#pragma unroll
  for (int i = 0; i < kC * (int)sizeof(T) / 4; ++i) {
    if constexpr (sizeof(T) == 2) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]));
      u[i] = lo | (hi << 16);
    } else {
      u[i] = __float_as_uint(f[i]);
    }
  }
  Pix<T> p;
#pragma unroll
  for (int k = 0; k < Pix<T>::kWords; ++k)
    p.w[k] = make_uint4(u[4 * k], u[4 * k + 1], u[4 * k + 2], u[4 * k + 3]);
  return p;
}

// Plane z's staged tile into registers (zeros outside the volume).
template <typename T, bool kVec>
__device__ __forceinline__ void load_plane(Pix<T> (&pre)[kPerThread], const T* xb, int z,
                                           int h0, int w0, int H, int W, long long sc,
                                           long long sd, long long sh, long long sw) {
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int row = p / kSW, col = p - row * kSW;
    const int h = h0 - 1 + row, w = w0 - 1 + col;
    if (p < kStaged && h >= 0 && h < H && w >= 0 && w < W) {
      pre[i] = load_pix<T, kVec>(xb + z * sd + h * sh + w * sw, sc);
    } else {
#pragma unroll
      for (int k = 0; k < Pix<T>::kWords; ++k) pre[i].w[k] = make_uint4(0, 0, 0, 0);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_plane(const Pix<T> (&pre)[kPerThread], float* s_in) {
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p < kStaged) {
      const int row = p / kSW, col = p - row * kSW;
      float f[kC];
      unpack(pre[i], f);
#pragma unroll
      for (int c = 0; c < kC; ++c) s_in[(c * kSH + row) * kPitch + col] = f[c];
    }
  }
}

// One staged plane into the rolling accumulators: acc[0] is output plane
// z - 1 (tap kd = 2), acc[1] plane z (kd = 1), acc[2] plane z + 1 (kd = 0).
// kMask bit k set: the tap kd = k has its output inside the block's chunk.
template <int kMask>
__device__ __forceinline__ void accumulate(const float* __restrict__ s_in,
                                           const float4* __restrict__ s_w, int tx, int ty,
                                           float (&acc)[3][kOut]) {
#pragma unroll 1
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const float* row = s_in + (c * kSH + ty + ky) * kPitch + kOut * tx;
      const float4 a = *reinterpret_cast<const float4*>(row);
      const float4 b = *reinterpret_cast<const float4*>(row + 4);
      const float2 e = *reinterpret_cast<const float2*>(row + 8);
      const float v[kOut + 2] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x, e.y};
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float4 wk = s_w[(c * 3 + ky) * 3 + kx];  // (kd 0, kd 1, kd 2, -)
#pragma unroll
        for (int r = 0; r < kOut; ++r) {
          const float u = v[r + kx];
          if (kMask & 1) acc[2][r] = fmaf(wk.x, u, acc[2][r]);
          if (kMask & 2) acc[1][r] = fmaf(wk.y, u, acc[1][r]);
          if (kMask & 4) acc[0][r] = fmaf(wk.z, u, acc[0][r]);
        }
      }
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
prob_conv3d_kernel(const T* __restrict__ x,       // [B, 8, D, H, W], strides in elements
                   long long sb, long long sc, long long sd, long long sh, long long sw,
                   const T* __restrict__ weight,  // [1, 8, 3, 3, 3], contiguous
                   T* __restrict__ out,           // [B, D, H, W], contiguous
                   int D, int H, int W, int nchunks) {
  __shared__ __align__(16) float s_in[kC * kSH * kPitch];
  __shared__ float4 s_w[kC * 9];

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int w0 = blockIdx.x * kTW, h0 = blockIdx.y * kTH;
  const int b = blockIdx.z / nchunks;
  const int d0 = (blockIdx.z - b * nchunks) * kDChunk;
  const int d1 = min(d0 + kDChunk, D);  // the chunk's output planes: [d0, d1)
  const T* xb = x + b * sb;

  for (int i = threadIdx.x; i < kC * 27; i += kThreads) {
    const int c = i / 27, kd = i / 9 % 3, ky = i / 3 % 3, kx = i % 3;
    reinterpret_cast<float*>(s_w)[((c * 3 + ky) * 3 + kx) * 4 + kd] = to_float(weight[i]);
  }

  Pix<T> pre[kPerThread];
  load_plane<T, kVec>(pre, xb, max(d0 - 1, 0), h0, w0, H, W, sc, sd, sh, sw);

  float acc[3][kOut];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int r = 0; r < kOut; ++r) acc[k][r] = 0.f;

  const int h = h0 + ty, wt = w0 + kOut * tx;
  for (int z = d0 - 1; z <= d1; ++z) {
    if (z >= 0 && z < D) {  // uniform over the block
      __syncthreads();        // the previous plane's reads are done
      store_plane<T>(pre, s_in);
      __syncthreads();
      if (z + 1 < D && z + 1 <= d1)
        load_plane<T, kVec>(pre, xb, z + 1, h0, w0, H, W, sc, sd, sh, sw);
      const int mask = (z + 1 >= d0 && z + 1 < d1 ? 1 : 0) | (z >= d0 && z < d1 ? 2 : 0) |
                       (z - 1 >= d0 && z - 1 < d1 ? 4 : 0);
      switch (mask) {
        case 7: accumulate<7>(s_in, s_w, tx, ty, acc); break;
        case 1: accumulate<1>(s_in, s_w, tx, ty, acc); break;
        case 3: accumulate<3>(s_in, s_w, tx, ty, acc); break;
        case 6: accumulate<6>(s_in, s_w, tx, ty, acc); break;
        case 4: accumulate<4>(s_in, s_w, tx, ty, acc); break;
        case 2: accumulate<2>(s_in, s_w, tx, ty, acc); break;
        case 5: accumulate<5>(s_in, s_w, tx, ty, acc); break;
        default: break;
      }
    }
    const int o = z - 1;  // finished: every plane it reads has been added
    if (o >= d0 && o < d1 && h < H) {
      T* dst = out + ((static_cast<long long>(b) * D + o) * H + h) * W + wt;
      if (wt + kOut <= W && W % kOut == 0) {  // 16- (bf16) or 32-byte (fp32) aligned
        const Pix<T> v = pack<T>(acc[0]);
        uint4* q = reinterpret_cast<uint4*>(dst);
#pragma unroll
        for (int k = 0; k < Pix<T>::kWords; ++k) q[k] = v.w[k];
      } else {
#pragma unroll
        for (int r = 0; r < kOut; ++r)
          if (wt + r < W) dst[r] = from_float<T>(acc[0][r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      acc[0][r] = acc[1][r];
      acc[1][r] = acc[2][r];
      acc[2][r] = 0.f;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const long long* strides, const void* weight, void* out,
                   int B, int D, int H, int W, cudaStream_t stream) {
  const long long sb = strides[0], sc = strides[1], sd = strides[2], sh = strides[3],
                  sw = strides[4];
  const int nchunks = (D + kDChunk - 1) / kDChunk;
  const dim3 grid((unsigned)((W + kTW - 1) / kTW), (unsigned)((H + kTH - 1) / kTH),
                  (unsigned)(B * nchunks));
  // whole 16-byte vectors: channels adjacent, every voxel 16-byte aligned
  const bool vec = sc == 1 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (sb * sizeof(T)) % 16 == 0 && (sd * sizeof(T)) % 16 == 0 &&
                   (sh * sizeof(T)) % 16 == 0 && (sw * sizeof(T)) % 16 == 0;
  const T* xp = reinterpret_cast<const T*>(x);
  const T* wp = reinterpret_cast<const T*>(weight);
  T* op = reinterpret_cast<T*>(out);
  if (vec)
    prob_conv3d_kernel<T, true><<<grid, kThreads, 0, stream>>>(xp, sb, sc, sd, sh, sw, wp, op,
                                                               D, H, W, nchunks);
  else
    prob_conv3d_kernel<T, false><<<grid, kThreads, 0, stream>>>(xp, sb, sc, sd, sh, sw, wp, op,
                                                                D, H, W, nchunks);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype (of x, weight and out):
// 0 = float32, 1 = bfloat16. strides: x's five strides in elements.
// Returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported dtype or an
// empty shape).
extern "C" int prob_conv3d_launch(const void* x, int dtype, const long long* strides,
                                  const void* weight, void* out, int B, int D, int H, int W,
                                  void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, strides, weight, out, B, D, H, W, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, strides, weight, out, B, D, H, W, s);
  return (int)cudaErrorInvalidValue;
}
