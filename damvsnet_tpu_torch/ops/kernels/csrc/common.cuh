// What every kernel source shares: the fp32 / bf16 conversions, the source
// views of one launch (kMaxViews, SrcPtrs) and the dispatch of an entry
// point's dtype code and channel count to a template instantiation.
//
// The names sit in an anonymous namespace, as each source's own copies
// did: every library is one translation unit, and the kernels whose
// parameters name SrcPtrs keep the names the benchmark reads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// source views of one launch (ops/kernels/_common.py MAX_VIEWS)
constexpr int kMaxViews = 16;

// the source views' planes, passed by value among a kernel's parameters
struct SrcPtrs {
  const void* p[kMaxViews];
};

// src.p[v] = ptrs[v], a HOST array of V device pointers, and null past V;
// false for a V outside 1..kMaxViews
inline bool src_planes(const void* const* ptrs, int V, SrcPtrs& src) {
  if (V < 1 || V > kMaxViews) return false;
  for (int v = 0; v < kMaxViews; ++v) src.p[v] = v < V ? ptrs[v] : nullptr;
  return true;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// one rounding to nearest even, as torch's .to(torch.bfloat16)
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
struct Type {
  using type = T;
};

// f(Type<T>{}) for the element type of an entry point's dtype code:
// 0 = float32, 1 = bfloat16; cudaErrorInvalidValue for any other code
template <typename F>
cudaError_t dispatch_dtype(int dtype, F&& f) {
  if (dtype == 0) return f(Type<float>{});
  if (dtype == 1) return f(Type<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

// f(Type<T>{}, std::integral_constant<int, C>{}) for a dtype code and a
// channel count C of 8, 16 or 32 (the plane-sweep kernels' vectors);
// cudaErrorInvalidValue for any other
template <typename F>
cudaError_t dispatch_dtype_c(int dtype, int C, F&& f) {
  return dispatch_dtype(dtype, [&](auto t) -> cudaError_t {
    switch (C) {
      case 8:
        return f(t, std::integral_constant<int, 8>{});
      case 16:
        return f(t, std::integral_constant<int, 16>{});
      case 32:
        return f(t, std::integral_constant<int, 32>{});
      default:
        return cudaErrorInvalidValue;
    }
  });
}

}  // namespace
