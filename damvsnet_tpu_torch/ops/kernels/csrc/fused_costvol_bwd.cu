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
// sampling grid under no_grad), nor does inv = 1/(N-1). The TPU kernel's
// band DMAs, read-modify-write band accumulation and backward overflow flag
// exist because a TPU grid runs in order and cannot gather; here every tap
// is gathered and scattered directly, so nothing can overflow.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores), training stage 1 (B=4, V=4, D=64, 128x160, C=32, bf16): the
// cotangent is the dominant byte stream (335 MB; 413 MB with the features
// and the gradients, 0.12 ms); the fp32 arithmetic is about (14C + 60)
// operations per voxel and view to recompute the forward plus about
// 14C + 10 for the backward, 20 GFLOP (0.30 ms): bound by operations.
//
// What held the first version back (7.80 / 8.00 / 4.09 ms per training
// stage in bf16 on an H100 80GB HBM3 at 700 W, 22-26x its bound): one
// thread per reference pixel scattered dL/dwarp through the 4 taps with one
// 16-byte fp32 global atomic per 4 channels, B*D*H*W*V*4*C/4 atomics per
// launch (671 M at training stages 1 and 2), all through L2, with
// neighbouring lanes' atomics C*4 bytes apart; and each thread held three
// C-float arrays.
//
// Design: a block owns one batch element and a TH x TW tile of reference
// pixels; a pixel's channels are split over L = C / CL lanes (CL = 8 or 4
// channels a lane, per C in Tile<C>), so the cotangent, reference and tap
// reads are contiguous pieces across neighbouring lanes, and <w1, d2>,
// <ct, d2> are reduced over the L lanes with xor shuffles. The block loops
// over the views and, inside, the hypotheses, with no barrier in the loop.
//   - A lane keeps a run: its 4 taps' share of dL/dwarp summed in registers
//     over consecutive hypotheses whose taps sit on the same 2x2 source
//     pixels; a step of one pixel keeps the 2 taps that stay. A run's tap
//     ends when its pixel leaves the taps, and only then is it added out.
//   - Per view, the tile's footprint (the taps of each pixel's first and
//     last hypothesis: the projection is monotone in depth along a ray)
//     anchors a WH x WW window of the source plane in dynamic shared memory
//     (C + 1 floats a pixel, so neighbouring pixels fall in other banks).
//     Ended runs inside the window are added there with shared-memory
//     atomics, the rest straight to dsrc with 16-byte vector atomics. At
//     the end of the view the window's non-zero 4-channel pieces are
//     flushed to dsrc with 16-byte atomics. A footprint that does not fit
//     gets no window.
//   Measured on that card (scripts/ab_kernels_torch.py): shared-memory fp32
//   atomicAdd is not native on sm_90 (it compiles to a compare-and-swap
//   loop, ATOMS.CAST.SPIN), so a first version that scattered every tap
//   into a window re-anchored under block barriers ran at 4.9 / 10.6 /
//   6.0 ms per training stage with whole-range hypotheses at stages 2-3,
//   slower than the first design at stages 2 and 3; the runs keep those
//   adds rare. With ADIA-like narrow hypotheses a source element then takes
//   about one global atomic per view instead of about 4*D: 4.8 / 6.7 /
//   11.8 M atomics at the three training stages against 561 / 562 / 282 M,
//   and 2.2 / 2.4 / 2.2 ms in bf16 against 7.6 / 7.6 / 3.2; with the
//   whole-range hypotheses 2.2 / 3.4 / 3.6 ms against 7.6 / 7.8 / 3.8.
//   Occupancy is the other limit (the gathers' latency): CL = 4 with 3
//   blocks an SM at C = 16 and 8, CL = 8 with 2 at C = 32.
// dref stays in registers and is written once; the weight-net partials are
// reduced over the block and added with one atomic per value. Offsets
// inside a plane are 32-bit (the wrapper checks H * W * C < 2^31).
// Everything is fp32 whatever the feature dtype; the wrapper casts dref and
// dsrc to the feature dtype.
#include <limits.h>

#include "common.cuh"
#include "sampling.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Per channel count, as measured on an H100 at the training shapes: CL
// channels a lane (L = C / CL lanes a pixel), at least MB blocks an SM
// (MB = 3 caps registers at 80; fewer channels a lane keep that without
// spilling), SEL: a run moves by selects rather than branches, and the
// source window (WH x WW pixels, ~64 KB of fp32 at C + 1 floats a pixel).
// The reference tile is TH x TW = kThreads / L pixels.
template <int C>
struct Tile;
template <>
struct Tile<32> {
  static constexpr int CL = 8, MB = 2, WW = 30, WH = 16;
  static constexpr bool SEL = false;
};
template <>
struct Tile<16> {
  static constexpr int CL = 4, MB = 3, WW = 40, WH = 24;
  static constexpr bool SEL = false;
};
template <>
struct Tile<8> {
  static constexpr int CL = 4, MB = 3, WW = 56, WH = 32;
  static constexpr bool SEL = true;
};

template <int C>
struct Shape {
  static constexpr int CL = Tile<C>::CL, L = C / CL, P = kThreads / L;
  static constexpr int TW = P >= 128 ? 16 : 8, TH = P / TW;
  static constexpr int WW = Tile<C>::WW, WH = Tile<C>::WH, S = C + 1;
  static constexpr size_t kWindowBytes = sizeof(float) * WW * WH * S;
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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Add the window's non-zero 4-channel pieces into the source plane `dplane`
// at anchor (ax, ay) with 16-byte atomics and zero them. Returns the
// thread's count of global atomics.
template <int C>
__device__ __forceinline__ unsigned flush_window(float* win, float* dplane, int ax, int ay,
                                                 int W) {
  constexpr int WW = Tile<C>::WW, S = C + 1, Q = C / 4;
  unsigned n = 0;
  for (int e = threadIdx.x; e < WW * Tile<C>::WH * Q; e += kThreads) {
    const int wp = e / Q, q = e - wp * Q;
    float* s = win + wp * S + q * 4;
    const float a = s[0], b = s[1], c = s[2], d = s[3];
    if (a != 0.f || b != 0.f || c != 0.f || d != 0.f) {
      const int gy = ay + wp / WW, gx = ax + wp % WW;  // a written piece is in the plane
      atomic_add4(dplane + (gy * W + gx) * C + q * 4, a, b, c, d);
      s[0] = s[1] = s[2] = s[3] = 0.f;
      ++n;
    }
  }
  return n;
}

// A lane's run: its pixel's dL/dwarp times the tap weights (its CL
// channels), summed in registers over consecutive hypotheses whose 4 taps
// sit on the same 2x2 source pixels (tap k at (x0 + (k & 1), y0 + (k >> 1)));
// bit k of `dirty` is set where tap k holds a sum.
template <int CL>
struct Run {
  float acc[4][CL];
  int x0, y0;
  unsigned dirty;
};

// Where a run's tap sum goes when it ends: the window, or dsrc straight
// when its pixel is outside the window.
template <int C>
struct Sink {
  float* win;     // [WH][WW][C + 1]
  float* dplane;  // this view's [H, W, C] source gradient
  int ax, ay, W, c0;
  unsigned n_atomics;

  __device__ __forceinline__ void add(const float* a, int tx, int ty) {
    constexpr int WW = Tile<C>::WW, WH = Tile<C>::WH, CL = Tile<C>::CL;
    const unsigned wx = (unsigned)(tx - ax), wy = (unsigned)(ty - ay);
    if (wx < (unsigned)WW && wy < (unsigned)WH) {
      float* p = win + (wy * WW + wx) * (C + 1) + c0;
#pragma unroll
      for (int j = 0; j < CL; ++j) atomicAdd(p + j, a[j]);
    } else {
      float* p = dplane + (ty * W + tx) * C + c0;
#pragma unroll
      for (int j = 0; j < CL; j += 4) atomic_add4(p + j, a[j], a[j + 1], a[j + 2], a[j + 3]);
      n_atomics += CL / 4;
    }
  }
};

template <int C, int CL>
__device__ __forceinline__ void end_tap(Run<CL>& r, int k, Sink<C>& sink) {
  if (r.dirty & (1u << k)) sink.add(r.acc[k], r.x0 + (k & 1), r.y0 + (k >> 1));
}

template <int CL>
__device__ __forceinline__ void move_sum(Run<CL>& r, int to, int from) {
#pragma unroll
  for (int j = 0; j < CL; ++j) {
    r.acc[to][j] = r.acc[from][j];
    r.acc[from][j] = 0.f;
  }
}

// Move the run to taps at (x0, y0). A step of one pixel keeps the two taps
// that stay and ends the two that leave; any other move ends all four.
// With SEL the taps are remapped by selects, one path for every move; else
// by a branch per kind of step.
template <int C, int CL>
__device__ __forceinline__ void move_run(Run<CL>& r, int x0, int y0, Sink<C>& sink) {
  const int dx = x0 - r.x0, dy = y0 - r.y0;
  if constexpr (Tile<C>::SEL) {
    // tap k of the old block stays as tap k - dx - 2 dy of the new one
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool stays = (unsigned)((k & 1) - dx) < 2u && (unsigned)((k >> 1) - dy) < 2u;
      if (!stays) end_tap(r, k, sink);
    }
    float nacc[4][CL];
    unsigned ndirty = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int kx = (k & 1) + dx, ky = (k >> 1) + dy;
      const bool from = (unsigned)kx < 2u && (unsigned)ky < 2u;
      const int src = kx + 2 * ky;
#pragma unroll
      for (int j = 0; j < CL; ++j) {
        const float a01 = (src & 1) ? r.acc[1][j] : r.acc[0][j];
        const float a23 = (src & 1) ? r.acc[3][j] : r.acc[2][j];
        nacc[k][j] = from ? ((src & 2) ? a23 : a01) : 0.f;
      }
      if (from && (r.dirty & (1u << (src & 3)))) ndirty |= 1u << k;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < CL; ++j) r.acc[k][j] = nacc[k][j];
    r.dirty = ndirty;
    r.x0 = x0;
    r.y0 = y0;
    return;
  }
  if (dy == 0 && dx == 1) {
    end_tap(r, 0, sink); end_tap(r, 2, sink);
    move_sum(r, 0, 1); move_sum(r, 2, 3);
    r.dirty = (r.dirty >> 1) & 5u;
  } else if (dy == 0 && dx == -1) {
    end_tap(r, 1, sink); end_tap(r, 3, sink);
    move_sum(r, 1, 0); move_sum(r, 3, 2);
    r.dirty = (r.dirty << 1) & 10u;
  } else if (dx == 0 && dy == 1) {
    end_tap(r, 0, sink); end_tap(r, 1, sink);
    move_sum(r, 0, 2); move_sum(r, 1, 3);
    r.dirty = (r.dirty >> 2) & 3u;
  } else if (dx == 0 && dy == -1) {
    end_tap(r, 2, sink); end_tap(r, 3, sink);
    move_sum(r, 2, 0); move_sum(r, 3, 1);
    r.dirty = (r.dirty << 2) & 12u;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      end_tap(r, k, sink);
#pragma unroll
      for (int j = 0; j < CL; ++j) r.acc[k][j] = 0.f;
    }
    r.dirty = 0u;
  }
  r.x0 = x0;
  r.y0 = y0;
}

// params: w1[C], then b1, w2, b2, 1/(N-1). dparams: dw1[C], db1, dw2, db2.
// natomics (may be null): += the launch's count of 16-byte dsrc atomics.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, Tile<C>::MB)
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
                         unsigned long long* __restrict__ natomics,
                         int B, int D, int H, int W,
                         float sx, float ox, float sy, float oy) {
  using Sh = Shape<C>;
  constexpr int CL = Sh::CL, L = Sh::L, TW = Sh::TW, TH = Sh::TH;
  constexpr int WW = Sh::WW, WH = Sh::WH, S = Sh::S;
  static_assert(TW * TH * L == kThreads, "one lane group per tile pixel");
  extern __shared__ float win[];  // [WH][WW][C + 1]
  __shared__ float red[C + 3];
  __shared__ float w1s[C];
  __shared__ int box[2][4];  // per view parity: min x, min y, -max x, -max y of the taps
  __shared__ const T* srcs[kMaxViews];

  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.y, HW = H * W;
  const int tiles_x = (W + TW - 1) / TW;
  const int lp = tid / L, piece = tid % L, c0 = piece * CL;
  const int x = (blockIdx.x % tiles_x) * TW + lp % TW;
  const int y = (blockIdx.x / tiles_x) * TH + lp / TW;
  const bool live = x < W && y < H;
  const int pix = live ? y * W + x : 0;

  for (int i = tid; i < WW * WH * S; i += kThreads) win[i] = 0.f;
  if (tid < C + 3) red[tid] = 0.f;
  if (tid < C) w1s[tid] = params[tid];
  if (tid < 8) box[tid >> 2][tid & 3] = INT_MAX;
  // constant indices: a dynamic index into the parameter struct would copy
  // it to the stack
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v)
    if (tid == v && v < V) srcs[v] = reinterpret_cast<const T*>(src.p[v]) + b * src_bstride;

  float refv[CL], gref[CL], dw1[CL];
#pragma unroll
  for (int j = 0; j < CL; ++j) refv[j] = gref[j] = dw1[j] = 0.f;
  if (live) sweep::load_n<CL>(ref + b * ref_bstride + pix * C + c0, refv);
  const float b1 = params[C], w2 = params[C + 1], b2 = params[C + 2];
  const float inv_nm1 = params[C + 3];
  float db1 = 0.f, dw2 = 0.f, db2 = 0.f;
  Sink<C> sink{win, nullptr, 0, 0, W, c0, 0u};
  auto depth_at = [&](int d) {
    const long long bd = (long long)b * D + d;
    return dv_per_pixel ? (live ? dv[bd * HW + pix] : 1.f) : dv[bd];
  };

  for (int v = 0; v < V; ++v) {
    const float* g = geom + ((long long)v * B + b) * 12;
    float r[3];
    sweep::project_ray(g, (float)x, (float)y, r);
    const float trans[3] = {g[9], g[10], g[11]};

    // The tile's footprint: along a pixel's ray the projection is monotone
    // in depth, so the taps of its first and last hypothesis bound its taps
    // when its hypotheses are sorted (a sweep, ADIA's); a tap beyond the
    // estimate goes to dsrc straight. The view's window holds the footprint
    // when it fits, else there is no window: a shared-memory fp32 add is a
    // compare-and-swap loop on sm_90, dearer than a global 16-byte atomic
    // where runs are short, as they are where hypotheses spread wide.
    {
      int m[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
      for (int d = 0; d < D; d += max(D - 1, 1)) {
        const float depth = depth_at(d);
        float px, py;
        sweep::project_depth(r, trans, depth, sx, ox, sy, oy, px, py);
        const sweep::Taps t = sweep::bilinear_taps(px, py, H, W);
        if (live && t.ok) {
          m[0] = min(m[0], t.x0 + ((t.ok & 5u) ? 0 : 1));
          m[1] = min(m[1], t.y0 + ((t.ok & 3u) ? 0 : 1));
          m[2] = min(m[2], -(t.x0 + ((t.ok & 10u) ? 1 : 0)));
          m[3] = min(m[3], -(t.y0 + ((t.ok & 12u) ? 1 : 0)));
        }
      }
      int* bx = box[v & 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int mk = __reduce_min_sync(kFull, m[k]);
        if (lane == 0) atomicMin(bx + k, mk);
      }
      __syncthreads();
      const bool fits = bx[0] != INT_MAX &&  // the tile has a tap; then
                        bx[0] + bx[2] > -WW && bx[1] + bx[3] > -WH;  // -(extent - 1)
      sink.ax = fits ? bx[0] : -(1 << 29);
      sink.ay = fits ? bx[1] : -(1 << 29);
      if (tid < 4) box[(v + 1) & 1][tid] = INT_MAX;
    }
    sink.dplane = dsrc + ((long long)v * B + b) * HW * C;
    const T* base = srcs[v] + c0;
    Run<CL> run;
    run.x0 = run.y0 = -(1 << 29);
    run.dirty = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < CL; ++j) run.acc[k][j] = 0.f;

    float next = depth_at(0);  // the next hypothesis' depth, loaded a step ahead
    for (int d = 0; d < D; ++d) {
      const long long bd = (long long)b * D + d;
      const float depth = next;
      if (d + 1 < D) next = depth_at(d + 1);
      float px, py;
      sweep::project_depth(r, trans, depth, sx, ox, sy, oy, px, py);
      sweep::Taps t = sweep::bilinear_taps(px, py, H, W);
      if (!live) t.ok = 0u;

      // the forward's warp, then diff, then dL/dwarp
      float diff[CL], ct[CL];
#pragma unroll
      for (int j = 0; j < CL; ++j) diff[j] = ct[j] = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!(t.ok & (1u << k))) continue;
        float sv[CL];
        sweep::load_n<CL>(base + sweep::tap_pixel(t, k, W) * C, sv);
#pragma unroll
        for (int j = 0; j < CL; ++j) diff[j] = fmaf(t.wt[k], sv[j], diff[j]);
      }
      if (live) sweep::load_n<CL>(cot + (bd * HW + pix) * C + c0, ct);

      // s = <w1, d2>, q = <ct, d2> over the pixel's L lanes
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int j = 0; j < CL; ++j) {
        const float df = refv[j] - diff[j];
        diff[j] = df;
        const float d2 = df * df;
        s = fmaf(d2, w1s[c0 + j], s);
        q = fmaf(ct[j], d2, q);
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1) {
        s += __shfl_xor_sync(kFull, s, o);
        q += __shfl_xor_sync(kFull, q, o);
      }
      const float r1 = s + b1;
      const float relu1 = fmaxf(r1, 0.f);
      const float gpre = w2 * relu1 + b2;
      const float wgt1 = fmaxf(gpre, 0.f) + 1.f;
      const float qg = gpre > 0.f ? q * inv_nm1 : 0.f;  // dL/dg
      const float ds = r1 > 0.f ? qg * w2 : 0.f;          // dL/ds
      if (piece == 0) {
        db2 += qg;
        dw2 += qg * relu1;
        db1 += ds;
      }
      const float ctw = inv_nm1 * wgt1;
#pragma unroll
      for (int j = 0; j < CL; ++j) {
        const float df = diff[j];
        dw1[j] = fmaf(df * df, ds, dw1[j]);
        const float dd2 = fmaf(ds, w1s[c0 + j], ct[j] * ctw);
        const float ddiff = 2.f * df * dd2;
        gref[j] += ddiff;
        diff[j] = -ddiff;
      }

      // the taps' share, into the run
      if (t.ok) {
        if (t.x0 != run.x0 || t.y0 != run.y0) move_run(run, t.x0, t.y0, sink);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!(t.ok & (1u << k))) continue;
#pragma unroll
          for (int j = 0; j < CL; ++j) run.acc[k][j] = fmaf(t.wt[k], diff[j], run.acc[k][j]);
        }
        run.dirty |= t.ok;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) end_tap(run, k, sink);
    __syncthreads();
    sink.n_atomics += flush_window<C>(win, sink.dplane, sink.ax, sink.ay, W);
  }

  if (live) {
    float* o = dref + ((long long)b * HW + pix) * C + c0;
#pragma unroll
    for (int j = 0; j < CL; j += 4)
      *reinterpret_cast<float4*>(o + j) = make_float4(gref[j], gref[j + 1], gref[j + 2], gref[j + 3]);
  }

  // block reduction of the weight-net partials, one atomic per value; the
  // lanes of one piece hold the same channels
#pragma unroll
  for (int j = 0; j < CL; ++j) {
    float sum = dw1[j];
#pragma unroll
    for (int o = L; o < 32; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
    if (lane < L) atomicAdd(red + c0 + j, sum);
  }
  {
    const float r0 = warp_sum(db1), r1 = warp_sum(dw2), r2 = warp_sum(db2);
    if (lane == 0) {
      atomicAdd(red + C, r0);
      atomicAdd(red + C + 1, r1);
      atomicAdd(red + C + 2, r2);
    }
  }
  if (natomics) {
    const unsigned n = __reduce_add_sync(kFull, sink.n_atomics);
    if (lane == 0) atomicAdd(natomics, (unsigned long long)n);
  }
  __syncthreads();
  if (tid < C + 3) atomicAdd(dparams + tid, red[tid]);
}

template <typename T, int C>
cudaError_t launch(const void* ref, long long ref_bstride, const SrcPtrs& src,
                   long long src_bstride, int V, const float* geom, const float* dv,
                   int dv_per_pixel, const float* params, const void* cot, float* dref,
                   float* dsrc, float* dparams, unsigned long long* natomics, int B, int D,
                   int H, int W, float sx, float ox, float sy, float oy,
                   cudaStream_t stream) {
  constexpr size_t smem = Shape<C>::kWindowBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_costvol_bwd_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = ((W + Shape<C>::TW - 1) / Shape<C>::TW) * ((H + Shape<C>::TH - 1) / Shape<C>::TH);
  fused_costvol_bwd_kernel<T, C><<<dim3((unsigned)tiles, (unsigned)B), kThreads, smem, stream>>>(
      reinterpret_cast<const T*>(ref), ref_bstride, src, src_bstride, V, geom, dv,
      dv_per_pixel, params, reinterpret_cast<const T*>(cot), dref, dsrc, dparams, natomics,
      B, D, H, W, sx, ox, sy, oy);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16
// (of ref, the sources and the cotangent). src_ptrs is a HOST array of V
// device pointers, one [H, W, C] plane per (view, batch) at src_ptrs[v] +
// b * src_bstride elements. dsrc and dparams must be zeroed by the caller.
// natomics, if not null, is a device counter that the launch adds its
// number of 16-byte dsrc atomics to. Returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported C, V or
// dtype).
extern "C" int fused_costvol_bwd_launch(const void* ref, long long ref_bstride,
                                        const void* const* src_ptrs, long long src_bstride,
                                        int V, const float* geom, const float* dv,
                                        int dv_per_pixel, const float* params,
                                        const void* cot, float* dref, float* dsrc,
                                        float* dparams, unsigned long long* natomics, int B,
                                        int D, int H, int W, int C, int dtype, float sx,
                                        float ox, float sy, float oy, void* stream) {
  SrcPtrs src;
  if (!src_planes(src_ptrs, V, src)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)dispatch_dtype_c(dtype, C, [&](auto t, auto c) {
    return launch<typename decltype(t)::type, decltype(c)::value>(
        ref, ref_bstride, src, src_bstride, V, geom, dv, dv_per_pixel, params, cot, dref, dsrc,
        dparams, natomics, B, D, H, W, sx, ox, sy, oy, s);
  });
}
