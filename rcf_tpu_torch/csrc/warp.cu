// Bilinear warp, its coordinate backward, and the forward splat, for Hopper (sm_90a).
//
// Replaces the four TPU kernels of rcf_tpu/ops/pallas/warp_pallas.py:
//   * warp_fwd       <- _warp_fwd_kernel         (warp_pallas -> _warp_fwd_impl)
//   * warp_bwd       <- _warp_bwd_kernel_nodimg  (_warp_bwd_rule, need_dimg=False)
//   * warp_bwd_dimg  <- _warp_bwd_kernel         (_warp_bwd_rule, need_dimg=True)
//   * splat          <- _splat_kernel            (splat_pallas)
//
// What they compute (the TPU kernels' values, not their band/hat-matmul design):
//   warp_fwd:  out[b,p,c] = sum over the 4 taps (x0|x0+1, y0|y0+1) of
//              hat(cy-y) * hat(cx-x) * img[b,y,x,c], taps outside the image weigh 0.
//              That is grid_sample(align_corners=True, padding_mode="zeros") at
//              absolute pixel coordinates; "border" is the caller clamping cx, cy
//              to the image box first.
//   warp_bwd:  dcx[b,p], dcy[b,p] = sum_c g[b,p,c] * d out[b,p,c] / d(cx|cy), with
//              the forward recomputed and the TPU kernel's hat-derivative convention
//              (warp_pallas.py::_dhat): the derivative is 0 at an exact-integer
//              coordinate. No image cotangent.
//   warp_bwd_dimg: warp_bwd's dcx, dcy plus the image cotangent
//              dimg[b,tap,c] += g[b,p,c] * (tap's bilinear weight at p), an f32
//              overlap-add into the source taps; taps outside the image get
//              nothing (pad="zeros", and the clamp of pad="border").
//   splat:     out[b,y,x] += hat(ty-y) * hat(tx-x) for the 4 corners of each source
//              pixel, corners outside [0,h) x [0,w) dropped.
//
// Design. A block of 32 x 8 threads on a 2-D tile of pixels, so that the vertical
// taps (rows y0 and y0+1) of the tile's rows meet in L1 and a warp's taps fall on
// one row's neighbouring pixels. The batch is blockIdx.z with a 64-bit plane base
// taken once; offsets inside a plane are 32-bit (the wrappers raise where a plane
// does not fit). The streams (cx, cy, g in; out, dcx, dcy out) move evict-first,
// coalesced across the warp. The channel count is a template argument (instances
// for C = 1..4, one generic instance above), so the 4*C tap loads (__ldg, bf16 too)
// issue before the first FMA. warp_fwd and warp_bwd take one pixel a thread.
// warp_bwd and warp_bwd_dimg are one template: the image cotangent is a
// compile-time flag.
//
// The overlap-add (warp_bwd_dimg's dimg, the splat) is privatized per block: the
// TPU kernels keep a VMEM accumulator across their sequential grid steps; Hopper
// blocks run in no order, so each block accumulates its own taps in a window of
// shared memory and adds the window to device memory once. Each thread loads the
// coordinates of its pixels (AddShape::pixels, kTY rows apart); the window is the
// box of cells that the block's valid taps touch (one block reduction), cut to at
// most AddShape::win_floats f32 around its centre. A tap inside it is a
// shared-memory f32 atomicAdd; a tap outside it (a far-out flow, or a box past the
// capacity) is a device-memory atomicAdd, chosen per tap. After a barrier the block
// adds the window row by row, coalesced: a float4 reduction (RED.E.ADD.F32x4) for
// each aligned quad of a row that lies wholly inside it, scalar atomics for the
// quads at the row's head and tail, and nothing for a quad of zeros. Shared memory
// starts each row at the row's device address modulo 16 bytes, so the quads line up
// in both. About 4*C scattered device atomics a pixel (each its own L2 sector, the
// L2's atomic rate the limit) become shared-memory atomics and about one coalesced
// reduction of a sector. On sm_90 a shared f32 atomicAdd is a compare-and-swap loop
// (ATOMS.CAST.SPIN) whose latency only warps in flight hide: hence the register
// caps (AddShape::min_blocks), the splat's four pixels a thread (the window's zero
// fill, reduction and flush shared by 1,024 pixels) at 32 registers, and, for even
// C, a cell's channels added in pairs by one 64-bit compare-and-swap (PERF.md has
// the variants timed). Weights and sums are f32 for f32 and bf16 images alike (the
// TPU kernel casts its hat weights to bf16; the difference is about 2^-9 relative).
// The sums are taken in an order that changes from run to run (shared and device
// atomics), into a buffer the caller zero-fills.
//
// Bound on the H100 (3.35 TB/s, bytes over operations by far): at the AMD level-0
// shape B=8, H x W = 384 x 640, C=3, f32 images,
//   warp_fwd  reads img 23.6 MB + cx, cy 15.7 MB, writes out 23.6 MB: 62.9 MB, 18.8 us;
//   warp_bwd  reads img 23.6 + cx, cy 15.7 + g 23.6, writes dcx, dcy 15.7: 78.6 MB, 23.5 us;
//   splat     (2B = 16 maps) reads tx, ty 31.5 MB, writes 15.7 MB: 47.2 MB, 14.1 us, and
//             62.9 MB, 18.8 us with the output's zero fill;
//   warp_bwd_dimg at C=2 (a flow, where the system calls it) reads img 15.7 + cx, cy
//             15.7 + g 15.7, writes dimg 15.7 + dcx, dcy 15.7: 78.6 MB, 23.5 us, and
//             94.4 MB, 28.2 us with the dimg buffer's zero fill.
//
// C interface, bound with ctypes: every entry point launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;  // pixels (threads) per block along x
constexpr int kTY = 8;   // and rows per block
constexpr int kThreads = kBX * kTY;
// cx, cy, g, out, dcx, dcy are each touched once: load and store them evict-first
// (ld.global.cs / st.global.cs), so that they leave the image's lines in L2.
constexpr bool kStream = true;
// The shape of an overlap-add kernel: pixels a thread (kTY rows apart: a tile of
// 32 x 8*pixels), the blocks an SM must hold (a register cap: the shared atomics'
// latency needs warps in flight), and the window's capacity in f32.
struct AddShape {
  int pixels, min_blocks, win_floats;
};
constexpr AddShape kSplatShape{4, 7, 4096};
constexpr AddShape kDimgShape{1, 8, 4096};
// Window rows of at most kWinW cells, the width cut so that kWinMinRows rows fit.
constexpr int kWinW = 128;
constexpr int kWinMinRows = 16;
// A test build (kCountTaps = true) counts the taps that took each branch of the
// overlap-add: [0] the shared window, [1] device memory (rcf_tap_counts).
constexpr bool kCountTaps = false;
__device__ unsigned long long g_tap_counts[2];

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// A stream's loads and stores.
__device__ __forceinline__ float load_s(const float* p) { return kStream ? __ldcs(p) : __ldg(p); }
__device__ __forceinline__ float load_s(const __nv_bfloat16* p) {
  return __bfloat162float(kStream ? __ldcs(p) : __ldg(p));
}
__device__ __forceinline__ void store_s(float* p, float v) {
  if (kStream) __stcs(p, v); else *p = v;
}
__device__ __forceinline__ void store_s(__nv_bfloat16* p, float v) {
  if (kStream) __stcs(p, __float2bfloat16(v)); else *p = __float2bfloat16(v);
}

// The four taps of a bilinear sample at (x, y). Validity is decided on the float
// coordinates, so a far-out or non-finite coordinate never becomes an index.
struct Taps {
  float ax, ay;            // fractional parts: weight of the +1 tap on each axis
  int xi, yi;              // the (0, 0) tap's cell, where a tap of its row/column is valid
  int o00, o01, o10, o11;  // pixel offsets in the [H, W] plane
  bool v00, v01, v10, v11;
};

__device__ __forceinline__ Taps make_taps(float x, float y, int h, int w) {
  Taps t;
  const float xf = floorf(x), yf = floorf(y);
  t.ax = x - xf;
  t.ay = y - yf;
  const bool vx0 = xf >= 0.f && xf <= (float)(w - 1);
  const bool vx1 = xf >= -1.f && xf <= (float)(w - 2);
  const bool vy0 = yf >= 0.f && yf <= (float)(h - 1);
  const bool vy1 = yf >= -1.f && yf <= (float)(h - 2);
  t.xi = (vx0 || vx1) ? (int)xf : 0;
  t.yi = (vy0 || vy1) ? (int)yf : 0;
  t.v00 = vy0 && vx0;
  t.v01 = vy0 && vx1;
  t.v10 = vy1 && vx0;
  t.v11 = vy1 && vx1;
  t.o00 = t.yi * w + t.xi;
  t.o01 = t.o00 + 1;
  t.o10 = t.o00 + w;
  t.o11 = t.o10 + 1;
  return t;
}

// A coordinate no tap of which is valid: the pixels of a block past the image.
__device__ __forceinline__ float no_coord() { return __int_as_float(0x7fffffff); }

template <typename T>
__device__ __forceinline__ float tap(const T* plane, int off, bool valid, int c, int ch) {
  return valid ? load_f(plane + off * c + ch) : 0.f;
}

// The pixel (x, y) of this thread in its plane, the p-th of the P pixels that each
// thread of a block takes, kTY rows apart (a tile of kBX x P*kTY); false past the image.
template <int P = 1>
__device__ __forceinline__ bool thread_pixel(int h, int w, int& x, int& y, int p = 0) {
  x = blockIdx.x * kBX + threadIdx.x;
  y = (blockIdx.y * P + p) * kTY + threadIdx.y;
  return x < w && y < h;
}

// The 4*C tap values of one sample, all loads issued together.
template <int C, typename T>
__device__ __forceinline__ void gather(const T* plane, const Taps& t, float (&v)[4][C]) {
  const int o[4] = {t.o00 * C, t.o01 * C, t.o10 * C, t.o11 * C};
  const bool ok[4] = {t.v00, t.v01, t.v10, t.v11};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[k][ch] = ok[k] ? load_f(plane + o[k] + ch) : 0.f;
  }
}

// ---------------------------------------------------------------- the overlap-add

// The block's window onto one [h, w, c] f32 plane of device memory: cells
// [x0, x0 + ww) x [y0, y0 + wh), c floats each, in shared memory rows of `pitch`
// floats (a multiple of 4). Row y starts (mis + (y*w + x0)*c) mod 4 floats into its
// pitch, where mis is the plane's address in floats mod 4: shared and device memory
// then agree modulo 16 bytes. An empty window (ww = wh = 0) sends every tap to
// device memory.
struct Window {
  int x0, y0, ww, wh, pitch, mis;
};

__device__ __forceinline__ int thread_rank() { return threadIdx.y * kBX + threadIdx.x; }

// The index in shared memory of the cell (window.x0, y), for y inside the window.
__device__ __forceinline__ int win_row(const Window& v, int y, int w, int c) {
  return (y - v.y0) * v.pitch + (int)((unsigned)(v.mis + (y * w + v.x0) * c) & 3u);
}

// The window of the taps of the block's pixels: the box of cells that their valid
// taps touch (one block reduction), cut to the capacity around its centre, zeroed in
// shared memory. Every thread of the block calls it, with the coordinates of its P
// pixels (no_coord() past the image).
template <int P, int kFloats>
__device__ __forceinline__ Window open_window(float* win, int4* red, const float (&xs)[P],
                                              const float (&ys)[P], const float* plane, int h,
                                              int w, int c) {
  const int big = 0x7fffffff;
  int lx = big, hx = -big, ly = big, hy = -big;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const Taps t = make_taps(xs[p], ys[p], h, w);
    if (t.v00 || t.v01 || t.v10 || t.v11) {
      lx = min(lx, max(t.xi, 0));
      hx = max(hx, min(t.xi + 1, w - 1));
      ly = min(ly, max(t.yi, 0));
      hy = max(hy, min(t.yi + 1, h - 1));
    }
  }
  lx = __reduce_min_sync(0xffffffffu, lx);
  hx = __reduce_max_sync(0xffffffffu, hx);
  ly = __reduce_min_sync(0xffffffffu, ly);
  hy = __reduce_max_sync(0xffffffffu, hy);
  const int rank = thread_rank();
  if ((rank & 31) == 0) red[rank >> 5] = make_int4(lx, hx, ly, hy);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) {
    const int4 r = red[k];
    lx = min(lx, r.x);
    hx = max(hx, r.y);
    ly = min(ly, r.z);
    hy = max(hy, r.w);
  }
  Window v;
  v.mis = (int)(((uintptr_t)plane >> 2) & 3);
  v.x0 = v.y0 = v.ww = v.wh = 0;
  v.pitch = 4;
  const int max_w = min(kWinW, (kFloats / kWinMinRows - 6) / c);
  if (lx <= hx && max_w >= 1) {
    v.x0 = lx;
    v.y0 = ly;
    v.ww = hx - lx + 1;
    v.wh = hy - ly + 1;
    if (v.ww > max_w) {
      v.x0 += (v.ww - max_w) / 2;
      v.ww = max_w;
    }
    v.pitch = (v.ww * c + 6) & ~3;  // room for the row's shift of up to 3 floats
    const int max_h = kFloats / v.pitch;
    if (v.wh > max_h) {
      v.y0 += (v.wh - max_h) / 2;
      v.wh = max_h;
    }
  }
  for (int k = rank; k < v.wh * v.pitch / 4; k += kThreads) {
    reinterpret_cast<float4*>(win)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  return v;
}

// f32 atomicAdd of (a, b) to the 8-byte aligned pair s[0], s[1] of shared memory:
// one 64-bit compare-and-swap where two atomicAdds would make two 32-bit ones.
__device__ __forceinline__ void shared_add2(float* s, float a, float b) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(s);
  unsigned long long seen, old = *p;
  do {
    seen = old;
    const float lo = __uint_as_float((unsigned)seen) + a;
    const float hi = __uint_as_float((unsigned)(seen >> 32)) + b;
    old = atomicCAS(p, seen,
                    ((unsigned long long)__float_as_uint(hi) << 32) | __float_as_uint(lo));
  } while (old != seen);
}

// Adds val(ch) * weight for the sample's four taps: into the window where the tap
// lies inside it, else straight into device memory.
template <int C, typename Val>
__device__ __forceinline__ void win_add(float* win, const Window& v, float* plane,
                                        const Taps& t, int w, int c, Val val) {
  const int cc = C > 0 ? C : c;
  const float bx = 1.f - t.ax, by = 1.f - t.ay;
  const float wt[4] = {by * bx, by * t.ax, t.ay * bx, t.ay * t.ax};
  const bool ok[4] = {t.v00, t.v01, t.v10, t.v11};
  const int off[4] = {t.o00, t.o01, t.o10, t.o11};
  // Which of the taps' two columns and two rows the window holds.
  const bool inx[2] = {(unsigned)(t.xi - v.x0) < (unsigned)v.ww,
                       (unsigned)(t.xi + 1 - v.x0) < (unsigned)v.ww};
  const bool iny[2] = {(unsigned)(t.yi - v.y0) < (unsigned)v.wh,
                       (unsigned)(t.yi + 1 - v.y0) < (unsigned)v.wh};
  const int cell[2] = {win_row(v, t.yi, w, cc) + (t.xi - v.x0) * cc,
                       win_row(v, t.yi + 1, w, cc) + (t.xi - v.x0) * cc};
  // Even C on an even plane address (the wrappers' buffers): cells start 8-byte
  // aligned, and a cell's channels go in pairs, one 64-bit compare-and-swap each.
  constexpr bool kPairs = C > 0 && C % 2 == 0;
  const bool pairs = kPairs && (v.mis & 1) == 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // A zero weight (integer coordinate) adds nothing; skipping it saves the atomic.
    if (!ok[k] || wt[k] == 0.f) continue;
    if (inx[k & 1] && iny[k >> 1]) {
      if (kCountTaps) atomicAdd(&g_tap_counts[0], 1ull);
      float* s = win + cell[k >> 1] + (k & 1) * cc;
      if (pairs) {
#pragma unroll
        for (int ch = 0; ch < cc; ch += 2) shared_add2(s + ch, val(ch) * wt[k], val(ch + 1) * wt[k]);
      } else {
#pragma unroll
        for (int ch = 0; ch < cc; ++ch) atomicAdd(s + ch, val(ch) * wt[k]);
      }
    } else {
      if (kCountTaps) atomicAdd(&g_tap_counts[1], 1ull);
      float* d = plane + off[k] * cc;
#pragma unroll
      for (int ch = 0; ch < cc; ++ch) atomicAdd(d + ch, val(ch) * wt[k]);
    }
  }
}

// After a barrier: adds the window into device memory, row by row, coalesced: a
// float4 reduction for each aligned quad wholly inside its row, scalar atomics for
// the quads at the row's head and tail (their cells outside the row are zeros in
// shared memory), none for a quad of zeros.
__device__ __forceinline__ void win_flush(const float* win, const Window& v, float* plane,
                                          int w, int c) {
  const int nq = v.pitch >> 2, width = v.ww * c, n = v.wh * nq;
  int k = thread_rank(), r = k / nq, j = k - r * nq;  // quad k = (row r, quad j of the row)
  const int dr = kThreads / nq, dj = kThreads - dr * nq;
  for (; k < n; k += kThreads) {
    const int q = 4 * j;
    const int g = ((v.y0 + r) * w + v.x0) * c;  // the row's first float in the plane
    const int m = (int)((unsigned)(v.mis + g) & 3u);
    const float4 s = *reinterpret_cast<const float4*>(win + r * v.pitch + q);
    r += dr;
    j += dj;
    if (j >= nq) {
      j -= nq;
      ++r;
    }
    if (s.x == 0.f && s.y == 0.f && s.z == 0.f && s.w == 0.f) continue;
    float* d = plane + (g - m + q);
    if (q >= m && q + 4 <= m + width) {
      atomicAdd(reinterpret_cast<float4*>(d), s);
    } else {
      if (s.x != 0.f) atomicAdd(d, s.x);
      if (s.y != 0.f) atomicAdd(d + 1, s.y);
      if (s.z != 0.f) atomicAdd(d + 2, s.z);
      if (s.w != 0.f) atomicAdd(d + 3, s.w);
    }
  }
}

// dcx, dcy of the pixel i of the plane whose first pixel is plane_px, from its taps
// and the output cotangent, stored with the _dhat rule where the pixel is inside the
// image; gv receives g's C channels (C > 0), zeros outside.
template <typename T, int C>
__device__ __forceinline__ void pixel_grads(const T* __restrict__ img, const T* __restrict__ g,
                                            int64_t plane_px, int64_t i, bool inside,
                                            const Taps& t, int c, float* __restrict__ dcx,
                                            float* __restrict__ dcy, float (&gv)[C > 0 ? C : 1]) {
  const float bx = 1.f - t.ax, by = 1.f - t.ay;
  float sx = 0.f, sy = 0.f;
  if constexpr (C > 0) {
    float v[4][C];
    gather<C>(img + plane_px * C, t, v);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) gv[ch] = inside ? load_s(g + i * C + ch) : 0.f;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      sx += gv[ch] * (by * (v[1][ch] - v[0][ch]) + t.ay * (v[3][ch] - v[2][ch]));
      sy += gv[ch] * (bx * (v[2][ch] - v[0][ch]) + t.ax * (v[3][ch] - v[1][ch]));
    }
  } else {
    const T* plane = img + plane_px * c;
    for (int ch = 0; ch < c; ++ch) {
      const float gc = inside ? load_s(g + i * c + ch) : 0.f;
      const float v00 = tap(plane, t.o00, t.v00, c, ch);
      const float v01 = tap(plane, t.o01, t.v01, c, ch);
      const float v10 = tap(plane, t.o10, t.v10, c, ch);
      const float v11 = tap(plane, t.o11, t.v11, c, ch);
      sx += gc * (by * (v01 - v00) + t.ay * (v11 - v10));
      sy += gc * (bx * (v10 - v00) + t.ax * (v11 - v01));
    }
  }
  // _dhat: an exact-integer coordinate sits on the kink, where the TPU kernel's
  // derivative is 0 (a NaN coordinate propagates through the products above).
  if (inside) {
    store_s(dcx + i, t.ax == 0.f ? 0.f : sx);
    store_s(dcy + i, t.ay == 0.f ? 0.f : sy);
  }
}

// ---------------------------------------------------------------- kernels

// C > 0: the channel count at compile time; C == 0: the generic instance, c channels.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
warp_fwd_kernel(const T* __restrict__ img, const float* __restrict__ cx,
                const float* __restrict__ cy, T* __restrict__ out, int h, int w, int c) {
  int x, y;
  if (!thread_pixel(h, w, x, y)) return;
  const int64_t plane_px = (int64_t)blockIdx.z * h * w;
  const int64_t i = plane_px + y * w + x;
  const Taps t = make_taps(load_s(cx + i), load_s(cy + i), h, w);
  const float bx = 1.f - t.ax, by = 1.f - t.ay;
  if constexpr (C > 0) {
    float v[4][C];
    gather<C>(img + plane_px * C, t, v);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const float top = v[0][ch] * bx + v[1][ch] * t.ax;
      const float bot = v[2][ch] * bx + v[3][ch] * t.ax;
      store_s(out + i * C + ch, top * by + bot * t.ay);
    }
  } else {
    const T* plane = img + plane_px * c;
    for (int ch = 0; ch < c; ++ch) {
      const float top = tap(plane, t.o00, t.v00, c, ch) * bx + tap(plane, t.o01, t.v01, c, ch) * t.ax;
      const float bot = tap(plane, t.o10, t.v10, c, ch) * bx + tap(plane, t.o11, t.v11, c, ch) * t.ax;
      store_s(out + i * c + ch, top * by + bot * t.ay);
    }
  }
}

// The backward: warp_bwd (kDimg false: one pixel a thread) and warp_bwd_dimg (kDimg
// true: kDimgShape.pixels a thread, and the image cotangent overlap-added into
// dimg, an f32 [B,H,W,C] buffer of zeros). Each has its own entry point below, for
// its own launch bounds.
template <typename T, int C, bool kDimg>
__device__ __forceinline__ void warp_bwd_body(const T* __restrict__ img,
                                              const float* __restrict__ cx,
                                              const float* __restrict__ cy,
                                              const T* __restrict__ g, float* __restrict__ dimg,
                                              float* __restrict__ dcx, float* __restrict__ dcy,
                                              int h, int w, int c) {
  const int64_t plane_px = (int64_t)blockIdx.z * h * w;
  float gv[C > 0 ? C : 1];
  if constexpr (!kDimg) {
    int x, y;
    if (!thread_pixel(h, w, x, y)) return;
    const int64_t i = plane_px + y * w + x;
    const Taps t = make_taps(load_s(cx + i), load_s(cy + i), h, w);
    pixel_grads<T, C>(img, g, plane_px, i, true, t, c, dcx, dcy, gv);
  } else {
    constexpr int P = kDimgShape.pixels;
    __shared__ __align__(16) float win[kDimgShape.win_floats];
    __shared__ int4 red[kThreads / 32];
    const int cc = C > 0 ? C : c;
    float xs[P], ys[P];
    bool inside[P];
    int64_t idx[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      int x, y;
      inside[p] = thread_pixel<P>(h, w, x, y, p);
      idx[p] = plane_px + y * w + x;
      xs[p] = inside[p] ? load_s(cx + idx[p]) : no_coord();
      ys[p] = inside[p] ? load_s(cy + idx[p]) : no_coord();
    }
    float* plane = dimg + plane_px * cc;
    const Window v = open_window<P, kDimgShape.win_floats>(win, red, xs, ys, plane, h, w, cc);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const Taps t = make_taps(xs[p], ys[p], h, w);
      pixel_grads<T, C>(img, g, plane_px, idx[p], inside[p], t, c, dcx, dcy, gv);
      win_add<C>(win, v, plane, t, w, c, [&](int ch) {
        if constexpr (C > 0) return gv[ch];
        else return inside[p] ? load_f(g + idx[p] * c + ch) : 0.f;
      });
    }
    __syncthreads();
    win_flush(win, v, plane, w, cc);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
warp_bwd_kernel(const T* __restrict__ img, const float* __restrict__ cx,
                const float* __restrict__ cy, const T* __restrict__ g,
                float* __restrict__ dimg, float* __restrict__ dcx, float* __restrict__ dcy,
                int h, int w, int c) {
  warp_bwd_body<T, C, false>(img, cx, cy, g, dimg, dcx, dcy, h, w, c);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, kDimgShape.min_blocks)
warp_bwd_dimg_kernel(const T* __restrict__ img, const float* __restrict__ cx,
                     const float* __restrict__ cy, const T* __restrict__ g,
                     float* __restrict__ dimg, float* __restrict__ dcx,
                     float* __restrict__ dcy, int h, int w, int c) {
  warp_bwd_body<T, C, true>(img, cx, cy, g, dimg, dcx, dcy, h, w, c);
}

// Source pixels [B, sh, sw], kSplatShape.pixels a thread; the density is [B, h, w].
__global__ void __launch_bounds__(kThreads, kSplatShape.min_blocks)
splat_kernel(const float* __restrict__ tx, const float* __restrict__ ty,
             float* __restrict__ out, int sh, int sw, int h, int w) {
  constexpr int P = kSplatShape.pixels;
  __shared__ __align__(16) float win[kSplatShape.win_floats];
  __shared__ int4 red[kThreads / 32];
  float xs[P], ys[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    int x, y;
    const bool inside = thread_pixel<P>(sh, sw, x, y, p);
    const int64_t i = (int64_t)blockIdx.z * sh * sw + y * sw + x;
    xs[p] = inside ? load_s(tx + i) : no_coord();
    ys[p] = inside ? load_s(ty + i) : no_coord();
  }
  float* plane = out + (int64_t)blockIdx.z * h * w;
  const Window v = open_window<P, kSplatShape.win_floats>(win, red, xs, ys, plane, h, w, 1);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    win_add<1>(win, v, plane, make_taps(xs[p], ys[p], h, w), w, 1, [](int) { return 1.f; });
  }
  __syncthreads();
  win_flush(win, v, plane, w, 1);
}

// n = B*H*W pixels of [B, H, W] planes, tiles of kBX x rows; the batch goes to gridDim.z.
inline dim3 tile_grid(int64_t n, int h, int w, int rows = kTY) {
  return dim3((unsigned int)((w + kBX - 1) / kBX),
              (unsigned int)((h + rows - 1) / rows), (unsigned int)(n / ((int64_t)h * w)));
}

// The instance for c channels: C = c for 1..4, the generic instance (C = 0) above.
inline int instance(int c) { return c >= 1 && c <= 4 ? c : 0; }

template <typename T>
int launch_warp_fwd(const void* img, const void* cx, const void* cy, void* out, int64_t n,
                    int h, int w, int c, void* stream) {
  using Kernel = void (*)(const T*, const float*, const float*, T*, int, int, int);
  const Kernel kernels[] = {warp_fwd_kernel<T, 0>, warp_fwd_kernel<T, 1>, warp_fwd_kernel<T, 2>,
                            warp_fwd_kernel<T, 3>, warp_fwd_kernel<T, 4>};
  if (n > 0) {
    kernels[instance(c)]<<<tile_grid(n, h, w), dim3(kBX, kTY), 0, (cudaStream_t)stream>>>(
        (const T*)img, (const float*)cx, (const float*)cy, (T*)out, h, w, c);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kDimg>
int launch_warp_bwd(const void* img, const void* cx, const void* cy, const void* g, void* dimg,
                    void* dcx, void* dcy, int64_t n, int h, int w, int c, void* stream) {
  using Kernel = void (*)(const T*, const float*, const float*, const T*, float*, float*,
                          float*, int, int, int);
  const Kernel plain[] = {warp_bwd_kernel<T, 0>, warp_bwd_kernel<T, 1>, warp_bwd_kernel<T, 2>,
                          warp_bwd_kernel<T, 3>, warp_bwd_kernel<T, 4>};
  const Kernel with_dimg[] = {warp_bwd_dimg_kernel<T, 0>, warp_bwd_dimg_kernel<T, 1>,
                              warp_bwd_dimg_kernel<T, 2>, warp_bwd_dimg_kernel<T, 3>,
                              warp_bwd_dimg_kernel<T, 4>};
  const Kernel* kernels = kDimg ? with_dimg : plain;
  if (n > 0) {
    const dim3 grid = tile_grid(n, h, w, kDimg ? kTY * kDimgShape.pixels : kTY);
    kernels[instance(c)]<<<grid, dim3(kBX, kTY), 0, (cudaStream_t)stream>>>(
        (const T*)img, (const float*)cx, (const float*)cy, (const T*)g, (float*)dimg,
        (float*)dcx, (float*)dcy, h, w, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rcf_warp_fwd_f32(const void* img, const void* cx, const void* cy, void* out, int64_t n,
                     int h, int w, int c, void* stream) {
  return launch_warp_fwd<float>(img, cx, cy, out, n, h, w, c, stream);
}

int rcf_warp_fwd_bf16(const void* img, const void* cx, const void* cy, void* out, int64_t n,
                      int h, int w, int c, void* stream) {
  return launch_warp_fwd<__nv_bfloat16>(img, cx, cy, out, n, h, w, c, stream);
}

int rcf_warp_bwd_f32(const void* img, const void* cx, const void* cy, const void* g, void* dcx,
                     void* dcy, int64_t n, int h, int w, int c, void* stream) {
  return launch_warp_bwd<float, false>(img, cx, cy, g, nullptr, dcx, dcy, n, h, w, c, stream);
}

int rcf_warp_bwd_bf16(const void* img, const void* cx, const void* cy, const void* g, void* dcx,
                      void* dcy, int64_t n, int h, int w, int c, void* stream) {
  return launch_warp_bwd<__nv_bfloat16, false>(img, cx, cy, g, nullptr, dcx, dcy, n, h, w, c,
                                               stream);
}

// dimg must be an f32 [B,H,W,C] buffer filled with zeros by the caller.
int rcf_warp_bwd_dimg_f32(const void* img, const void* cx, const void* cy, const void* g,
                          void* dimg, void* dcx, void* dcy, int64_t n, int h, int w, int c,
                          void* stream) {
  return launch_warp_bwd<float, true>(img, cx, cy, g, dimg, dcx, dcy, n, h, w, c, stream);
}

int rcf_warp_bwd_dimg_bf16(const void* img, const void* cx, const void* cy, const void* g,
                           void* dimg, void* dcx, void* dcy, int64_t n, int h, int w, int c,
                           void* stream) {
  return launch_warp_bwd<__nv_bfloat16, true>(img, cx, cy, g, dimg, dcx, dcy, n, h, w, c,
                                              stream);
}

// n = B*sh*sw source pixels; out must be an f32 [B,h,w] buffer filled with zeros.
int rcf_splat(const void* tx, const void* ty, void* out, int64_t n, int sh, int sw, int h, int w,
              void* stream) {
  if (n > 0) {
    splat_kernel<<<tile_grid(n, sh, sw, kTY * kSplatShape.pixels), dim3(kBX, kTY), 0,
                   (cudaStream_t)stream>>>(
        (const float*)tx, (const float*)ty, (float*)out, sh, sw, h, w);
  }
  return (int)cudaGetLastError();
}

// The tap counters of a test build (kCountTaps): copies {window, device memory} to
// out and, with reset, sets them to 0. A release build reads zeros.
int rcf_tap_counts(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_tap_counts, sizeof(g_tap_counts));
  if (err == cudaSuccess && reset) {
    const unsigned long long zeros[2] = {0, 0};
    err = cudaMemcpyToSymbol(g_tap_counts, zeros, sizeof(zeros));
  }
  return (int)err;
}

}  // extern "C"
