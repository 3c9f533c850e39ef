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
// Design. warp_fwd and warp_bwd: one thread per output pixel, a block on a 2-D
// tile of 32 x 8 pixels, so that the vertical taps (rows y0 and y0+1) of the
// tile's rows meet in L1 and a warp's gathers fall on one row's neighbouring
// pixels. The channel count is a template argument (instances for C = 1..4, one
// generic instance above), so the 4*C tap loads (__ldg, bf16 too) issue before the
// first FMA. The batch is blockIdx.z with a 64-bit plane base taken once; offsets
// inside a plane are 32-bit (the wrapper raises where H*W*C does not fit). The
// streams (cx, cy, g in; out, dcx, dcy out) move evict-first, coalesced across the
// warp. On the H100 this beat or tied the other designs timed against it
// (PERF.md): 1-D runs of one row; 2 to 8 pixels a thread, adjacent with vector
// I/O or strided; out and g staged through shared memory as vectors; default
// caching of the streams.
// warp_bwd_dimg and the splat: one thread per output (source) pixel in 1-D blocks,
// a direct 4-tap gather with 64-bit offsets, looping over the channels.
// Weights and sums are f32 for f32 and bf16 images alike (the TPU kernel casts its
// hat weights to bf16; the difference is about 2^-9 relative). The splat
// accumulates with f32 atomicAdd, so its sums are taken in an order that changes
// from run to run, and so does warp_bwd_dimg's image cotangent (f32 atomicAdd into
// a buffer the caller zero-fills; the TPU kernel's band-window matmul overlap-add
// does not carry over: Hopper blocks run in no order and share no accumulator).
//
// Bound on the H100 (3.35 TB/s, bytes over operations by far): at the AMD level-0
// shape B=8, H x W = 384 x 640, C=3, f32 images,
//   warp_fwd  reads img 23.6 MB + cx, cy 15.7 MB, writes out 23.6 MB: 62.9 MB, 18.8 us;
//   warp_bwd  reads img 23.6 + cx, cy 15.7 + g 23.6, writes dcx, dcy 15.7: 78.6 MB, 23.5 us;
//   splat     (2B = 16 maps) reads tx, ty 31.5 MB, writes 15.7 MB: 47.2 MB, 14.1 us;
//   warp_bwd_dimg at C=2 (a flow, where the system calls it) reads img 15.7 + cx, cy
//             15.7 + g 15.7, writes dimg 15.7 + dcx, dcy 15.7: 78.6 MB, 23.5 us, and
//             94.4 MB, 28.2 us with the dimg buffer's zero fill; at C=3, 102.2 MB
//             without the fill, 30.5 us. Its atomics land on 4 neighbouring taps
//             per pixel and rarely collide for smooth flows.
// The gather touches each source pixel about once for smooth flows, so a tile's
// taps come from L1/L2 and only the streams and the image's first touch reach
// device memory.
//
// C interface, bound with ctypes: every entry point launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // warp_bwd_dimg and the splat: 1-D blocks

constexpr int kBX = 32;  // warp_fwd, warp_bwd: pixels (threads) per block along x
constexpr int kTY = 8;   // and rows per block
// cx, cy, g, out, dcx, dcy are each touched once: load and store them evict-first
// (ld.global.cs / st.global.cs), so that they leave the image's lines in L2.
constexpr bool kStream = true;

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
// I is the offset type: int inside one plane (warp_fwd, warp_bwd), int64_t else.
template <typename I>
struct Taps {
  float ax, ay;       // fractional parts: weight of the +1 tap on each axis
  I o00, o01, o10, o11;  // pixel offsets in the [H, W] plane
  bool v00, v01, v10, v11;
};

template <typename I>
__device__ __forceinline__ Taps<I> make_taps(float x, float y, int h, int w) {
  Taps<I> t;
  const float xf = floorf(x), yf = floorf(y);
  t.ax = x - xf;
  t.ay = y - yf;
  const bool vx0 = xf >= 0.f && xf <= (float)(w - 1);
  const bool vx1 = xf >= -1.f && xf <= (float)(w - 2);
  const bool vy0 = yf >= 0.f && yf <= (float)(h - 1);
  const bool vy1 = yf >= -1.f && yf <= (float)(h - 2);
  const I xi = (vx0 || vx1) ? (I)xf : 0;
  const I yi = (vy0 || vy1) ? (I)yf : 0;
  t.v00 = vy0 && vx0;
  t.v01 = vy0 && vx1;
  t.v10 = vy1 && vx0;
  t.v11 = vy1 && vx1;
  t.o00 = yi * w + xi;
  t.o01 = t.o00 + 1;
  t.o10 = t.o00 + w;
  t.o11 = t.o10 + 1;
  return t;
}

template <typename T, typename I>
__device__ __forceinline__ float tap(const T* plane, I off, bool valid, int c, int ch) {
  return valid ? load_f(plane + off * c + ch) : 0.f;
}

// ---------------------------------------------------------------- warp_fwd, warp_bwd

// The pixel (x, y) of this thread in its plane; false past the image.
__device__ __forceinline__ bool thread_pixel(int h, int w, int& x, int& y) {
  x = blockIdx.x * kBX + threadIdx.x;
  y = blockIdx.y * kTY + threadIdx.y;
  return x < w && y < h;
}

// The 4*C tap values of one sample, all loads issued together.
template <int C, typename T>
__device__ __forceinline__ void gather(const T* plane, const Taps<int>& t, float (&v)[4][C]) {
  const int o[4] = {t.o00 * C, t.o01 * C, t.o10 * C, t.o11 * C};
  const bool ok[4] = {t.v00, t.v01, t.v10, t.v11};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[k][ch] = ok[k] ? load_f(plane + o[k] + ch) : 0.f;
  }
}

// C > 0: the channel count at compile time; C == 0: the generic instance, c channels.
template <typename T, int C>
__global__ void __launch_bounds__(kBX * kTY)
warp_fwd_kernel(const T* __restrict__ img, const float* __restrict__ cx,
                const float* __restrict__ cy, T* __restrict__ out, int h, int w, int c) {
  int x, y;
  if (!thread_pixel(h, w, x, y)) return;
  const int64_t plane_px = (int64_t)blockIdx.z * h * w;
  const int64_t i = plane_px + y * w + x;
  const Taps<int> t = make_taps<int>(load_s(cx + i), load_s(cy + i), h, w);
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

template <typename T, int C>
__global__ void __launch_bounds__(kBX * kTY)
warp_bwd_kernel(const T* __restrict__ img, const float* __restrict__ cx,
                const float* __restrict__ cy, const T* __restrict__ g,
                float* __restrict__ dcx, float* __restrict__ dcy, int h, int w, int c) {
  int x, y;
  if (!thread_pixel(h, w, x, y)) return;
  const int64_t plane_px = (int64_t)blockIdx.z * h * w;
  const int64_t i = plane_px + y * w + x;
  const Taps<int> t = make_taps<int>(load_s(cx + i), load_s(cy + i), h, w);
  const float bx = 1.f - t.ax, by = 1.f - t.ay;
  float sx = 0.f, sy = 0.f;
  if constexpr (C > 0) {
    float v[4][C], gv[C];
    gather<C>(img + plane_px * C, t, v);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) gv[ch] = load_s(g + i * C + ch);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      sx += gv[ch] * (by * (v[1][ch] - v[0][ch]) + t.ay * (v[3][ch] - v[2][ch]));
      sy += gv[ch] * (bx * (v[2][ch] - v[0][ch]) + t.ax * (v[3][ch] - v[1][ch]));
    }
  } else {
    const T* plane = img + plane_px * c;
    for (int ch = 0; ch < c; ++ch) {
      const float gc = load_s(g + i * c + ch);
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
  store_s(dcx + i, t.ax == 0.f ? 0.f : sx);
  store_s(dcy + i, t.ay == 0.f ? 0.f : sy);
}

// ---------------------------------------------------------------- warp_bwd_dimg, splat

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_bwd_dimg_kernel(const T* __restrict__ img, const float* __restrict__ cx,
                     const float* __restrict__ cy, const T* __restrict__ g,
                     float* __restrict__ dimg, float* __restrict__ dcx,
                     float* __restrict__ dcy, int64_t n, int h, int w, int c) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t hw = (int64_t)h * w;
  const int64_t base = (i / hw) * hw * c;
  const T* plane = img + base;
  float* dplane = dimg + base;
  const Taps<int64_t> t = make_taps<int64_t>(__ldg(cx + i), __ldg(cy + i), h, w);
  const float bx = 1.f - t.ax, by = 1.f - t.ay;
  const float w00 = by * bx, w01 = by * t.ax, w10 = t.ay * bx, w11 = t.ay * t.ax;
  float sx = 0.f, sy = 0.f;
  for (int ch = 0; ch < c; ++ch) {
    const float gc = load_f(g + i * c + ch);
    const float v00 = tap(plane, t.o00, t.v00, c, ch);
    const float v01 = tap(plane, t.o01, t.v01, c, ch);
    const float v10 = tap(plane, t.o10, t.v10, c, ch);
    const float v11 = tap(plane, t.o11, t.v11, c, ch);
    sx += gc * (by * (v01 - v00) + t.ay * (v11 - v10));
    sy += gc * (bx * (v10 - v00) + t.ax * (v11 - v01));
    // A zero weight (integer coordinate) adds nothing; skipping it saves the atomic.
    if (t.v00 && w00 != 0.f) atomicAdd(dplane + t.o00 * c + ch, gc * w00);
    if (t.v01 && w01 != 0.f) atomicAdd(dplane + t.o01 * c + ch, gc * w01);
    if (t.v10 && w10 != 0.f) atomicAdd(dplane + t.o10 * c + ch, gc * w10);
    if (t.v11 && w11 != 0.f) atomicAdd(dplane + t.o11 * c + ch, gc * w11);
  }
  dcx[i] = t.ax == 0.f ? 0.f : sx;
  dcy[i] = t.ay == 0.f ? 0.f : sy;
}

__global__ void __launch_bounds__(kThreads)
splat_kernel(const float* __restrict__ tx, const float* __restrict__ ty,
             float* __restrict__ out, int64_t n, int64_t src_hw, int h, int w) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float* plane = out + (i / src_hw) * (int64_t)h * w;
  const Taps<int64_t> t = make_taps<int64_t>(__ldg(tx + i), __ldg(ty + i), h, w);
  const float bx = 1.f - t.ax, by = 1.f - t.ay;
  // A zero weight (integer coordinate) adds nothing; skipping it saves the atomic.
  const float w00 = by * bx, w01 = by * t.ax, w10 = t.ay * bx, w11 = t.ay * t.ax;
  if (t.v00 && w00 != 0.f) atomicAdd(plane + t.o00, w00);
  if (t.v01 && w01 != 0.f) atomicAdd(plane + t.o01, w01);
  if (t.v10 && w10 != 0.f) atomicAdd(plane + t.o10, w10);
  if (t.v11 && w11 != 0.f) atomicAdd(plane + t.o11, w11);
}

inline unsigned int blocks_for(int64_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

// n = B*H*W pixels; the batch goes to gridDim.z.
inline dim3 warp_grid(int64_t n, int h, int w) {
  return dim3((unsigned int)((w + kBX - 1) / kBX),
              (unsigned int)((h + kTY - 1) / kTY), (unsigned int)(n / ((int64_t)h * w)));
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
    kernels[instance(c)]<<<warp_grid(n, h, w), dim3(kBX, kTY), 0, (cudaStream_t)stream>>>(
        (const T*)img, (const float*)cx, (const float*)cy, (T*)out, h, w, c);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_warp_bwd(const void* img, const void* cx, const void* cy, const void* g, void* dcx,
                    void* dcy, int64_t n, int h, int w, int c, void* stream) {
  using Kernel = void (*)(const T*, const float*, const float*, const T*, float*, float*, int,
                          int, int);
  const Kernel kernels[] = {warp_bwd_kernel<T, 0>, warp_bwd_kernel<T, 1>, warp_bwd_kernel<T, 2>,
                            warp_bwd_kernel<T, 3>, warp_bwd_kernel<T, 4>};
  if (n > 0) {
    kernels[instance(c)]<<<warp_grid(n, h, w), dim3(kBX, kTY), 0, (cudaStream_t)stream>>>(
        (const T*)img, (const float*)cx, (const float*)cy, (const T*)g, (float*)dcx,
        (float*)dcy, h, w, c);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_warp_bwd_dimg(const void* img, const void* cx, const void* cy, const void* g,
                         void* dimg, void* dcx, void* dcy, int64_t n, int h, int w, int c,
                         void* stream) {
  if (n > 0) {
    warp_bwd_dimg_kernel<T><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)img, (const float*)cx, (const float*)cy, (const T*)g, (float*)dimg,
        (float*)dcx, (float*)dcy, n, h, w, c);
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
  return launch_warp_bwd<float>(img, cx, cy, g, dcx, dcy, n, h, w, c, stream);
}

int rcf_warp_bwd_bf16(const void* img, const void* cx, const void* cy, const void* g, void* dcx,
                      void* dcy, int64_t n, int h, int w, int c, void* stream) {
  return launch_warp_bwd<__nv_bfloat16>(img, cx, cy, g, dcx, dcy, n, h, w, c, stream);
}

// dimg must be an f32 [B,H,W,C] buffer filled with zeros by the caller.
int rcf_warp_bwd_dimg_f32(const void* img, const void* cx, const void* cy, const void* g,
                          void* dimg, void* dcx, void* dcy, int64_t n, int h, int w, int c,
                          void* stream) {
  return launch_warp_bwd_dimg<float>(img, cx, cy, g, dimg, dcx, dcy, n, h, w, c, stream);
}

int rcf_warp_bwd_dimg_bf16(const void* img, const void* cx, const void* cy, const void* g,
                           void* dimg, void* dcx, void* dcy, int64_t n, int h, int w, int c,
                           void* stream) {
  return launch_warp_bwd_dimg<__nv_bfloat16>(img, cx, cy, g, dimg, dcx, dcy, n, h, w, c,
                                             stream);
}

int rcf_splat(const void* tx, const void* ty, void* out, int64_t n, int64_t src_hw, int h,
              int w, void* stream) {
  if (n > 0) {
    splat_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)tx, (const float*)ty, (float*)out, n, src_hw, h, w);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
