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
// Design: one thread per output pixel (per source pixel for the splat), a direct
// 4-tap gather from the NHWC image, looping over the channels. Weights and sums
// are f32 for f32 and bf16 images alike (the TPU kernel casts its hat weights to
// bf16; the difference is about 2^-9 relative). The splat accumulates with f32
// atomicAdd, so its sums are taken in an order that changes from run to run, and
// so does warp_bwd_dimg's image cotangent (f32 atomicAdd into a buffer the caller
// zero-fills; the TPU kernel's band-window matmul overlap-add does not carry over:
// Hopper blocks run in no order and share no accumulator).
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
// The gather touches each source pixel about once for smooth flows, and the
// neighbouring threads of a warp read neighbouring pixels, so the loads coalesce
// through L1/L2; nothing is staged in shared memory.
//
// C interface, bound with ctypes: every entry point launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The four taps of a bilinear sample at (x, y). Validity is decided on the float
// coordinates, so a far-out or non-finite coordinate never becomes an index.
struct Taps {
  float ax, ay;           // fractional parts: weight of the +1 tap on each axis
  int64_t o00, o01, o10, o11;  // pixel offsets in the [H, W] plane
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
  const int64_t xi = (vx0 || vx1) ? (int64_t)xf : 0;
  const int64_t yi = (vy0 || vy1) ? (int64_t)yf : 0;
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

template <typename T>
__device__ __forceinline__ float tap(const T* plane, int64_t off, bool valid, int c, int ch) {
  return valid ? load_f(plane + off * c + ch) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_fwd_kernel(const T* __restrict__ img, const float* __restrict__ cx,
                const float* __restrict__ cy, T* __restrict__ out, int64_t n, int h, int w,
                int c) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t hw = (int64_t)h * w;
  const T* plane = img + (i / hw) * hw * c;
  const Taps t = make_taps(__ldg(cx + i), __ldg(cy + i), h, w);
  const float bx = 1.f - t.ax, by = 1.f - t.ay;
  for (int ch = 0; ch < c; ++ch) {
    const float v00 = tap(plane, t.o00, t.v00, c, ch);
    const float v01 = tap(plane, t.o01, t.v01, c, ch);
    const float v10 = tap(plane, t.o10, t.v10, c, ch);
    const float v11 = tap(plane, t.o11, t.v11, c, ch);
    const float top = v00 * bx + v01 * t.ax;
    const float bot = v10 * bx + v11 * t.ax;
    store_f(out + i * c + ch, top * by + bot * t.ay);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_bwd_kernel(const T* __restrict__ img, const float* __restrict__ cx,
                const float* __restrict__ cy, const T* __restrict__ g,
                float* __restrict__ dcx, float* __restrict__ dcy, int64_t n, int h, int w,
                int c) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t hw = (int64_t)h * w;
  const T* plane = img + (i / hw) * hw * c;
  const Taps t = make_taps(__ldg(cx + i), __ldg(cy + i), h, w);
  const float bx = 1.f - t.ax, by = 1.f - t.ay;
  float sx = 0.f, sy = 0.f;
  for (int ch = 0; ch < c; ++ch) {
    const float gc = load_f(g + i * c + ch);
    const float v00 = tap(plane, t.o00, t.v00, c, ch);
    const float v01 = tap(plane, t.o01, t.v01, c, ch);
    const float v10 = tap(plane, t.o10, t.v10, c, ch);
    const float v11 = tap(plane, t.o11, t.v11, c, ch);
    sx += gc * (by * (v01 - v00) + t.ay * (v11 - v10));
    sy += gc * (bx * (v10 - v00) + t.ax * (v11 - v01));
  }
  // _dhat: an exact-integer coordinate sits on the kink, where the TPU kernel's
  // derivative is 0 (a NaN coordinate propagates through the products above).
  dcx[i] = t.ax == 0.f ? 0.f : sx;
  dcy[i] = t.ay == 0.f ? 0.f : sy;
}

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
  const Taps t = make_taps(__ldg(cx + i), __ldg(cy + i), h, w);
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
  const Taps t = make_taps(__ldg(tx + i), __ldg(ty + i), h, w);
  const float bx = 1.f - t.ax, by = 1.f - t.ay;
  // A zero weight (integer coordinate) adds nothing; skipping it saves the atomic.
  const float w00 = by * bx, w01 = by * t.ax, w10 = t.ay * bx, w11 = t.ay * t.ax;
  if (t.v00 && w00 != 0.f) atomicAdd(plane + t.o00, w00);
  if (t.v01 && w01 != 0.f) atomicAdd(plane + t.o01, w01);
  if (t.v10 && w10 != 0.f) atomicAdd(plane + t.o10, w10);
  if (t.v11 && w11 != 0.f) atomicAdd(plane + t.o11, w11);
}

inline unsigned int blocks_for(int64_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

template <typename T>
int launch_warp_fwd(const void* img, const void* cx, const void* cy, void* out, int64_t n,
                    int h, int w, int c, void* stream) {
  if (n > 0) {
    warp_fwd_kernel<T><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)img, (const float*)cx, (const float*)cy, (T*)out, n, h, w, c);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_warp_bwd(const void* img, const void* cx, const void* cy, const void* g, void* dcx,
                    void* dcy, int64_t n, int h, int w, int c, void* stream) {
  if (n > 0) {
    warp_bwd_kernel<T><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)img, (const float*)cx, (const float*)cy, (const T*)g, (float*)dcx,
        (float*)dcy, n, h, w, c);
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
