// The dense CRF's mean-field filter for Hopper (sm_90a): crf_filter.
//
// Replaces XLA code, not a TPU kernel: the exact normalized Gaussian filter
// of rcf_tpu/ops/crf.py::_normalized_filter (the JAX package runs it as
// chunked attention on XLA; its Pallas version lost on the TPU and was
// removed). For each image b and query pixel i,
//
//   out[b,i] = sum_j exp(l_ij) v[b,j] / sum_j exp(l_ij),
//   l_ij = f_i . f_j - |f_i|^2/2 - |f_j|^2/2   (<= 0; the self term is in),
//
// over pixel features f [B,N,D] (D = 5: x, y, r, g, b scaled; D = 2: x, y).
//
// What bounds it: operations. Each (query, key) pair costs D FMAs, two
// subtractions, one exp and two adds, with nothing read from device memory:
// N^2 pairs per image (16 x 9216^2 for the DAVIS batch, 16 x 16384^2 for
// SegTrackv2) against O(N D) bytes. The exp runs on the multi-function unit
// (16 ex2 per SM per clock), the rest on the FP32 pipes (128 lanes per SM).
//
// Design, simple first: one thread per query pixel, kThreads queries a
// block; the keys in tiles of kThreads, each key's features, half-norm and
// value staged in shared memory as float4s (read by every thread of the
// block: a broadcast); num and den in f32 registers; D compiled in; the
// batch in the grid's z; a ragged N by bounds (the last tile holds fewer
// keys, threads past N load and compute but do not store). No running max:
// every logit is <= 0 and the self term's is exactly 0 (dot and half-norms
// use one instruction sequence, so f.f - h - h == 0), so den >= 1.
// The logits cancel terms of ~10^3 (|f|^2/2 at srgb = 5), so they keep
// f32 throughout: no TF32, no bf16.
//
// exp: __expf (ex2.approx of l * log2(e)). Its error, a few ulp of the
// result, is far under that of the logit itself (~1e-3 absolute from the
// cancellation above), and it flushes weights under 2^-126 to 0, against
// den >= 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // queries per block = keys per shared tile

// The dot product and the half-norm share one instruction sequence (no
// contraction choices left to the compiler), so a pixel's self logit is 0.
template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) s = __fmaf_rn(a[d], b[d], s);
  return s;
}

template <int D>
__device__ __forceinline__ float half_norm(const float* a) {
  return __fmul_rn(0.5f, dot<D>(a, a));
}

// One key's record in shared memory: features, half-norm, value, padding.
template <int D>
struct Key {
  static constexpr int kVec = (D + 2 + 3) / 4;
  float4 v[kVec];
};

template <int D>
__device__ __forceinline__ void accumulate(const Key<D>& key, const float* q, float qh,
                                           float& num, float& den) {
  const Key<D> k = key;  // whole float4s out of shared memory (LDS.128, a broadcast)
  const float* r = reinterpret_cast<const float*>(k.v);
  const float l = __fsub_rn(__fsub_rn(dot<D>(q, r), r[D]), qh);
  const float w = __expf(l);
  num = __fmaf_rn(w, r[D + 1], num);
  den = __fadd_rn(den, w);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
crf_filter_kernel(const float* __restrict__ feat, const float* __restrict__ values,
                  float* __restrict__ out, int n) {
  __shared__ Key<D> tile[kThreads];
  const size_t b = blockIdx.z;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* fb = feat + b * n * D;
  const float* vb = values + b * n;

  float q[D];
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = i < n ? fb[(size_t)i * D + d] : 0.f;
  const float qh = half_norm<D>(q);

  float num = 0.f, den = 0.f;
  for (int k0 = 0; k0 < n; k0 += kThreads) {
    const int j = k0 + threadIdx.x;
    Key<D> rec;
    float* r = reinterpret_cast<float*>(rec.v);
#pragma unroll
    for (int c = 0; c < 4 * Key<D>::kVec; ++c) r[c] = 0.f;
    if (j < n) {
#pragma unroll
      for (int d = 0; d < D; ++d) r[d] = fb[(size_t)j * D + d];
      r[D] = half_norm<D>(r);
      r[D + 1] = vb[j];
    }
    tile[threadIdx.x] = rec;
    __syncthreads();
    const int cnt = n - k0;
    if (cnt >= kThreads) {
#pragma unroll 8
      for (int t = 0; t < kThreads; ++t) accumulate<D>(tile[t], q, qh, num, den);
    } else {
      for (int t = 0; t < cnt; ++t) accumulate<D>(tile[t], q, qh, num, den);
    }
    __syncthreads();
  }
  if (i < n) out[b * n + i] = num / den;
}

}  // namespace

// feat [b, n, d] f32, values [b, n] f32 -> out [b, n] f32, all contiguous on
// the device; d in {2, 5}. Returns the launch's cudaError (0 when it launched).
extern "C" int rcf_crf_filter(const float* feat, const float* values, float* out, int64_t b,
                              int n, int d, void* stream) {
  if (b == 0 || n == 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, 1, (unsigned)b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 5:
      crf_filter_kernel<5><<<grid, kThreads, 0, s>>>(feat, values, out, n);
      break;
    case 2:
      crf_filter_kernel<2><<<grid, kThreads, 0, s>>>(feat, values, out, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
