// The dense CRF's mean-field filter for Hopper (sm_90a): crf_filter.
//
// Replaces XLA code, not a TPU kernel: the exact normalized Gaussian filter
// of rcf_tpu/ops/crf.py::_normalized_filter (the JAX package runs it as
// chunked attention on XLA; its Pallas version lost on the TPU and was
// removed). For each image b and query pixel i,
//
//   out[b,i] = sum_j exp(l_ij) v[b,j] / sum_j exp(l_ij),
//   l_ij = f_i . f_j - |f_i|^2/2 - |f_j|^2/2 = -|f_i - f_j|^2/2   (the self term is in),
//
// over pixel features f [B,N,D] (D = 5: x, y, r, g, b scaled; D = 2: x, y).
//
// What bounds it: the ex2 unit. Each (query, key) pair needs one exp, on the
// multi-function unit (16 ex2 per SM per clock), and two FP32 instructions
// for the sums (128 lanes per SM): N^2 pairs an image (16 x 9216^2 for the
// DAVIS batch, 16 x 16384^2 for SegTrackv2) against O(N D) bytes. The dot
// product goes to the tensor cores, another unit, so the floor is N^2 ex2.
//
// Design. The logit in log2 units is one K = 8 dot of augmented operands,
//
//   q'_i = log2(e) [f_i - c, -|f_i - c|^2/2, 1, 0...],
//   k'_j =         [f_j - c, 1, -|f_j - c|^2/2, 0...],   q'_i . k'_j = l_ij log2(e),
//
// so the accumulator is the ex2's argument itself. A block of kWarps = 8
// warps takes 256 queries, 16 kTiles = 32 a warp; each warp keeps its
// queries' A fragments (hi and lo) in registers for the whole key loop. Each
// stage, every thread prepares one key (centre, half-norm, split) into shared
// memory as the B fragment of mma.m16n8k8, double-buffered, the next stage's
// raw features loaded into registers while this one computes: each staged
// key feeds all 256 queries. Per group of 8 keys and 16 queries: three
// mma.sync (the split below), ex2.approx.ftz of each accumulator element,
// num += w v_j (FFMA) and den += w (FADD) in f32 registers. The next group's
// products are issued before this group's ex2 (software pipelining), so the
// tensor cores and the multi-function unit work side by side; 64 registers
// a thread keep four blocks (32 warps) on an SM. A quad shuffle sums each
// row at the end. D and the tiling are compiled in; the batch rides the
// grid's z.
//
// Where it stands (PERF.md, tools/time_crf_variants.py): ~60% of the ex2
// floor on the DAVIS grid, ~70% on SegTrackv2's. Each half alone, the kernel
// without its ex2 or without its mma, reads ~80% / ~89% of the floor, and
// the two overlap only in part: mma.sync in TF32 runs well under the tensor
// cores' wgmma rate, and three products a group make the dot nearly as long
// as the ex2. A wgmma dot (m64nNk8, the keys' fragments from shared memory)
// is the next lever.
//
// Accuracy. The logits cancel half-norms of up to ~4e3 (rgb / srgb reaches
// 51 a channel): f32 keeps ~5e-4 of them, a single TF32 product ~1 (it
// moves q1 by 0.77 on the card). So each operand is split into TF32 parts,
// x = hi + lo (hi = cvt.rna(x), lo = cvt.rna(x - hi): ~22 bits), and the
// dot is hi.hi + hi.lo + lo.hi (lo.lo, ~2^-22 of a product, is dropped),
// each product exact in the tensor core, the sums in its f32 accumulator.
// Before the split both sides are centred on c, the midpoint of the block's
// queries' bounding box: the logit is exactly invariant to a translation,
// and the magnitudes, and with them the rounding, shrink (a model with
// float64 products reads 3e-4 from the exact logit at the recipes' scales,
// 1e-3 uncentred; tests/test_torch_crf.py). No running max: every logit is
// <= 0 up to that rounding. The self logit is no longer exactly 0 but within
// ~1e-3 of it, so den >= 1 holds to that rounding, and a logit that is
// positive by ~1e-3 cannot overflow ex2. ex2.approx.ftz (2^-22 relative)
// flushes weights under 2^-126 to 0, against den ~ 1.
//
// Ragged edges: queries past N are computed on the last pixel's features
// and not stored; keys past N are padded with k' = [0.., 1, -1e30, 0..],
// whose weight ex2(-1.4e30) is exactly 0, and value 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kTiles = 2;  // 16-query row tiles a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;  // blocks an SM: at most 64 registers a thread
constexpr int kQueries = 16 * kTiles * kWarps;  // queries a block
constexpr int kKeys = kThreads;  // keys a stage, one a thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadHalfNorm = 1e30f;  // a padded key's half-norm: its weight is exactly 0
constexpr float kInf = __builtin_huge_valf();

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (low 13 bits 0); x - hi is exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b for a 16 x 8 x 8 tile: a rows g, g + 8 and columns t, t + 4
// (a[0..3] = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)); b rows t, t + 4
// of column g; d (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), with
// g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Component k of the query operand q' of centred features fc.
template <int D>
__device__ __forceinline__ float query_component(const float (&fc)[D], float half_norm, int k) {
  float r = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) r = k == d ? __fmul_rn(kLog2e, fc[d]) : r;
  r = k == D ? __fmul_rn(-kLog2e, half_norm) : r;
  return k == D + 1 ? kLog2e : r;
}

template <int D>
__device__ __forceinline__ float centred_half_norm(const float* f, const float (&c)[D],
                                                   float (&fc)[D]) {
  float h = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    fc[d] = __fsub_rn(f[d], c[d]);
    h = __fmaf_rn(fc[d], fc[d], h);
  }
  return __fmul_rn(0.5f, h);
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
crf_filter_kernel(const float* __restrict__ feat, const float* __restrict__ values,
                  float* __restrict__ out, int n) {
  static_assert(D + 2 <= 8, "the augmented operands must fit K = 8");
  // Each stage's keys as B fragments: {hi[t], hi[t + 4], lo[t], lo[t + 4]} of
  // key 8 grp + g at [grp][4 g + t]; their values beside.
  __shared__ float4 s_key[2][kKeys / 8][32];
  __shared__ __align__(16) float s_val[2][kKeys];
  __shared__ float s_box[2][kWarps][D];
  __shared__ float s_centre[D];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t b = blockIdx.z;
  const float* fb = feat + b * n * D;
  const float* vb = values + b * n;
  const int q0 = blockIdx.x * kQueries;

  // The centre: the midpoint of the bounding box of the block's queries.
  float lo[D], hi[D];
#pragma unroll
  for (int d = 0; d < D; ++d) lo[d] = kInf, hi[d] = -kInf;
  for (int r = threadIdx.x; r < kQueries; r += kThreads) {
    const float* f = fb + (size_t)min(q0 + r, n - 1) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) lo[d] = fminf(lo[d], f[d]), hi[d] = fmaxf(hi[d], f[d]);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      lo[d] = fminf(lo[d], __shfl_xor_sync(0xffffffffu, lo[d], s));
      hi[d] = fmaxf(hi[d], __shfl_xor_sync(0xffffffffu, hi[d], s));
    }
    if (lane == 0) s_box[0][warp][d] = lo[d], s_box[1][warp][d] = hi[d];
  }
  __syncthreads();
  if (threadIdx.x < D) {
    float l = s_box[0][0][threadIdx.x], h = s_box[1][0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) {
      l = fminf(l, s_box[0][w][threadIdx.x]);
      h = fmaxf(h, s_box[1][w][threadIdx.x]);
    }
    s_centre[threadIdx.x] = 0.5f * (l + h);
  }
  __syncthreads();
  float c[D];
#pragma unroll
  for (int d = 0; d < D; ++d) c[d] = s_centre[d];

  // The warp's A fragments, hi and lo, for the whole key loop.
  uint32_t a_hi[kTiles][4], a_lo[kTiles][4];
#pragma unroll
  for (int m = 0; m < kTiles; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = min(q0 + (warp * kTiles + m) * 16 + g + 8 * half, n - 1);
      float fc[D];
      const float h = centred_half_norm<D>(fb + (size_t)i * D, c, fc);
      split(query_component<D>(fc, h, t), a_hi[m][half], a_lo[m][half]);
      split(query_component<D>(fc, h, t + 4), a_hi[m][2 + half], a_lo[m][2 + half]);
    }
  }

  // The thread's key of a stage (stage key r = threadIdx.x): raw features
  // and value, loaded a stage ahead.
  float kf[D], kv;
  auto load_key = [&](int j0) {
    const int j = j0 + threadIdx.x;
    const float* f = fb + (size_t)min(j, n - 1) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) kf[d] = f[d];
    kv = j < n ? vb[j] : 0.f;
  };
  auto store_key = [&](int buf, int j0) {
    const int r = threadIdx.x;
    const bool real = j0 + r < n;
    float kc[D];
    const float h = centred_half_norm<D>(kf, c, kc);
    float k[8] = {};
#pragma unroll
    for (int d = 0; d < D; ++d) k[d] = real ? kc[d] : 0.f;
    k[D] = 1.f;
    k[D + 1] = real ? -h : -kPadHalfNorm;
    uint32_t khi[8], klo[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) split(k[d], khi[d], klo[d]);
    const int grp = r >> 3, col = r & 7;
#pragma unroll
    for (int tt = 0; tt < 4; ++tt)
      s_key[buf][grp][4 * col + tt] =
          make_float4(__uint_as_float(khi[tt]), __uint_as_float(khi[tt + 4]),
                      __uint_as_float(klo[tt]), __uint_as_float(klo[tt + 4]));
    s_val[buf][r] = real ? kv : 0.f;
  };

  // The logits of one group of 8 keys for the warp's tiles: the three split
  // products, each over all tiles before the next, so that a tile's chain has
  // the other tiles' products between its steps.
  auto logits = [&](float (&acc)[kTiles][4], const float4 kb) {
    const uint32_t bh0 = __float_as_uint(kb.x), bh1 = __float_as_uint(kb.y);
    const uint32_t bl0 = __float_as_uint(kb.z), bl1 = __float_as_uint(kb.w);
#pragma unroll
    for (int m = 0; m < kTiles; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
#pragma unroll
    for (int m = 0; m < kTiles; ++m) mma_tf32(acc[m], a_lo[m], bh0, bh1);
#pragma unroll
    for (int m = 0; m < kTiles; ++m) mma_tf32(acc[m], a_hi[m], bl0, bl1);
#pragma unroll
    for (int m = 0; m < kTiles; ++m) mma_tf32(acc[m], a_hi[m], bh0, bh1);
  };
  float num[kTiles][2], den[kTiles][2];
#pragma unroll
  for (int m = 0; m < kTiles; ++m) num[m][0] = num[m][1] = den[m][0] = den[m][1] = 0.f;
  // The weights of a group (columns 2t, 2t + 1 of rows g, g + 8) into the sums.
  auto accumulate = [&](const float (&acc)[kTiles][4], const float2 v) {
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
      const float w0 = ex2(acc[m][0]), w1 = ex2(acc[m][1]);
      const float w2 = ex2(acc[m][2]), w3 = ex2(acc[m][3]);
      num[m][0] = __fmaf_rn(w1, v.y, __fmaf_rn(w0, v.x, num[m][0]));
      den[m][0] = __fadd_rn(den[m][0], __fadd_rn(w0, w1));
      num[m][1] = __fmaf_rn(w3, v.y, __fmaf_rn(w2, v.x, num[m][1]));
      den[m][1] = __fadd_rn(den[m][1], __fadd_rn(w2, w3));
    }
  };

  load_key(0);
  int buf = 0;
  for (int j0 = 0; j0 < n; j0 += kKeys) {
    store_key(buf, j0);
    __syncthreads();  // this stage's keys are in; the stage before last is read
    if (j0 + kKeys < n) load_key(j0 + kKeys);
    // Software-pipelined: the next group's products are issued before this
    // group's ex2, so the tensor cores and the multi-function unit overlap.
    const float2* val = reinterpret_cast<const float2*>(s_val[buf]) + t;
    float acc0[kTiles][4], acc1[kTiles][4];
    logits(acc0, s_key[buf][0][lane]);
#pragma unroll
    for (int grp = 0; grp < kKeys / 8; grp += 2) {
      logits(acc1, s_key[buf][grp + 1][lane]);
      accumulate(acc0, val[4 * grp]);
      if (grp + 2 < kKeys / 8) logits(acc0, s_key[buf][grp + 2][lane]);
      accumulate(acc1, val[4 * grp + 4]);
    }
    buf ^= 1;
  }

  // Each row's sums over the quad's columns; lane t = 0 stores.
#pragma unroll
  for (int m = 0; m < kTiles; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float nm = num[m][half], dn = den[m][half];
      nm += __shfl_xor_sync(0xffffffffu, nm, 1);
      dn += __shfl_xor_sync(0xffffffffu, dn, 1);
      nm += __shfl_xor_sync(0xffffffffu, nm, 2);
      dn += __shfl_xor_sync(0xffffffffu, dn, 2);
      const int i = q0 + (warp * kTiles + m) * 16 + g + 8 * half;
      if (t == 0 && i < n) out[b * n + i] = nm / dn;
    }
  }
}

}  // namespace

// feat [b, n, d] f32, values [b, n] f32 -> out [b, n] f32, all contiguous on
// the device; d in {2, 5}. Returns the launch's cudaError (0 when it launched).
extern "C" int rcf_crf_filter(const float* feat, const float* values, float* out, int64_t b,
                              int n, int d, void* stream) {
  if (b == 0 || n == 0) return 0;
  const dim3 grid((n + kQueries - 1) / kQueries, 1, (unsigned)b);
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
