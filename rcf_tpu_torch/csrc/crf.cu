// The dense CRF's mean-field filter for Hopper (sm_90a): crf_filter.
//
// Replaces XLA code, not a TPU kernel: the exact normalized Gaussian filter
// of rcf_tpu/ops/crf.py::_normalized_filter (the JAX package runs it as
// chunked attention on XLA; its Pallas version lost on the TPU and was
// removed). For each image b and pixel i,
//
//   out[b,i] = sum_j exp(l_ij) v[b,j] / sum_j exp(l_ij),
//   l_ij = f_i . f_j - |f_i|^2/2 - |f_j|^2/2 = -|f_i - f_j|^2/2   (the self term is in),
//
// over pixel features f [B,N,D] (D = 5: x, y, r, g, b scaled; D = 2: x, y).
//
// What bounds it: each pair's logit (a dot, on the tensor cores), its weight
// (one ex2, on the multi-function unit: 16 per SM per clock) and its sums
// (FP32 instructions), against O(N D) bytes. In the design that formed every
// ordered pair, the dot and the ex2 were each about as long as the other
// (without its ex2 the kernel read 89% of the ex2 floor at 16 x 128^2,
// without its mma 91%; whole, 70%), so a faster unit alone moved little.
// The kernel is symmetric, l_ij = l_ji: this design forms each unordered
// pair once and adds its weight to both pixels' sums, which halves the dot
// and the ex2 together, for the columns' sums: per weight, the FFMA of the
// column's num and the FADD of its den beside the row's two, and a shuffle
// reduction per group of keys. Those three are now each about as long as the
// others (32 x 128^2 on an H100: 2.04 ms an iteration; without the ex2 1.83,
// without the mma 1.68, without the column sums 1.63; PERF.md section 6) and
// overlap in part: mma.sync in TF32 runs well under the tensor cores' wgmma
// rate, and each weight costs about 5 issue slots against 8 clocks of ex2.
//
// The schedule. Each image's pixels are cut into tiles of kTile = 256
// (16 kTiles kWarps). The tile pairs (I, J) with I <= J, nT (nT + 1) / 2 an
// image (2,080 of 4,096 at 128^2), are listed image by image, strip by strip
// (I, then J), and the grid (one wave: the SMs times the blocks an SM holds)
// cuts the list into even runs, one a block, within one pair of each other:
// no tail of short blocks, whatever the batch and the size (the batch rides
// the list, not the grid: 16 images of 96^2 would fill 288 of 528 block
// slots as a grid of strips). A block holds the queries of its current strip
// I in registers and streams the key tiles J through shared memory:
//   - a diagonal pair (J = I) adds each weight to its row only (every ordered
//     pair of the tile, the self term in);
//   - an off-diagonal pair adds w_ij v_j and w_ij to row i and w_ij v_i and
//     w_ij to column j.
//
// The logits. In log2 units each is one K = 8 dot of augmented operands,
//
//   q'_i = log2(e) [f_i - c, -|f_i - c|^2/2, 1, 0...],
//   k'_j =         [f_j - c, 1, -|f_j - c|^2/2, 0...],   q'_i . k'_j = l_ij log2(e),
//
// so the accumulator is the ex2's argument itself. Each warp keeps its 64
// queries' A fragments (hi and lo) in registers for the strip; each thread
// prepares two keys (centre, half-norm, split) into shared memory as B
// fragments of mma.m16n8k8. Per group of 8 keys and 16 queries: three
// mma.sync (the split below), ex2.approx.ftz of each accumulator element.
//
// The sums. Rows: num += w v_j (FFMA), den += w (FADD) in f32 registers over
// the strip's pairs; at the end of a block's run of a strip, a quad shuffle
// sums each row and lane 0 adds (num, den) into the image's accumulator
// sums[b, i, 0:2] (red.global.add.v2.f32). Columns, per group: each thread
// holds 2 kTiles rows x 2 columns of weights and its rows' values; it folds
// its rows with FFMA and FADD into (num, den) of its 2 columns, then the 8
// lanes that share those columns reduce the 4 quantities with a butterfly
// reduce-scatter (4 shuffles, 4 adds), and half the lanes store one sum each
// into the warp's column partials in shared memory. After the pair, each
// thread sums its keys' partials over the warps and adds (num, den) into the
// accumulator. A block that ends a run fences and adds the run's pairs to the
// image's counter; the block that completes the image's nT (nT + 1) / 2
// pairs writes out = num / den for the image and leaves its accumulator and
// counter at 0 for the next call (no other launch).
//
// Accuracy. The logits cancel half-norms of up to ~4e3 (rgb / srgb reaches
// 51 a channel): f32 keeps ~5e-4 of them, a single TF32 product ~1 (it
// moves q1 by 0.77 on the card). So each operand is split into TF32 parts,
// x = hi + lo (hi = cvt.rna(x), lo = cvt.rna(x - hi): ~22 bits), and the
// dot is hi.hi + hi.lo + lo.hi (lo.lo, ~2^-22 of a product, is dropped),
// each product exact in the tensor core, the sums in its f32 accumulator.
// Before the split both sides are centred on c, the midpoint of the bounding
// box of the strip's queries: the logit is exactly invariant to a
// translation, and the magnitudes, and with them the rounding, shrink (a
// model with float64 products reads 3e-4 from the exact logit at the
// recipes' scales, 1e-3 uncentred; tests/test_torch_crf.py). A pair whose
// weight counts is near its query, hence near c, in both directions: a
// column gets the very logit its row gets. No running max: every logit is
// <= 0 up to that rounding. The self logit is within ~1e-3 of 0, so den >= 1
// holds to that rounding, and a logit that is positive by ~1e-3 cannot
// overflow ex2. ex2.approx.ftz (2^-22 relative) flushes weights under
// 2^-126 to 0, against den ~ 1. The accumulator's f32 adds arrive in an
// order that changes from run to run (atomics): a sum of ~1e2 weights of
// ~1 moves by a few ulps, ~1e-6 of out at most, inside the 1e-4 / 2e-4
// limits that hold the kernel to its plain version.
//
// Ragged edges: keys past N are padded with k' = [0.., 1, -1e30, 0..], and
// queries past N with q' = log2(e) [0.., -1e30, 1, 0..]: either weight,
// ex2(-1.4e30), is exactly 0, and a padded key's value is 0. Rows past N are
// not stored.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;  // warps a block
constexpr int kTiles = 4;  // 16-query row tiles a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;  // blocks an SM: at most 128 registers a thread
constexpr int kTile = 16 * kTiles * kWarps;  // pixels a tile: a strip's queries, a pair's keys
constexpr int kKeysPerThread = kTile / kThreads;  // keys each thread prepares a pair
constexpr int kGroups = kTile / 8;  // groups of 8 keys a pair
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadHalfNorm = 1e30f;  // a padded pixel's half-norm: its weight is exactly 0
constexpr float kInf = __builtin_huge_valf();
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

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

// a[0] += x, a[1] += y in the L2, no value returned (a 8-byte aligned).
__device__ __forceinline__ void red_add2(float* a, float x, float y) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(a), "f"(x), "f"(y) : "memory");
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
                  float* __restrict__ out, float* __restrict__ sums,
                  unsigned long long* __restrict__ done, int n, long long images) {
  static_assert(D + 2 <= 8, "the augmented operands must fit K = 8");
  static_assert(kTile % kThreads == 0 && kGroups % 2 == 0, "the tiling");
  // The pair's keys as B fragments: {hi[t], hi[t + 4], lo[t], lo[t + 4]} of
  // key 8 grp + g at [grp][4 g + t]; their values beside.
  __shared__ float4 s_key[kGroups][32];
  __shared__ __align__(16) float s_val[kTile];
  // Each warp's column sums of the pair: (num, den) of each key.
  __shared__ __align__(16) float s_col[kWarps][kTile][2];
  __shared__ float s_box[2][kWarps][D];
  __shared__ float s_centre[D];
  __shared__ int s_last;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long nt = (n + kTile - 1) / kTile;
  const long long per_image = nt * (nt + 1) / 2;
  const long long total = per_image * images;

  // This block's run of the list, [p, p_end).
  const long long share = total / gridDim.x, extra = total % gridDim.x;
  long long p = share * blockIdx.x + min((long long)blockIdx.x, extra);
  const long long p_end = p + share + ((long long)blockIdx.x < extra ? 1 : 0);
  if (p >= p_end) return;
  long long b = p / per_image, q = p - b * per_image;
  int I = 0;
  for (; q >= nt - I; ++I) q -= nt - I;  // strip I holds nt - I pairs
  int J = I + (int)q;

  // The strip's queries: centre, A fragments (hi and lo), values.
  float c[D];
  uint32_t a_hi[kTiles][4], a_lo[kTiles][4];
  float vr[kTiles][2];
  auto set_queries = [&](long long bq, int q0) {
    const float* fb = feat + (size_t)bq * n * D;
    const float* vb = values + (size_t)bq * n;
    // The centre: the midpoint of the bounding box of the strip's queries.
    float lo[D], hi[D];
#pragma unroll
    for (int d = 0; d < D; ++d) lo[d] = kInf, hi[d] = -kInf;
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const float* f = fb + (size_t)min(q0 + r, n - 1) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) lo[d] = fminf(lo[d], f[d]), hi[d] = fmaxf(hi[d], f[d]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        lo[d] = fminf(lo[d], __shfl_xor_sync(kFull, lo[d], s));
        hi[d] = fmaxf(hi[d], __shfl_xor_sync(kFull, hi[d], s));
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
#pragma unroll
    for (int d = 0; d < D; ++d) c[d] = s_centre[d];
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = q0 + (warp * kTiles + m) * 16 + g + 8 * half;
        float fc[D];
        float h = centred_half_norm<D>(fb + (size_t)min(i, n - 1) * D, c, fc);
        if (i >= n) {
#pragma unroll
          for (int d = 0; d < D; ++d) fc[d] = 0.f;
          h = kPadHalfNorm;
        }
        split(query_component<D>(fc, h, t), a_hi[m][half], a_lo[m][half]);
        split(query_component<D>(fc, h, t + 4), a_hi[m][2 + half], a_lo[m][2 + half]);
        vr[m][half] = i < n ? vb[i] : 0.f;
      }
    }
  };

  // The thread's keys of a pair (tile keys threadIdx.x + k kThreads), centred,
  // augmented and split, into shared memory with their values.
  auto store_key = [&](long long bk, int j0) {
    const float* fb = feat + (size_t)bk * n * D;
    const float* vb = values + (size_t)bk * n;
#pragma unroll
    for (int k = 0; k < kKeysPerThread; ++k) {
      const int r = threadIdx.x + k * kThreads;
      const bool real = j0 + r < n;
      float kc[D];
      const float h = centred_half_norm<D>(fb + (size_t)min(j0 + r, n - 1) * D, c, kc);
      float key[8] = {};
#pragma unroll
      for (int d = 0; d < D; ++d) key[d] = real ? kc[d] : 0.f;
      key[D] = 1.f;
      key[D + 1] = real ? -h : -kPadHalfNorm;
      uint32_t khi[8], klo[8];
#pragma unroll
      for (int d = 0; d < 8; ++d) split(key[d], khi[d], klo[d]);
      const int grp = r >> 3, col = r & 7;
#pragma unroll
      for (int tt = 0; tt < 4; ++tt)
        s_key[grp][4 * col + tt] =
            make_float4(__uint_as_float(khi[tt]), __uint_as_float(khi[tt + 4]),
                        __uint_as_float(klo[tt]), __uint_as_float(klo[tt + 4]));
      s_val[r] = real ? vb[j0 + r] : 0.f;
    }
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
  // Where this lane's column sum lands in its warp's partials of a group: the
  // reduce-scatter below leaves lanes with bit 16 on column 2t + 1, bit 8 on
  // den; lanes with bit 4 hold the same sums and do not store.
  float* const s_col_warp = &s_col[warp][0][0];
  const int col_slot = 2 * (2 * t + ((lane >> 4) & 1)) + ((lane >> 3) & 1);
  // The weights of a group (columns 2t, 2t + 1 of rows g, g + 8) into the
  // rows' sums and, off the diagonal, the columns'.
  auto accumulate = [&](const float (&acc)[kTiles][4], const float2 v, int grp, auto columns) {
    float w[kTiles][4];
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
      w[m][0] = ex2(acc[m][0]), w[m][1] = ex2(acc[m][1]);
      w[m][2] = ex2(acc[m][2]), w[m][3] = ex2(acc[m][3]);
      num[m][0] = __fmaf_rn(w[m][1], v.y, __fmaf_rn(w[m][0], v.x, num[m][0]));
      den[m][0] = __fadd_rn(den[m][0], __fadd_rn(w[m][0], w[m][1]));
      num[m][1] = __fmaf_rn(w[m][3], v.y, __fmaf_rn(w[m][2], v.x, num[m][1]));
      den[m][1] = __fadd_rn(den[m][1], __fadd_rn(w[m][2], w[m][3]));
    }
    if constexpr (decltype(columns)::value) {
      // The thread's 4 rows folded: (num, den) of column 2t, then of 2t + 1.
      float q0 = __fmaf_rn(w[0][2], vr[0][1], __fmul_rn(w[0][0], vr[0][0]));
      float q1 = __fadd_rn(w[0][0], w[0][2]);
      float q2 = __fmaf_rn(w[0][3], vr[0][1], __fmul_rn(w[0][1], vr[0][0]));
      float q3 = __fadd_rn(w[0][1], w[0][3]);
#pragma unroll
      for (int m = 1; m < kTiles; ++m) {
        q0 = __fmaf_rn(w[m][2], vr[m][1], __fmaf_rn(w[m][0], vr[m][0], q0));
        q1 = __fadd_rn(q1, __fadd_rn(w[m][0], w[m][2]));
        q2 = __fmaf_rn(w[m][3], vr[m][1], __fmaf_rn(w[m][1], vr[m][0], q2));
        q3 = __fadd_rn(q3, __fadd_rn(w[m][1], w[m][3]));
      }
      // Over the 8 lanes of the columns (lane bits 16, 8, 4): each halving
      // keeps half the quantities and takes the partner's half of them.
      const bool b16 = lane & 16, b8 = lane & 8;
      float k0 = b16 ? q2 : q0, k1 = b16 ? q3 : q1;
      const float s0 = b16 ? q0 : q2, s1 = b16 ? q1 : q3;
      k0 += __shfl_xor_sync(kFull, s0, 16);
      k1 += __shfl_xor_sync(kFull, s1, 16);
      float k = b8 ? k1 : k0;
      k += __shfl_xor_sync(kFull, b8 ? k0 : k1, 8);
      k += __shfl_xor_sync(kFull, k, 4);
      if (!(lane & 4)) s_col_warp[16 * grp + col_slot] = k;
    }
  };

  // The pair's key loop, written software-pipelined (the next group's
  // products before this group's ex2) so that the tensor cores and the
  // multi-function unit can overlap; ptxas schedules it its own way, and the
  // loop written plainly reads 2% slower (tools/time_crf_variants.py).
  auto key_loop = [&](auto columns) {
    const float2* val = reinterpret_cast<const float2*>(s_val) + t;
    float acc0[kTiles][4], acc1[kTiles][4];
    logits(acc0, s_key[0][lane]);
#pragma unroll 4
    for (int grp = 0; grp < kGroups - 2; grp += 2) {
      logits(acc1, s_key[grp + 1][lane]);
      accumulate(acc0, val[4 * grp], grp, columns);
      logits(acc0, s_key[grp + 2][lane]);
      accumulate(acc1, val[4 * grp + 4], grp + 1, columns);
    }
    logits(acc1, s_key[kGroups - 1][lane]);
    accumulate(acc0, val[4 * (kGroups - 2)], kGroups - 2, columns);
    accumulate(acc1, val[4 * (kGroups - 1)], kGroups - 1, columns);
  };

  // Each key's column sums over the warps, into the accumulator.
  auto flush_columns = [&](long long bk, int j0) {
    float* sb = sums + 2 * ((size_t)bk * n);
#pragma unroll
    for (int k = 0; k < kKeysPerThread; ++k) {
      const int r = threadIdx.x + k * kThreads;
      float cn = 0.f, cd = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float2 s = *reinterpret_cast<const float2*>(&s_col[w][r][0]);
        cn += s.x, cd += s.y;
      }
      if (j0 + r < n) red_add2(sb + 2 * (size_t)(j0 + r), cn, cd);
    }
  };
  // Each row's sums over the quad's columns, into the accumulator; lane t = 0 adds.
  auto flush_rows = [&](long long bq, int q0) {
    float* sb = sums + 2 * ((size_t)bq * n);
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float nm = num[m][half], dn = den[m][half];
        nm += __shfl_xor_sync(kFull, nm, 1);
        dn += __shfl_xor_sync(kFull, dn, 1);
        nm += __shfl_xor_sync(kFull, nm, 2);
        dn += __shfl_xor_sync(kFull, dn, 2);
        const int i = q0 + (warp * kTiles + m) * 16 + g + 8 * half;
        if (t == 0 && i < n) red_add2(sb + 2 * (size_t)i, nm, dn);
        num[m][half] = den[m][half] = 0.f;
      }
    }
  };
  // After a run of `pairs` pairs of image bq: the block that completes the
  // image writes num / den and zeroes its accumulator and counter.
  auto finish = [&](long long bq, long long pairs) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      s_last = atomicAdd(done + bq, (unsigned long long)pairs) + pairs == (unsigned long long)per_image;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    float2* sb = reinterpret_cast<float2*>(sums) + (size_t)bq * n;
    float* ob = out + (size_t)bq * n;
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float2 s = __ldcg(sb + i);
      ob[i] = s.x / s.y;
      __stcg(sb + i, make_float2(0.f, 0.f));
    }
    if (threadIdx.x == 0) done[bq] = 0;
  };

  while (p < p_end) {
    set_queries(b, I * kTile);
    const long long run = min(p_end - p, nt - J);  // this run's pairs of strip I
    for (long long s = 0; s < run; ++s, ++p, ++J) {
      store_key(b, J * kTile);
      __syncthreads();  // the pair's keys are in
      if (J == I)
        key_loop(std::false_type{});
      else
        key_loop(std::true_type{});
      __syncthreads();  // the warps' column sums are in; the keys are read
      if (J != I) flush_columns(b, J * kTile);
    }
    flush_rows(b, I * kTile);
    finish(b, run);
    if (J == nt) {
      if (++I == nt) I = 0, ++b;
      J = I;
    }
  }
}

template <int D>
int launch(const float* feat, const float* values, float* out, float* sums,
           unsigned long long* done, long long b, int n, cudaStream_t stream) {
  // One wave: the SMs times the blocks an SM holds, each device's count read once.
  static int slots[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (slots[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crf_filter_kernel<D>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    slots[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long nt = (n + kTile - 1) / kTile;
  const long long pairs = b * (nt * (nt + 1) / 2);
  const unsigned grid = (unsigned)(pairs < slots[dev] ? pairs : slots[dev]);
  crf_filter_kernel<D><<<grid, kThreads, 0, stream>>>(feat, values, out, sums, done, n, b);
  return (int)cudaGetLastError();
}

}  // namespace

// feat [b, n, d] f32, values [b, n] f32 -> out [b, n] f32, all contiguous on
// the device; d in {2, 5}. sums [>= b n 2] f32 and done [>= b] u64 are the
// images' accumulators and pair counters: 0 on entry, left 0 on return (one
// set per device, calls in stream order). Returns the launch's cudaError (0
// when it launched).
extern "C" int rcf_crf_filter(const float* feat, const float* values, float* out, float* sums,
                              unsigned long long* done, int64_t b, int n, int d, void* stream) {
  if (b == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 5:
      return launch<5>(feat, values, out, sums, done, b, n, s);
    case 2:
      return launch<2>(feat, values, out, sums, done, b, n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
