// DINO's attention for Hopper (sm_90a): the flash-style forward of the ViT's
// blocks, in float32 accuracy on the tensor cores.
//
// Replaces no TPU kernel: the JAX package's ViT (rcf_tpu/nn/dino_vit.py)
// leaves its attention to XLA as product, softmax, product, and so does the
// port's plain version (ops/attention_kernels.py::dino_attention_plain). For
// each image b, head h and query i,
//
//   o[b, i, h] = sum_j exp(s_ij) v_j / sum_j exp(s_ij),   s_ij = q_i . k_j / sqrt(hd),
//
// with q, k and v read in place from the qkv linear's output [B, N, 3, heads,
// hd] (any image and token strides, the last three dimensions contiguous),
// and o written as [B, N, heads hd], the layout the projection reads. hd is
// 64 (vit_small, vit_base, mae_vit_base) or 32 (moco_vit_small).
//
// What bounds it. At the semantic constraint's shape (8 frames of 6,421
// tokens, 6 heads of 64, 11 blocks) Q K^T and P V are 4 N^2 hd FLOPs a head:
// 696 GFLOP a frame, 1.41 ms at the dense TF32 tensor rate (495 TFLOP/s),
// against 4.7 MB of q, k, v and o a block and frame. So the kernel is bound
// by tensor work, and float32 accuracy makes that work three times as large:
// each f32 product is three TF32 products (below), 3 x 696 GFLOP a frame.
// The plain form also wrote the 8 x 6 x 6,421^2 scores to device memory and
// read them back in three passes, and ran its products on the FP32 lanes.
// What the design does about it: the scores and weights never leave
// registers (an online softmax over key tiles); the products run on wgmma,
// the one instruction that reaches the tensor cores' full rate; two
// warpgroups a block take turns on the tensor cores, one's softmax against
// the other's products; and no instruction of the key loop splits, converts
// or transposes an operand in shared memory (the split pass below).
//
// The schedule. Two kernels, launched by one entry point:
//   1. split_kernel splits every tile of kKeys = 32 keys of every (b, h) once
//      into four operand parts, K hi, K lo, V^T hi, V^T lo, in the products'
//      shared-memory layout, into scratch in device memory: 16 bytes a key
//      and column, 316 MB at the cell's 8 frames, written once and read from
//      the L2 by the query blocks of the (b, h). A key tile is read by the
//      ceil(N / 128) = 51 query blocks of its (b, h); split inside each, every
//      tile would be split and V transposed 51 times, by the threads that
//      issue the products.
//   2. attention_kernel: a block takes kRows = 128 queries of one (b, h), two
//      warpgroups of 64 rows; each warp keeps its 16 rows in registers for the
//      whole key loop as A fragments (scaled by log2(e) / sqrt(hd) once, then
//      split). The split tiles stream through a ring of kBuffers = 4 in shared
//      memory by cp.async, tile j + 2 while tile j is computed, one
//      __syncthreads a tile. Each tile, a warpgroup forms S = Q K^T, 64 x 32
//      scores (hd / 8 k-steps x 3 wgmma.m64n32k8.tf32, B = K from shared
//      memory), then the online softmax in the FlashAttention-2 arrangement,
//      the scores in log2 units: the running row max m (a quad shuffle), alpha
//      = ex2(m_old - m_new), p = ex2(s - m_new) with ex2.approx.ftz, l = alpha
//      l + sum p; then the tile's P V (4 key groups x 3 wgmma.m64n{hd}k8, A = P
//      from registers, B = V^T from shared memory) into an accumulator of its
//      own. P V is left in flight across the barrier: the next tile's Q K^T
//      queues behind it on the tensor cores and one wait takes both, then
//      O = alpha O + P V in f32 FFMA (5.37 -> 5.05 ms a call at the cell's
//      8 x 6 x 6,421^2; tools/time_attention_variants.py). So a slot stays in
//      use one tile longer, and the ring holds 4: tile j + 2 lands in the slot
//      of tile j - 2, whose P V was waited for in tile j - 1. At the end one
//      division a row, o = O / l.
//
// Why P V has an accumulator a tile. The tensor cores' f32 accumulation does
// not round each addition to nearest. Carried through the 201 tiles of
// N = 6,421 (O rescaled in place, one accumulator), the output reads 5.6e-5
// from float64 at one frame of the cell, against 2.2e-6 with an accumulator
// a tile (tools/time_attention_variants.py, diag_carry): a tile's chain is
// 12 products, and the tiles are summed in f32 registers, rounded to nearest.
//
// P stays in registers. The accumulator of a warp holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1) of each group of 8 keys (g = lane / 4, t = lane
// % 4); an A fragment wants (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
// Taking the accumulator's registers 0, 2, 1, 3 as A's makes A's column t key
// 2t and its column t + 4 key 2t + 1 of the group: the contraction runs over
// the keys in the order 0, 2, 4, 6, 1, 3, 5, 7, which is free, so V^T is
// staged in that order (even keys in the first 16 bytes of a row, odd keys in
// the second) and no shuffle moves P.
//
// The parts are each in wgmma's K-major layout without swizzle: core matrices
// of 8 rows (keys of K, columns of V^T) x 16 bytes (4 along the contraction),
// the two of a k-step 128 bytes apart, groups of 8 rows 256 bytes apart; 8
// consecutive threads of the split kernel write one 128-byte run. A tile is 4
// x kKeys x hd x 4 bytes (32 KB at hd 64), the ring 128 KB.
//
// Accuracy. The configuration is float32 with TF32 off: a single TF32 product
// (10-bit mantissas) moves the cell's keys by ~5e-4 against their limit of
// 3e-5. Each operand x is split into TF32 parts, x = hi + lo (hi =
// round(x), lo = round(x - hi), both to TF32 by nearest, ties away: ~22 bits
// of x), and each product is hi.hi + hi.lo + lo.hi, the two small ones first
// (lo.lo, ~2^-22 of a product, is dropped), each product exact in the tensor
// core, as in crf.cu. The scores enter ex2 as s - m <= 0, so no weight
// overflows; ex2.approx.ftz (2^-22 relative) flushes weights under 2^-126 to
// 0, against a row sum >= 1. P is split in registers before P V.
//
// Ragged edges. Keys past N (6,421 = 200 x 32 + 21) are staged as zeros and
// their scores set to -inf in the last tile: ex2(-inf) is exactly 0, so they
// weigh exactly 0 (the row max stays finite: every tile holds at least one
// real key). Queries past N read row N - 1 and are not stored; a warpgroup
// whose 64 rows all lie past N only fetches tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kWarps = 8;                  // warps a block: two warpgroups of 64 rows
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;         // queries a block
constexpr int kKeys = 32;                  // keys a tile
constexpr int kGroups = kKeys / 8;         // groups of 8 keys a tile
constexpr int kBuffers = 4;                // tiles in shared memory at once
constexpr double kLog2e = 1.4426950408889634;
constexpr float kNegInf = -__builtin_huge_valf();
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// cvt.rna.tf32.f32 (round to nearest, ties away from zero) in integer
// arithmetic: the same bits for finite x, on the integer lanes.
__device__ __forceinline__ uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = hi + lo, both TF32 (low 13 bits 0); x - hi is exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// 16 bytes from device to shared memory, asynchronously (cp.async), one
// commit group of them, and the wait.
__device__ __forceinline__ void copy16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait for all but the newest group of the thread's copies.
__device__ __forceinline__ void copies_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The descriptor of a K-major operand in shared memory without swizzle: core
// matrices of 8 rows x 16 bytes, the two of a k-step 128 bytes apart (the
// leading offset), groups of 8 rows 256 bytes apart (the stride offset).
__device__ __forceinline__ uint64_t operand(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d (+)= a b for a 64 x N x 8 tile of the warpgroup: a in registers (each
// warp's 16 rows: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)), b N x 8
// K-major in shared memory; d += when add, d = otherwise. Each warp's d holds
// (g, 8 i + 2t), (g, 8 i + 2t + 1), (g + 8, 8 i + 2t), (g + 8, 8 i + 2t + 1)
// at 4 i .. 4 i + 3.
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int add);

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

// d (+)= a b in split TF32: a's and b's hi and lo parts are two operands each.
template <int N>
__device__ __forceinline__ void wgmma3(float (&d)[N / 2], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], uint64_t bh, uint64_t bl, int add) {
  wgmma<N>(d, al, bh, add);
  wgmma<N>(d, ah, bl, 1);
  wgmma<N>(d, ah, bh, 1);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

// Issue the warpgroup's products as one group; wait for every group it issued.
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_wait_all() {
  wgmma_commit();
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of r across the products.
template <int R>
__device__ __forceinline__ void pin(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int HD>
struct Shape {
  static_assert(HD == 32 || HD == 64, "compiled for hd 32 and 64");
  static constexpr int kSteps = HD / 8;                 // k-steps of Q K^T
  static constexpr int kPart = kKeys * HD * 4;          // bytes of one part of a tile
  static constexpr int kBuffer = 4 * kPart;             // K hi, K lo, V^T hi, V^T lo
  static constexpr size_t kSmem = kBuffers * kBuffer;   // the ring of tiles
  static constexpr int kKUnits = kKeys * kSteps;        // a key's 8 columns of a k-step
  static constexpr int kVUnits = 2 * kGroups * HD;      // 4 keys of a parity, a column
};

// Every key tile of every (b, h), split into its four parts in the products'
// layout, one block a tile: tile j of (b, h) at parts + ((b heads + h) nt + j)
// kBuffer bytes. Each part is K-major: element (row, k) of a k-step's operand
// at (row >> 3) 256 + (k >> 2) 128 + (row & 7) 16 + (k & 3) 4 bytes. A K unit
// is one key's 8 columns of one k-step (two core-matrix rows, hi and lo); a V
// unit one column's 4 keys of one parity in a group of 8 (a V^T core-matrix
// row). Keys past N are zeros.
template <int HD>
__global__ void __launch_bounds__(kThreads)
split_kernel(const float* __restrict__ qkv, unsigned char* __restrict__ parts, int n, int heads,
             long long stride_b, long long stride_n) {
  using S = Shape<HD>;
  constexpr int kSteps = S::kSteps, kPart = S::kPart;
  const int j0 = blockIdx.x * kKeys, b = blockIdx.y / heads, h = blockIdx.y - b * heads;
  const int width = heads * HD;
  const float* kb = qkv + (long long)b * stride_b + h * HD + width;
  const float* vb = kb + width;
  unsigned char* base = parts + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * S::kBuffer;
  for (int u = threadIdx.x; u < S::kKUnits; u += kThreads) {
    const int key = (u & 7) + 8 * (u / (8 * kSteps)), ks = (u >> 3) % kSteps;
    const int off = ks * kKeys * 32 + (key >> 3) * 256 + (key & 7) * 16;
    float4 x[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
    if (j0 + key < n) {
      const float4* p = reinterpret_cast<const float4*>(kb + (long long)(j0 + key) * stride_n + 8 * ks);
      x[0] = p[0], x[1] = p[1];
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      uint32_t hi[4], lo[4];
      split(x[c].x, hi[0], lo[0]), split(x[c].y, hi[1], lo[1]);
      split(x[c].z, hi[2], lo[2]), split(x[c].w, hi[3], lo[3]);
      *reinterpret_cast<uint4*>(base + off + 128 * c) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(base + kPart + off + 128 * c) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  for (int u = threadIdx.x; u < S::kVUnits; u += kThreads) {
    const int col = u % HD, pair = u / HD;  // pair: (group, parity)
    const int off = 2 * kPart + (pair >> 1) * HD * 32 + (col >> 3) * 256 + (pair & 1) * 128 + (col & 7) * 16;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int pos = 0; pos < 4; ++pos) {
      const int key = j0 + 8 * (pair >> 1) + (pair & 1) + 2 * pos;
      split(key < n ? vb[(long long)key * stride_n + col] : 0.f, hi[pos], lo[pos]);
    }
    *reinterpret_cast<uint4*>(base + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(base + kPart + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attention_kernel(const float* __restrict__ qkv, const unsigned char* __restrict__ parts,
                 float* __restrict__ out, int n, int heads, long long stride_b, long long stride_n,
                 float q_scale) {
  using S = Shape<HD>;
  constexpr int kSteps = S::kSteps, kPart = S::kPart, kBuffer = S::kBuffer;
  extern __shared__ __align__(128) unsigned char ring[];
  const uint32_t ring_addr = (uint32_t)__cvta_generic_to_shared(ring);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y - b * heads;
  const int width = heads * HD;  // a token's q (k, v) width, o's row
  const float* qb = qkv + (long long)b * stride_b + h * HD;
  const int q0 = blockIdx.x * kRows + warp * 16;
  const bool active = blockIdx.x * kRows + (warp >> 2) * 64 < n;  // the warpgroup has a real query
  const int nt = (n + kKeys - 1) / kKeys;
  const unsigned char* tiles = parts + (long long)blockIdx.y * nt * kBuffer;  // this (b, h)'s

  // The warp's queries as A fragments, scaled into log2 units, split.
  uint32_t qh[kSteps][4], ql[kSteps][4];
  {
    const float* r0 = qb + (long long)min(q0 + g, n - 1) * stride_n;
    const float* r1 = qb + (long long)min(q0 + g + 8, n - 1) * stride_n;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      split(__fmul_rn(q_scale, r0[8 * ks + t]), qh[ks][0], ql[ks][0]);
      split(__fmul_rn(q_scale, r1[8 * ks + t]), qh[ks][1], ql[ks][1]);
      split(__fmul_rn(q_scale, r0[8 * ks + t + 4]), qh[ks][2], ql[ks][2]);
      split(__fmul_rn(q_scale, r1[8 * ks + t + 4]), qh[ks][3], ql[ks][3]);
    }
  }

  // Tile j's split parts into slot j % kBuffers of the ring, by asynchronous copies.
  auto fetch = [&](int j) {
    const unsigned char* src = tiles + (long long)j * kBuffer;
    const uint32_t dst = ring_addr + (j % kBuffers) * kBuffer;
#pragma unroll
    for (int r = 0; r < kBuffer / 16 / kThreads; ++r) {
      const int c = threadIdx.x + r * kThreads;
      copy16(dst + 16 * c, src + 16 * c);
    }
  };

  float o[HD / 2], pv[HD / 2], s[kKeys / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = pv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  float a0 = 1.f, a1 = 1.f;  // their rescale of O by the tile whose P V is in flight
  // O = alpha O + P V of the tile in flight, once its products are done.
  auto update_o = [&]() {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = __fmaf_rn(o[i], (i & 2) ? a1 : a0, pv[i]);
  };

  // One commit group of copies a tile: tile j + 2 fetched while tile j is
  // computed, tile j + 1 waited for at its end.
  fetch(0);
  copies_commit();
  if (nt > 1) fetch(1);
  copies_commit();
  copies_wait_all_but_one();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads through the async proxy
  __syncthreads();
  for (int j = 0; j < nt; ++j) {
    if (j + 2 < nt) fetch(j + 2);
    copies_commit();
    const uint32_t kh = ring_addr + (j % kBuffers) * kBuffer, kl = kh + kPart;
    const uint32_t vh = kh + 2 * kPart, vl = kh + 3 * kPart;
    if (active) {
      pin(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
        wgmma3<kKeys>(s, qh[ks], ql[ks], operand(kh + ks * kKeys * 32), operand(kl + ks * kKeys * 32),
                      ks > 0);
      wgmma_wait_all();  // ... and the previous tile's P V
      pin(s);
      pin(pv);
      update_o();  // 0 before the first tile
      if ((j + 1) * kKeys > n) {  // the ragged tile: keys past N weigh 0
#pragma unroll
        for (int nb = 0; nb < kGroups; ++nb) {
          const int key = j * kKeys + 8 * nb + 2 * t;
          if (key >= n) s[4 * nb] = s[4 * nb + 2] = kNegInf;
          if (key + 1 >= n) s[4 * nb + 1] = s[4 * nb + 3] = kNegInf;
        }
      }
      // Online softmax: the rows' max over the tile and the quad, the rescale.
      float x0 = kNegInf, x1 = kNegInf;
#pragma unroll
      for (int nb = 0; nb < kGroups; ++nb) {
        x0 = fmaxf(x0, fmaxf(s[4 * nb], s[4 * nb + 1]));
        x1 = fmaxf(x1, fmaxf(s[4 * nb + 2], s[4 * nb + 3]));
      }
      x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, 1));
      x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, 1));
      x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, 2));
      x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, 2));
      x0 = fmaxf(m0, x0), x1 = fmaxf(m1, x1);
      a0 = ex2(__fsub_rn(m0, x0)), a1 = ex2(__fsub_rn(m1, x1));
      m0 = x0, m1 = x1;
      l0 = __fmul_rn(l0, a0), l1 = __fmul_rn(l1, a1);
      // P, split in registers: group kk's A fragment is its scores 0, 2, 1, 3.
      uint32_t ph[kGroups][4], pl[kGroups][4];
#pragma unroll
      for (int kk = 0; kk < kGroups; ++kk) {
        const float p0 = ex2(__fsub_rn(s[4 * kk], m0)), p1 = ex2(__fsub_rn(s[4 * kk + 1], m0));
        const float p2 = ex2(__fsub_rn(s[4 * kk + 2], m1)), p3 = ex2(__fsub_rn(s[4 * kk + 3], m1));
        l0 = __fadd_rn(l0, __fadd_rn(p0, p1));
        l1 = __fadd_rn(l1, __fadd_rn(p2, p3));
        split(p0, ph[kk][0], pl[kk][0]);  // (g, key 2t)
        split(p2, ph[kk][1], pl[kk][1]);  // (g + 8, key 2t)
        split(p1, ph[kk][2], pl[kk][2]);  // (g, key 2t + 1)
        split(p3, ph[kk][3], pl[kk][3]);  // (g + 8, key 2t + 1)
      }
      // The tile's P V into its own accumulator, left in flight: the next
      // tile's Q K^T queues behind it, and O takes it after that one's wait.
      pin(pv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGroups; ++kk)
        wgmma3<HD>(pv, ph[kk], pl[kk], operand(vh + kk * HD * 32), operand(vl + kk * HD * 32), kk > 0);
      wgmma_commit();
    }
    copies_wait_all_but_one();  // tile j + 1 is in its slot
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // ... for every thread
  }
  if (!active) return;
  wgmma_wait_all();
  pin(pv);
  update_o();

  // One division a row: the quad's partial sums, then o = O / l.
  l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 1));
  l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 1));
  l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 2));
  l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 2));
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + g, r1 = q0 + g + 8;
  float* o0 = out + ((long long)b * n + r0) * width + h * HD + 2 * t;
  float* o1 = o0 + 8LL * width;
#pragma unroll
  for (int hb = 0; hb < HD / 8; ++hb) {
    if (r0 < n)
      *reinterpret_cast<float2*>(o0 + 8 * hb) =
          make_float2(__fmul_rn(o[4 * hb], inv0), __fmul_rn(o[4 * hb + 1], inv0));
    if (r1 < n)
      *reinterpret_cast<float2*>(o1 + 8 * hb) =
          make_float2(__fmul_rn(o[4 * hb + 2], inv1), __fmul_rn(o[4 * hb + 3], inv1));
  }
}

template <int HD>
int launch(const float* qkv, unsigned char* parts, float* out, long long b, int n, int heads,
           long long stride_b, long long stride_n, cudaStream_t stream) {
  // The dynamic shared memory past 48 KB, allowed once a device.
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Shape<HD>::kSmem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  const unsigned tiles = (unsigned)((n + kKeys - 1) / kKeys), pairs = (unsigned)(b * heads);
  split_kernel<HD><<<dim3(tiles, pairs), kThreads, 0, stream>>>(qkv, parts, n, heads, stride_b, stride_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float q_scale = (float)(kLog2e / std::sqrt((double)HD));
  const dim3 grid((unsigned)((n + kRows - 1) / kRows), pairs);
  attention_kernel<HD><<<grid, kThreads, Shape<HD>::kSmem, stream>>>(qkv, parts, out, n, heads, stride_b,
                                                                     stride_n, q_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: [b, n, 3, heads, hd] f32 on the device, element strides stride_b and
// stride_n over images and tokens, the rest contiguous, 16-byte aligned (both
// strides multiples of 4); out: [b, n, heads hd] f32, contiguous; parts:
// scratch of b heads ceil(n / 32) 512 hd bytes, 16-byte aligned. hd in {32,
// 64}, b heads <= 65535. Returns the launches' cudaError (0 when they launched).
extern "C" int rcf_dino_attention(const float* qkv, float* out, unsigned char* parts, int64_t b, int n,
                                  int heads, int hd, int64_t stride_b, int64_t stride_n, void* stream) {
  if (b == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(qkv, parts, out, b, n, heads, stride_b, stride_n, s);
    case 32:
      return launch<32>(qkv, parts, out, b, n, heads, stride_b, stride_n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
