// DINO's linears for Hopper (sm_90a): y = act(x W^T + b) (+ r), the ViT
// blocks' qkv, proj, fc1 and fc2, in float32 accuracy on the tensor cores.
//
// Replaces no TPU kernel: the JAX package's ViT (rcf_tpu/nn/dino_vit.py)
// leaves its linears to XLA, and the port's plain version
// (ops/linear_kernels.py::dino_linear_plain) to F.linear, F.gelu and +. For x
// [M, K] row-major, W [N, K] (nn.Linear's weight), b [N] and r [M, N]:
//
//   y[i, j] = act(sum_k x[i, k] W[j, k] + b[j]) + r[i, j],
//
// act the identity or exact GELU (0.5 v (1 + erf(v / sqrt(2)))), r optional.
// K in {384, 768, 1536, 3072} and N in {384, 768, 1152, 1536, 2304, 3072}
// cover every DinoViT width; any M, the last row tile ragged.
//
// What bounds it. At the semantic constraint's shape (8 frames of 6,421
// tokens, M = 51,368; vit_small: K x N = 384 x 1,152, 384 x 384, 384 x 1,536,
// 1,536 x 384 in 11 blocks, and the last block's qkv) the linears are 255.6
// GFLOP a frame, 0.52 ms at the dense TF32 tensor rate (495 TFLOP/s), against
// 1.42 GB of x, y and r a block's four calls over the 8 frames (0.59 ms a
// frame at 3.35 TB/s). So the kernel is bound by tensor work, and float32
// accuracy makes it three times as large: each f32 product is three TF32
// products (below), 1.55 ms a frame. The plain form ran on the FP32 lanes
// (cuBLAS's SIMT f32 GEMM, 66.9 TFLOP/s at most) and wrote y, then read it
// back for GELU and for the residual add. What the design does about it: the
// products run on wgmma, the one instruction that reaches the tensor cores'
// full rate; the bias, GELU and the residual add are the epilogue, so y is
// written once; the threads that issue the products neither copy the operands
// nor split the weight (the split pass below).
//
// The schedule. Two kernels, each launched by its own entry point:
//   1. split_weight splits W once a call into its TF32 hi and lo parts in the
//      products' shared-memory layout, slice by slice of kSlice = 48 along K,
//      into scratch in device memory (8 N K bytes: 4.7 MB for fc1), read from
//      the L2 by every row tile. Split inside the GEMM, every slice would be
//      split ceil(M / 128) = 402 times.
//   2. linear_kernel: persistent blocks, one a SM, walk over the output tiles
//      of kRows = 128 rows x kCols = 128 columns (tile t: rows t / (N / 128),
//      columns t % (N / 128); the blocks in flight share the weight and a few
//      row tiles of x in the L2), two warpgroups of 64 rows. A block's tiles'
//      slices stream as one sequence through a ring of kBuffers = 3 in shared
//      memory: x's 128 rows x 48 columns by one tensor copy (TMA, zeros past
//      row M - 1) and the weight's 48 KB of parts by one bulk copy, both
//      counted in by the slot's "full" mbarrier; the 8 warps arrive on its
//      "empty" mbarrier when done with it, and thread 0 then refills it, two
//      slices ahead. So no thread copies an operand and no barrier holds the
//      warpgroups in step. Each warp reads its 16 rows of x from shared memory
//      (6 ld.shared.v4 a slice), splits them in registers into A fragments
//      and issues its warpgroup's 6 k-steps x 3 wgmma.m64n128k8.tf32 (B = the
//      weight's parts from shared memory) into a partial accumulator; it
//      reads the next slice's x while they run, waits, and adds the partial
//      to the tile's accumulator in f32 registers, rounded to nearest.
//   The epilogue: + b, GELU, + r in f32 registers, float2 stores of row-major
//   y (8 consecutive floats a quad), so that qkv's y is [B, N, 3, heads, hd]
//   contiguous, the layout dino_attention reads in place. It runs after the
//   next tile's first products are issued, under them, a quarter of the
//   columns at a time, each quarter's bias and residual loaded before any of
//   them is used; the residual's rows are prefetched into the L2 when a tile
//   starts.
//
// What the design weighed (tools/time_linear_variants.py; H100 80GB HBM3,
// 700 W; the cell's fc1, split-TF32 floor 0.367 ms). The products alone, no
// operand loaded, split or summed, run at 95% of the floor (0.386 ms), so
// the tensor cores take wgmma with A from registers at their full rate. With
// the epilogue's loads one at a time the kernel read 0.76 ms, 0.22 of it the
// epilogue (both warpgroups in it at once, the tensor cores idle): each
// load's latency in turn, the bias's alone 0.10 ms. A quarter's loads
// together: 0.68 ms (qkv 0.51 -> 0.45, proj 0.28 -> 0.20, fc2 0.75 -> 0.63);
// all the bias at once spills. The ring's waits cost 0.10 ms, the split
// 0.05, the sums 0.01. Tried and dropped: 16- and 32-wide slices (no better,
// or worse); all threads copying by cp.async with one __syncthreads a slice
// (0.91 ms); a separate producer warp (the register budget of 288 threads is
// 168, and the sums spill); one group of products left in flight across the
// wait (the A fragments and partial sums then need 256 registers, or ptxas
// serialises the products); the two warpgroups taking turns on the tensor
// cores (0.95 ms); partial sums over 4 slices with the epilogue spread over
// them (spills, 0.83 ms); y staged in shared memory and written by tensor
// stores, with 32-wide slices to make room (0.77 ms, against 0.76).
//
// Why a partial accumulator a slice. The tensor cores' f32 accumulation does
// not round each addition to nearest (attention.cu, "Why P V has an
// accumulator a tile"): carried through K = 1,536 it would be a chain of 576
// products. Here a slice's chain is 18 products, and the 32 slices of fc2 are
// summed in f32 registers, rounded to nearest: 3.2e-7 to 4.7e-7 of the
// output's largest value from float64 at the cell's four shapes, against
// 5.8e-7 to 1.4e-6 for cuBLAS's f32 GEMM.
//
// The contraction's order within 16 columns of x. An A fragment holds (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4) of a k-step of 8 (g = lane / 4, t =
// lane % 4). A thread reads x's columns 4t .. 4t + 3 of a group of 16 as one
// float4 a row and feeds the two k-steps of the group: columns 4t + 2e and 4t
// + 2e + 1 are k-step e's t and t + 4. The order along K is free, so the
// split pass stages W in that order: k-step e of group q holds, in a row's
// first 16 bytes, W's columns 16 q + 4j + 2e (j = 0..3), in its second 16
// bytes 16 q + 4j + 2e + 1. x's rows lie 192 bytes apart in shared memory (48
// words, 16 banks on): the 8 lanes of a quarter warp (rows 2i, 2i + 1, chunks
// t) read 32 distinct banks.
//
// The weight's parts are each in wgmma's K-major layout without swizzle: core
// matrices of 8 rows (output columns) x 16 bytes (4 along K), the two of a
// k-step 128 bytes apart, groups of 8 rows 256 bytes apart, a k-step kCols x
// 32 bytes; 8 consecutive threads of the split pass write one 128-byte run.
//
// Accuracy. The configuration is float32 with TF32 off: a single TF32 product
// moves the cell's keys by ~5e-4 against their limit of 3e-5. Each operand v
// is split into TF32 parts, v = hi + lo (hi = round(v), lo = round(v - hi),
// both to TF32 by nearest, ties away: ~22 bits of v), and each product is
// hi.hi + hi.lo + lo.hi, the two small ones first (lo.lo, ~2^-22 of a
// product, is dropped), each product exact in the tensor core, as in
// attention.cu and crf.cu.
//
// Ragged edges. Rows past M (51,368 = 401 x 128 + 40) come in as zeros from
// the tensor copy and are not stored. K and N are whole slices and tiles: the wrapper admits only
// the widths above, and the entry points refuse others.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                        // warps a block: two warpgroups of 64 rows
constexpr int kThreads = 32 * kWarps;
constexpr int kSplitThreads = 256;
constexpr int kRows = 16 * kWarps;               // rows of x a tile
constexpr int kCols = 128;                       // output columns a tile
constexpr int kSlice = 48;                       // the contraction a slice
constexpr int kSteps = kSlice / 8;               // wgmma k-steps a slice
constexpr int kBuffers = 3;                      // slices in shared memory at once
constexpr int kXBytes = kRows * kSlice * 4;      // x's rows of a slice, kSlice * 4 bytes apart
constexpr int kGroups = kSlice / 16;             // groups of 16 columns a slice
constexpr int kPart = kCols * kSlice * 4;        // one TF32 part of the weight's slice
constexpr int kBuffer = kXBytes + 2 * kPart;     // x, W hi, W lo
constexpr size_t kSmem = (size_t)kBuffers * kBuffer + 2 * kBuffers * 8;  // the ring, its mbarriers
constexpr int kAcc = kCols / 2;                  // accumulator registers a thread
constexpr int kMaxDevices = 64;
constexpr long long kSpinLimit = 1LL << 24;      // polls of an mbarrier before a trap

// cvt.rna.tf32.f32 (round to nearest, ties away from zero) in integer
// arithmetic: the same bits for finite x, on the integer lanes.
__device__ __forceinline__ uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = hi + lo, both TF32 (low 13 bits 0); x - hi is exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// The ring's mbarriers: init, the producer's arrival with the bytes to come,
// a bulk copy that counts its bytes in, a consumer's arrival, and the wait for
// a phase (a trap, not a hang, if it never completes).
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// Rows r .. r + kRows - 1, columns c .. c + kSlice - 1 of the tensor map's
// matrix (zeros past its last row), kRows x 128 bytes.
__device__ __forceinline__ void tensor_copy(uint32_t dst, const CUtensorMap* map, int c, int r, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == kSpinLimit) __trap();
  }
}

// The descriptor of a K-major operand in shared memory without swizzle: core
// matrices of 8 rows x 16 bytes, the two of a k-step 128 bytes apart (the
// leading offset), groups of 8 rows 256 bytes apart (the stride offset).
__device__ __forceinline__ uint64_t operand(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d (+)= a b for a 64 x 128 x 8 tile of the warpgroup: a in registers (each
// warp's 16 rows: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)), b 128 x 8
// K-major in shared memory; d += when add, d = otherwise. Each warp's d holds
// (g, 8 i + 2t), (g, 8 i + 2t + 1), (g + 8, 8 i + 2t), (g + 8, 8 i + 2t + 1)
// at 4 i .. 4 i + 3.
__device__ __forceinline__ void wgmma(float (&d)[kAcc], const uint32_t (&a)[4], uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

// d (+)= a b in split TF32: a's and b's hi and lo parts are two operands each.
__device__ __forceinline__ void wgmma3(float (&d)[kAcc], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                       uint64_t bh, uint64_t bl, int add) {
  wgmma(d, al, bh, add);
  wgmma(d, ah, bl, 1);
  wgmma(d, ah, bh, 1);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving reads or writes of r across the products.
template <int R>
__device__ __forceinline__ void pin(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float gelu(float v) {
  return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.f, erff(__fmul_rn(v, 0.70710678118654752f))));
}

// W [n_out, k] split into its TF32 parts, one thread a row and group of 16
// columns: slice s of column tile c at parts + (c k / kSlice + s) 2 kPart
// bytes, hi then lo, each kSteps k-steps of kCols x 32 bytes (the layout and
// the order along K in the note above).
__global__ void __launch_bounds__(kSplitThreads)
split_weight(const float* __restrict__ w, unsigned char* __restrict__ parts, int n_out, int k) {
  const int u = blockIdx.x * kSplitThreads + threadIdx.x;
  if (u >= n_out * (k / 16)) return;
  const int n = u % n_out, q = u / n_out;  // row; group of 16 columns
  const float4* src = reinterpret_cast<const float4*>(w + (long long)n * k + 16 * q);
  float v[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 f = src[c];
    v[4 * c] = f.x, v[4 * c + 1] = f.y, v[4 * c + 2] = f.z, v[4 * c + 3] = f.w;
  }
  const int nr = n % kCols, slice = q / (kSlice / 16), pair = q % (kSlice / 16);
  unsigned char* base = parts + ((long long)(n / kCols) * (k / kSlice) + slice) * 2 * kPart +
                        (nr >> 3) * 256 + (nr & 7) * 16;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int off = (2 * pair + e) * kCols * 32;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split(v[4 * j + 2 * e + half], hi[j], lo[j]);
      *reinterpret_cast<uint4*>(base + off + 128 * half) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(base + kPart + off + 128 * half) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
linear_kernel(const __grid_constant__ CUtensorMap xmap, const unsigned char* __restrict__ parts,
              const float* __restrict__ bias, const float* __restrict__ residual,
              float* __restrict__ out, int m, int n_out, int k, int act_gelu) {
  extern __shared__ __align__(1024) unsigned char ring[];
  const uint32_t ring_addr = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t full = ring_addr + kBuffers * kBuffer, empty = full + kBuffers * 8;  // 8 bytes a slot

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // the thread's rows: row, row + 8
  const int nk = k / kSlice, ncol = n_out / kCols;
  const int tiles = (m + kRows - 1) / kRows * ncol;
  const int mine = (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = mine * nk;  // the block's slices, tile by tile

  // Slice f into slot f % kBuffers (thread 0): x's rows by the tensor map, the
  // weight's parts by one bulk copy, both counted in by the slot's full barrier.
  auto fetch = [&](int f) {
    const int tile = (int)blockIdx.x + f / nk * (int)gridDim.x, s = f % nk;
    const uint32_t dst = ring_addr + (f % kBuffers) * kBuffer, bar = full + 8 * (f % kBuffers);
    bar_expect(bar, kBuffer);
    tensor_copy(dst, &xmap, s * kSlice, tile / ncol * kRows, bar);
    bulk_copy(dst + kXBytes, parts + ((long long)(tile % ncol) * nk + s) * 2 * kPart, 2 * kPart, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBuffers; ++i) {
      bar_init(full + 8 * i, 1);
      bar_init(empty + 8 * i, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int f = 0; f < kBuffers - 1 && f < total; ++f) fetch(f);
  }
  __syncthreads();

  // The thread's x of slice f: rows row and row + 8, columns 4t .. 4t + 3 of
  // each group of 16.
  float4 xv[2 * kGroups];
  auto read_x = [&](int f) {
    const unsigned char* b = ring + (f % kBuffers) * kBuffer + 16 * t;
#pragma unroll
    for (int p = 0; p < kGroups; ++p) {
      xv[p] = *reinterpret_cast<const float4*>(b + row * kSlice * 4 + 64 * p);
      xv[kGroups + p] = *reinterpret_cast<const float4*>(b + (row + 8) * kSlice * 4 + 64 * p);
    }
  };
  // ... split into the A fragments of the slice's k-steps (k-step 2p + e:
  // columns 4t + 2e and 4t + 2e + 1 of group p as t and t + 4).
  uint32_t ah[kSteps][4], al[kSteps][4];
  auto split_x = [&]() {
#pragma unroll
    for (int p = 0; p < kGroups; ++p) {
      split(xv[p].x, ah[2 * p][0], al[2 * p][0]);
      split(xv[kGroups + p].x, ah[2 * p][1], al[2 * p][1]);
      split(xv[p].y, ah[2 * p][2], al[2 * p][2]);
      split(xv[kGroups + p].y, ah[2 * p][3], al[2 * p][3]);
      split(xv[p].z, ah[2 * p + 1][0], al[2 * p + 1][0]);
      split(xv[kGroups + p].z, ah[2 * p + 1][1], al[2 * p + 1][1]);
      split(xv[p].w, ah[2 * p + 1][2], al[2 * p + 1][2]);
      split(xv[kGroups + p].w, ah[2 * p + 1][3], al[2 * p + 1][3]);
    }
  };

  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.f;

  // y = act(acc + b) (+ r) of the tile, the rows past M not stored, a
  // quarter of the columns at a time: the quarter's bias and residual are
  // loaded before any of them is used, so that the loads' latencies overlap.
  auto epilogue = [&](int tile) {
    const int r0 = tile / ncol * kRows + row, c0 = tile % ncol * kCols + 2 * t;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float2 bb[kCols / 32], rr[kCols / 32][2];
#pragma unroll
      for (int i = 0; i < kCols / 32; ++i)
        bb[i] = *reinterpret_cast<const float2*>(bias + c0 + 8 * (q * kCols / 32 + i));
      if (residual != nullptr) {
#pragma unroll
        for (int i = 0; i < kCols / 32; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            rr[i][h] = r < m ? *reinterpret_cast<const float2*>(residual + (long long)r * n_out + c0 +
                                                                 8 * (q * kCols / 32 + i))
                             : make_float2(0.f, 0.f);
          }
      }
#pragma unroll
      for (int i = 0; i < kCols / 32; ++i) {
        const int j = q * kCols / 32 + i, c = c0 + 8 * j;
        float y[4] = {__fadd_rn(acc[4 * j], bb[i].x), __fadd_rn(acc[4 * j + 1], bb[i].y),
                      __fadd_rn(acc[4 * j + 2], bb[i].x), __fadd_rn(acc[4 * j + 3], bb[i].y)};
        if (act_gelu) {
#pragma unroll
          for (int e = 0; e < 4; ++e) y[e] = gelu(y[e]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (r >= m) continue;
          float2 o = make_float2(y[2 * h], y[2 * h + 1]);
          if (residual != nullptr) o = make_float2(__fadd_rn(rr[i][h].x, o.x), __fadd_rn(rr[i][h].y, o.y));
          *reinterpret_cast<float2*>(out + (long long)r * n_out + c) = o;
        }
      }
    }
  };

  int tile = blockIdx.x, s = 0, finished = -1;  // finished: a tile whose epilogue is due
  if (total > 0) {
    bar_wait(full, 0);
    read_x(0);
    split_x();
  }
  for (int f = 0; f < total; ++f) {
    const uint32_t wh = ring_addr + (f % kBuffers) * kBuffer + kXBytes, wl = wh + kPart;
    pin(part);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma3(part, ah[ks], al[ks], operand(wh + ks * kCols * 32), operand(wl + ks * kCols * 32),
             ks > 0);
    wgmma_commit();
    if (finished >= 0) {  // the last tile's epilogue, under this slice's products
      epilogue(finished);
      finished = -1;
    }
    if (s == 0 && residual != nullptr) {  // the tile's residual into the L2 for its epilogue
      const int r0 = tile / ncol * kRows + row, c = tile % ncol * kCols + 32 * t;
      if (r0 < m) prefetch_l2(residual + (long long)r0 * n_out + c);
      if (r0 + 8 < m) prefetch_l2(residual + (long long)(r0 + 8) * n_out + c);
    }
    if (f + 1 < total) {
      bar_wait(full + 8 * ((f + 1) % kBuffers), ((f + 1) / kBuffers) & 1);
      read_x(f + 1);
    }
    wgmma_wait_all();
    pin(part);
    __syncwarp();
    if (lane == 0) bar_arrive(empty + 8 * (f % kBuffers));  // slot f is free
    // Slice f + 2 into slot f - 1's, once both warpgroups are done with it.
    if (threadIdx.x == 0 && f + kBuffers - 1 < total) {
      if (f > 0) bar_wait(empty + 8 * ((f - 1) % kBuffers), ((f - 1) / kBuffers) & 1);
      fetch(f + kBuffers - 1);
    }
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = part[i];
    } else {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
    if (++s == nk) finished = tile, s = 0, tile += gridDim.x;
    if (f + 1 < total) split_x();
  }
  if (finished >= 0) epilogue(finished);
}

// The dynamic shared memory past 48 KB, allowed once a device, and the
// device's SM count (the persistent grid).
int prepare(int& sms) {
  static bool allowed[kMaxDevices] = {};
  static int counts[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  sms = counts[dev];
  return 0;
}

// x [m, k] as a tensor map of boxes of kRows rows x kSlice columns, no
// swizzle, zeros past row m - 1. The driver's encoder is looked up once
// through the runtime, so nothing links against the driver library.
int x_map(CUtensorMap* map, const float* x, long long m, int k) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 4};
  const cuuint32_t box[2] = {kSlice, kRows}, steps[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims, strides, box,
                              steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

bool widths_fit(int n_out, int k) { return n_out > 0 && k > 0 && n_out % kCols == 0 && k % kSlice == 0; }

}  // namespace

extern "C" {

// w: [n_out, k] f32 on the device, contiguous, 16-byte aligned; parts: scratch
// of 8 n_out k bytes, 16-byte aligned. n_out a multiple of 128, k of 32.
// Returns the launch's cudaError (0 when it launched).
int rcf_dino_linear_split(const float* w, unsigned char* parts, int n_out, int k, void* stream) {
  if (!widths_fit(n_out, k)) return (int)cudaErrorInvalidValue;
  const long long units = (long long)n_out * (k / 16);
  split_weight<<<(unsigned)((units + kSplitThreads - 1) / kSplitThreads), kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, parts, n_out, k);
  return (int)cudaGetLastError();
}

// x: [m, k] f32, contiguous, 16-byte aligned; parts: rcf_dino_linear_split's
// of the weight; bias: [n_out]; residual: [m, n_out] or null; out: [m, n_out],
// contiguous, bias, residual and out 8-byte aligned. act_gelu: exact GELU
// after the bias, before the residual. Returns the launch's cudaError.
int rcf_dino_linear(const float* x, const unsigned char* parts, const float* bias, const float* residual,
                    float* out, int64_t m, int n_out, int k, int act_gelu, void* stream) {
  if (!widths_fit(n_out, k) || m < 0 || m > (int64_t)0x7fffffff - kRows) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  int sms = 0;
  CUtensorMap map;
  int err = prepare(sms);
  if (err == 0) err = x_map(&map, x, m, k);
  if (err != 0) return err;
  const long long tiles = (m + kRows - 1) / kRows * (long long)(n_out / kCols);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  linear_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(map, parts, bias, residual, out,
                                                                             (int)m, n_out, k, act_gelu);
  return (int)cudaGetLastError();
}

}  // extern "C"
