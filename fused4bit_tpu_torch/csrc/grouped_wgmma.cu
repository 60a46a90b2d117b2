// K2 and K13 on Hopper's warpgroup tensor cores: the grouped w4a16 expert
// products at serving and prefill sizes, where an expert holds tens to
// hundreds of routed rows; and K1's and K7's tall calls, the per-row and
// per-group linears from WG_MIN_LINEAR_ROWS rows (K1: up to its
// PREFILL_THRESHOLD).
//
//   K2:  y[m, n] = s[n] * sum_k x[m, k] * (q[n, k] - zp[n])          (RowScale)
//   K13: y[m, n] = sum over chunks c of 64 packed bytes, in order, of
//          s_lo * P_lo + c_lo * X_lo + s_hi * P_hi + c_hi * X_hi      (GroupFold)
// over the weights of expert e = gids[m / tile_m], the arithmetic of
// int4_mma.cuh's RowScale and GroupFold policies (its note gives the terms;
// the TPU kernels fused4bit_tpu/ops/grouped_matmul.py:_grouped_kernel and
// _grouped_pg_bp_kernel). K1 and K7 (G false) are K2's and K13's sums over
// one weight, the TPU kernels fused4bit_tpu/ops/int4_matmul.py:
// _int4_matmul_kernel and _int4_group_bp_kernel. Only the
// order of the sums inside the tensor core differs from int4_mma.cuh's body,
// which keeps the small calls (decode and the speculative verify;
// ops.grouped_matmul._body and ops.int4_matmul._body choose by shape,
// ops._wg._wg_takes says what this body takes).
//
// What bounds it on the H100: a step of the benchmark's cells routes 96
// (Mixtral-8x22B) or 144 (8x7B) rows to each expert, 4 x 96 or 4 x 144
// operations per weight byte, above the card's ~295: the floor is the
// tensor-core work (13.1 ms a step in both cells), with the weight bytes
// close behind (11.4 and 6.8 ms). K7's tall calls run 384 (8x22B) or 896
// (K-EXAONE) rows, K1's 576 (8x7B), 4 x M operations per weight byte: the
// tensor cores alone.
// int4_mma.cuh's body takes 16 (or 64) rows a CTA, so it streams and
// dequantizes the weights once per block of rows, with mma.sync and no
// overlap of loads and products. Here:
//
// * Work items (G, the experts): one CTA per SM, persistent, walks items
//   (expert, slice of 128 output features) in order item = blockIdx.x + i *
//   gridDim.x. The grid and the items depend on (E, N, SMs) only. An item
//   reads its expert's rows on the device: the runs of consecutive tiles with
//   gids == e, each up to its last row that the first pass flagged, in
//   passes of up to 256 (K2) or 128 (K13) rows. Each pass walks all of K
//   once, so every weight byte of a hit expert is read from memory and
//   dequantized once per pass (once per call unless an expert holds more
//   rows than a pass). The rows of a run after its last flagged row are
//   written as exactly 0; an expert with no flagged row loads no weights.
// * Work items (K1, K7): (slice of 128 features, block of 128 rows of x), the
//   row blocks of one slice next to each other in the walk, so the CTAs
//   that run side by side share the slice's weights: they come from HBM once
//   a call, from L2 for the other blocks. Every row of a dense call is used:
//   no first pass. The first `full` items (whole slices) walk all of K/2;
//   the slices after them are cut into `splits` ranges of K/2's chunks,
//   whose f32 partials int4_linear_reduce_kernel adds in order z = 0, 1, ...
//   ops._wg._wg_linear_launch picks (full, splits, grid) from (M,
//   N, K, SMs) and the policy so that the last wave is not left ragged.
// * A ring of stages in shared memory, one 64-byte chunk of K/2 each: the
//   item's 128 x 64 weight bytes (TMA, 64-byte swizzle) and the pass's x at
//   the chunk's 64 low columns and 64 high columns (TMA, 128-byte swizzle,
//   32 rows a box), and for K13 and K7 the x sums X of those columns (K13:
//   from the first pass; K7: summed from the staged x by the producer
//   warpgroup's three other warps, for which the consumers' fold waits on a
//   second barrier per stage). A producer warp keeps as many stages in
//   flight as shared memory holds (3 for K2, 5 for K13 and K7) under
//   mbarriers; two consumer warpgroups (64 output features each, 232
//   registers a thread after setmaxnreg) dequantize from shared memory and
//   run wgmma, and free a stage when its products are done.
// * wgmma m64n32k16 (K1, K7: m64n128k16, one instruction per k step over the
//   block's 128 rows) with A, the weights, from registers and B, x, from
//   shared memory: each warp dequantizes its 16 rows into the m16n8k16
//   fragment layout with int4_mma.cuh's nibble trick (bf16 bits 0x4300 | v =
//   128 + v), and one A fragment feeds one wgmma per 32 rows of the pass (a
//   bank). x stays in its own column order: a k step takes 16 low columns b
//   .. b + 15 (low nibbles of bytes b .. b + 15) or the same bytes' high
//   nibbles (columns K/2 + b ..), so a lane reads two 32-bit words of each of
//   its rows per k step. A chunk's high A fragments are dequantized while the
//   tensor cores run its low half, the next chunk's low ones while they run
//   its high half.
// * K7's fold: each half's products land in P and are folded into the
//   accumulator (2 FMAs per element) after its wgmmas are done. The two
//   consumer warpgroups issue their wgmmas in turns (two named barriers
//   pass the turn), so one folds while the other's products run. On the
//   H100 the body runs at 22-32 % of its bound at the cells' shapes; the
//   CUDA-core work (the fold and the X sums) sets the pace, not the tensor
//   cores or the bytes (PERF.md §6). K1 has no fold: its consumers run K2's
//   loop (no turns; the low half's wgmmas, then the high half's, straight
//   into the accumulator), and the producer warpgroup's three other warps
//   have nothing to sum.
// * Sums: a row's products run over K in chunk order and, inside a chunk,
//   over its 4 low k steps, then its 4 high ones (K2, K1), or the low ones
//   into P (zeroed by the first), folded, then the high ones, folded (K13,
//   K7, with the fold's fmaf order of int4_mma.cuh). That order is fixed by
//   (N, K) (K1, K7: and their ranges), so a row's bits do not depend on T,
//   tile_m, the routing, the pass or the bank it lands in. K1's s[n]
//   multiplies the f32 sum over all of K/2 once: in the epilogue of a whole
//   item, or in the second pass after it adds the ranges' raw partials in
//   order, so a cut slice's y is s[n] * (P_0 + P_1 + ...). No float
//   atomics; y is written in full.
//
// Launch (ops._wg._launch, over a tile map): a first pass (K2:
// int4_mma.cuh's rows_used_kernel; K13: fold_rows_used_kernel, which also
// writes X), then int4_mma_kernel_wg<P, true> on grid CTAs of 384 threads.
// K1 and K7 (ops._wg._launch, no tile map): int4_mma_kernel_wg<RowScale,
// false> or <GroupFold, false>, then where slices are cut into ranges
// int4_linear_reduce_kernel. Requires bf16 x, N % 128 == 0, K/2 % 64 == 0,
// tile_m % 16 == 0, 16-byte aligned x and weights, and for K13 and K7 gs %
// 64 == 0 dividing K/2.
#include <cuda.h>

#include "int4_mma.cuh"

namespace f4b {
namespace {

constexpr int kWgThreads = 384;         // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kWgConsumerWarps = 8;
constexpr int kWgSlice = 128;           // output features per item
constexpr int kBank = 32;               // x rows per wgmma (m64n32k16) and per TMA box of x
constexpr int kXBox = kBank * 128;      // bytes of one TMA box of x: 32 rows x 64 bf16
constexpr int kWTile = kWgSlice * kChunkBytes;  // bytes of one stage's weights
constexpr int kMaxStages = 8;
constexpr int kXsumThreads = 96;        // K7: the producer warpgroup's warps 1-3 sum x
constexpr int kLinearRows = 4 * kBank;  // x rows of a linear's item (K1, K7): one m64n128k16

// x rows per pass and stages of the ring: K13 keeps its P sums beside the
// accumulator, so it takes half K2's rows (per consumer thread: 4 banks x 16
// f32 of acc + 16 of P, against K2's 8 x 16 of acc); a linear's item (G
// false) takes kLinearRows.
template <class P, bool G = true>
struct WgShape {
  static constexpr int kRows = !G ? kLinearRows : (P::kFold ? 128 : 256);
  static constexpr int kBanks = kRows / kBank;
  static constexpr int kXsBytes = P::kFold ? 2 * kRows * 4 : 0;  // X of both halves
  static constexpr int kStageBytes = 2 * kRows * 128 + kWTile + kXsBytes;
};

struct WgArgs {
  const int32_t* gids;    // [T / tile_m]; K1, K7: null
  const int32_t* used;    // [T] the first pass's row flags; K1, K7: null
  const float* xsum;      // K13: [2 * K/128][T] X per (chunk, half) and row; else null
  const float* scales;    // [E, N] (K2; K1 E = 1) or [E, N, K/gs] (K13; K7 E = 1)
  const float* zps;       // the same shape
  __nv_bfloat16* y;       // [T, N]
  int T, N, K, E, gs, tile_m, stages;
  // K1, K7: items over all of K/2, ranges of K/2's chunks of the slices after
  // them, blocks of kRows rows of x, and the ranges' f32 partials [splits,
  // T, N - full / blocks * 128] (null where no slice is cut)
  int full, splits, blocks;
  float* partial;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Named barriers of the two consumer warpgroups (256 threads): wait for the
// turn, or pass it on.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the fence, commit and wait, which it does not see them depend on.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int B, int N>
__device__ __forceinline__ void reg_fence(float (&r)[B][N]) {
#pragma unroll
  for (int b = 0; b < B; ++b) reg_fence(r[b]);
}

// B descriptor of a K-major bf16 tile with 128-byte rows in the 128-byte
// swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x 32 f32, the m16n8 accumulator layout per warp and n8 tile) +=
// a (64 x 16 bf16, the m16n8k16 A fragment per warp) * b (16 x 32, desc);
// d is first zeroed where scale_d == 0.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The same over the 128 x rows of a K7 block: d[b] holds bank b's 32 rows,
// the n32 layout of wgmma_n32 side by side.
__device__ __forceinline__ void wgmma_n128(float (&d)[4][16], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]),
        "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]), "+f"(d[0][8]), "+f"(d[0][9]),
        "+f"(d[0][10]), "+f"(d[0][11]), "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]),
        "+f"(d[0][15]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]), "+f"(d[1][8]),
        "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]), "+f"(d[1][12]), "+f"(d[1][13]),
        "+f"(d[1][14]), "+f"(d[1][15]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]),
        "+f"(d[2][3]), "+f"(d[2][4]), "+f"(d[2][5]), "+f"(d[2][6]), "+f"(d[2][7]),
        "+f"(d[2][8]), "+f"(d[2][9]), "+f"(d[2][10]), "+f"(d[2][11]), "+f"(d[2][12]),
        "+f"(d[2][13]), "+f"(d[2][14]), "+f"(d[2][15]), "+f"(d[3][0]), "+f"(d[3][1]),
        "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[3][4]), "+f"(d[3][5]), "+f"(d[3][6]),
        "+f"(d[3][7]), "+f"(d[3][8]), "+f"(d[3][9]), "+f"(d[3][10]), "+f"(d[3][11]),
        "+f"(d[3][12]), "+f"(d[3][13]), "+f"(d[3][14]), "+f"(d[3][15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The 8 bf16 values of w summed as a tree, f32: ((v0 + v1) + (v2 + v3)) +
// ((v4 + v5) + (v6 + v7)); a chunk's X adds 8 of these in order.
__device__ __forceinline__ float tree8(const uint4 w) {
  const float2 f0 = __bfloat1622float2(bits_bf2(w.x));
  const float2 f1 = __bfloat1622float2(bits_bf2(w.y));
  const float2 f2 = __bfloat1622float2(bits_bf2(w.z));
  const float2 f3 = __bfloat1622float2(bits_bf2(w.w));
  return ((f0.x + f0.y) + (f1.x + f1.y)) + ((f2.x + f2.y) + (f3.x + f3.y));
}

// K13's first pass: int4_mma.cuh's rows_used_kernel (used[m] = 1 if row m of
// x holds a nonzero bit) and X of every (chunk c, half h) of the row,
// xsum[(2c + h) * T + m], summed as int4_mma.cuh's body sums a staged chunk:
// 8 vectors of 8 values each as a tree, the 8 vector sums in order. A CTA
// per row; K/2 % 64 == 0.
__global__ void __launch_bounds__(kMmaThreads) fold_rows_used_kernel(
    const __nv_bfloat16* __restrict__ x, int T, int K, int32_t* __restrict__ used,
    float* __restrict__ xsum) {
  const int m = blockIdx.x;
  const int kh = K / 2;
  const int halves = 2 * (kh / kChunkBytes);
  uint32_t bits = 0u;
  for (int ch = threadIdx.x; ch < halves; ch += kMmaThreads) {
    const uint4* v = reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K +
                                                    (ch & 1) * kh + (ch >> 1) * kChunkBytes);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < kChunkBytes / 8; ++u) {
      const uint4 w = __ldg(v + u);
      bits |= w.x | w.y | w.z | w.w;
      sum += tree8(w);
    }
    xsum[static_cast<size_t>(ch) * T + m] = sum;
  }
  const int any = __syncthreads_or(bits != 0u);
  if (threadIdx.x == 0) used[m] = any != 0;
}

// The next run of consecutive tiles of expert e at or after tile `from`:
// (first, end), first == tiles when there is none. Warp-collective.
__device__ __forceinline__ int2 next_run(const int32_t* gids, int tiles, int e, int from) {
  const int lane = threadIdx.x & 31;
  int first = tiles;
  for (int t0 = from; t0 < tiles; t0 += 32) {
    const int t = t0 + lane;
    const unsigned hit = __ballot_sync(~0u, t < tiles && __ldg(gids + t) == e);
    if (hit) {
      first = t0 + __ffs(hit) - 1;
      break;
    }
  }
  int end = tiles;
  for (int t0 = first + 1; t0 < tiles; t0 += 32) {
    const int t = t0 + lane;
    const unsigned miss = __ballot_sync(~0u, t < tiles && __ldg(gids + t) != e);
    if (miss) {
      end = t0 + __ffs(miss) - 1;
      break;
    }
  }
  return make_int2(first, end);
}

// 1 + the last row in [r0, r1) that the first pass flagged, or r0 if none.
// Warp-collective.
__device__ __forceinline__ int rows_in_use_end(const int32_t* used, int r0, int r1) {
  const int lane = threadIdx.x & 31;
  for (int top = r1; top > r0; top -= 32) {
    const int r = top - 1 - lane;
    const unsigned hit = __ballot_sync(~0u, r >= r0 && used[r] != 0);
    if (hit) return top - __ffs(hit) + 1;
  }
  return r0;
}

// A fragments of one half of a stage's chunk: for each block j of 16 bytes,
// the low nibbles (HI false: the k step over low columns 16j .. 16j + 15)
// or the high ones, registers [row na cols 2t, nb 2t, na 2t + 8, nb 2t + 8];
// raw codes (GroupFold: q_lo, q_hi - 8) or q - zp (RowScale, z = 128 + zp of
// rows na, nb).
template <class P, bool HI>
__device__ __forceinline__ void dequant_half(uint32_t (&a)[4][4], const unsigned char* wa,
                                             int xo, int t, uint32_t sel, uint32_t zpa,
                                             uint32_t zpb) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int off = ((j ^ xo) << 4) + 4 * (t >> 1);
    uint32_t v[4], h[4];
    nibbles_bf16x2(*reinterpret_cast<const uint32_t*>(wa + off), sel, v[0], h[0]);
    nibbles_bf16x2(*reinterpret_cast<const uint32_t*>(wa + 8 * kChunkBytes + off), sel, v[1], h[1]);
    nibbles_bf16x2(*reinterpret_cast<const uint32_t*>(wa + off + 8), sel, v[2], h[2]);
    nibbles_bf16x2(*reinterpret_cast<const uint32_t*>(wa + 8 * kChunkBytes + off + 8), sel, v[3],
                   h[3]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t z = P::kFold ? (HI ? 0x43084308u : 0x43004300u) : (r & 1) ? zpb : zpa;
      a[j][r] = bf2_bits(__hsub2(bits_bf2(HI ? h[r] : v[r]), bits_bf2(z)));
    }
  }
}

// K13's fold of one bank's half h into its accumulator, int4_mma.cuh's
// order: acc = fmaf(c, X, fmaf(s, P, acc)) with (s, c) = f[2h], f[2h + 1] of
// the element's weight row (fa: row na, fb: nb) and X of its x row (xs: the
// half's sums at the lane's first x row of the bank).
__device__ __forceinline__ void fold_bank(float (&acc)[16], const float (&part)[16],
                                          const float* xs, const float (&fa)[4],
                                          const float (&fb)[4], int h) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xx = *reinterpret_cast<const float2*>(xs + 8 * i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* f = (j >> 1) ? fb : fa;
      const float v = fmaf(f[2 * h], part[4 * i + j], acc[4 * i + j]);
      acc[4 * i + j] = fmaf(f[2 * h + 1], (j & 1) ? xx.y : xx.x, v);
    }
  }
}

// K2 and K13: the producer warp's and the consumer warpgroups' walk over the
// items (expert, slice), each expert's runs of tiles and their passes.
template <class P>
__device__ __forceinline__ void grouped_body(const CUtensorMap& xmap, const CUtensorMap& wmap,
                                             const WgArgs& p, uint64_t* full, uint64_t* empty,
                                             uint32_t ring, unsigned char* ring_ptr) {
  using S = WgShape<P>;
  const int kh = p.K / 2;
  const int chunks = kh / kChunkBytes;
  const int tiles = p.T / p.tile_m;
  const int slices = p.N / kWgSlice;
  const int items = p.E * slices;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= kWgConsumerWarps) {
    // The producer warpgroup: its first warp keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != kWgConsumerWarps) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int e = item / slices, n0 = (item - e * slices) * kWgSlice;
      for (int2 run = next_run(p.gids, tiles, e, 0); run.x < tiles;
           run = next_run(p.gids, tiles, e, run.y)) {
        const int rb = run.x * p.tile_m;
        const int ru = rows_in_use_end(p.used, rb, min(run.y * p.tile_m, p.T));
        for (int r0 = rb; r0 < ru; r0 += S::kRows) {
          const int banks = (min(S::kRows, ru - r0) + kBank - 1) / kBank;
          const int xs_rows = min(banks * kBank, p.T - r0);
          const uint32_t bytes = kWTile + 2 * banks * kXBox + (P::kFold ? 8 * xs_rows : 0);
          for (int c = 0; c < chunks; ++c) {
            mbar_wait(smem_u32(&empty[stage]), phase ^ 1u);
            if (lane == 0) {
              const uint32_t bar = smem_u32(&full[stage]);
              const uint32_t base = ring + stage * S::kStageBytes;
              mbar_expect(bar, bytes);
              if constexpr (P::kFold) {
                const int g = c * kChunkBytes / p.gs;
                tma_3d(base + 2 * S::kRows * 128, &wmap, bar, c * kChunkBytes - g * p.gs, n0,
                       e * (kh / p.gs) + g);
              } else {
                tma_2d(base + 2 * S::kRows * 128, &wmap, bar, c * kChunkBytes, e * p.N + n0);
              }
              for (int b = 0; b < banks; ++b) {
                tma_2d(base + b * kXBox, &xmap, bar, c * kChunkBytes, r0 + b * kBank);
                tma_2d(base + S::kRows * 128 + b * kXBox, &xmap, bar, kh + c * kChunkBytes,
                       r0 + b * kBank);
              }
              if constexpr (P::kFold) {
                const uint32_t xs = base + 2 * S::kRows * 128 + kWTile;
                for (int h = 0; h < 2; ++h)
                  bulk_copy(xs + h * S::kRows * 4, p.xsum + static_cast<size_t>(2 * c + h) * p.T + r0,
                            4 * xs_rows, bar);
              }
            }
            __syncwarp();
            if (++stage == p.stages) {
              stage = 0;
              phase ^= 1u;
            }
          }
        }
      }
    }
    return;
  }

  // The consumer warpgroups: warpgroup q takes output features 64q .. 64q + 63
  // of the item's slice, warp w (of 4) its 16 rows na = .. + 16w + g and
  // nb = na + 8.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int q = warp >> 2, w = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = 64 * q + 16 * w + g;      // in the slice
  const uint32_t sel = (t & 1) ? 0x4342u : 0x4140u;
  const int xo = (g >> 1) & 3;                // the 64-byte swizzle of rows row_a, row_a + 8
  const int ng = P::kFold ? p.K / p.gs : 1;
  int stage = 0;
  uint32_t phase = 0;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int e = item / slices, n0 = (item - e * slices) * kWgSlice;
    const int na = n0 + row_a, nb = na + 8;
    const float* sa = p.scales + (static_cast<size_t>(e) * p.N + na) * ng;
    const float* sb = p.scales + (static_cast<size_t>(e) * p.N + nb) * ng;
    const float* za = p.zps + (static_cast<size_t>(e) * p.N + na) * ng;
    const float* zb = p.zps + (static_cast<size_t>(e) * p.N + nb) * ng;
    uint32_t zpa = 0u, zpb = 0u;  // K2: (128 + zp) of rows na, nb
    if constexpr (!P::kFold) {
      zpa = zp_pair(__ldg(za));
      zpb = zp_pair(__ldg(zb));
    }

    for (int2 run = next_run(p.gids, tiles, e, 0); run.x < tiles;
         run = next_run(p.gids, tiles, e, run.y)) {
      const int rb = run.x * p.tile_m, re = min(run.y * p.tile_m, p.T);
      const int ru = rows_in_use_end(p.used, rb, re);
      for (int r0 = rb; r0 < ru; r0 += S::kRows) {
        const int rows = min(S::kRows, ru - r0);
        const int banks = (rows + kBank - 1) / kBank;
        // acc[b][4i + j]: (row na for j < 2 else nb, x row r0 + 32b + 8i + 2t + (j & 1))
        float acc[S::kBanks][16];
#pragma unroll
        for (int b = 0; b < S::kBanks; ++b)
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[b][i] = 0.f;

        // Per chunk: the low half's wgmmas | the high half's A fragments;
        // (K13: fold the low half;) the high half's wgmmas | the next chunk's
        // low A fragments; (K13: fold the high half;) free the stage. The
        // registers of an A fragment are rewritten only after the wgmmas that
        // read them are done.
        uint32_t alo[4][4], ahi[4][4];
        const unsigned char* wrow = ring_ptr + 2 * S::kRows * 128 + row_a * kChunkBytes;
        mbar_wait(smem_u32(&full[stage]), phase);
        dequant_half<P, false>(alo, wrow + stage * S::kStageBytes, xo, t, sel, zpa, zpb);
        for (int c = 0; c < chunks; ++c) {
          float fa[4], fb[4];  // K13: the chunk's [s_lo, c_lo, s_hi, c_hi] of rows na, nb
          if constexpr (P::kFold) {
            const int gl = c * kChunkBytes / p.gs, gh = ng / 2 + gl;
            const float sla = __ldg(sa + gl), sha = __ldg(sa + gh);
            const float slb = __ldg(sb + gl), shb = __ldg(sb + gh);
            const float zla = __ldg(za + gl), zha = __ldg(za + gh);
            const float zlb = __ldg(zb + gl), zhb = __ldg(zb + gh);
            fa[0] = sla;
            fa[1] = -sla * zla;
            fa[2] = sha;
            fa[3] = sha * (8.f - zha);
            fb[0] = slb;
            fb[1] = -slb * zlb;
            fb[2] = shb;
            fb[3] = shb * (8.f - zhb);
          }
          const uint32_t base = ring + stage * S::kStageBytes;
          // B descriptors; bank b, k step j: + (32 rows * 128 bytes * b + 32 bytes * j) / 16
          const uint64_t dlo = sw128_desc(base), dhi = sw128_desc(base + S::kRows * 128);
          const float* xs = reinterpret_cast<const float*>(ring_ptr + stage * S::kStageBytes +
                                                           2 * S::kRows * 128 + kWTile);
          float part[S::kBanks][16];  // K13: P of a bank's half, zeroed by its first k step
          reg_fence(acc);
          wg_fence();
#pragma unroll
          for (int b = 0; b < S::kBanks; ++b)
            if (b < banks) {  // warpgroup-uniform
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if constexpr (P::kFold)
                  wgmma_n32(part[b], alo[j], dlo + b * (kXBox >> 4) + 2 * j, j);
                else
                  wgmma_n32(acc[b], alo[j], dlo + b * (kXBox >> 4) + 2 * j, 1);
              }
            }
          wg_commit();
          dequant_half<P, true>(ahi, wrow + stage * S::kStageBytes, xo, t, sel, zpa, zpb);
          if constexpr (P::kFold) {
            wg_wait_all();
#pragma unroll
            for (int b = 0; b < S::kBanks; ++b) {
              reg_fence(part[b]);
              if (b < banks) fold_bank(acc[b], part[b], xs + kBank * b + 2 * t, fa, fb, 0);
            }
            reg_fence(part);
          }
          wg_fence();
#pragma unroll
          for (int b = 0; b < S::kBanks; ++b)
            if (b < banks) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if constexpr (P::kFold)
                  wgmma_n32(part[b], ahi[j], dhi + b * (kXBox >> 4) + 2 * j, j);
                else
                  wgmma_n32(acc[b], ahi[j], dhi + b * (kXBox >> 4) + 2 * j, 1);
              }
            }
          wg_commit();
          const int done = stage;
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1u;
          }
          if (c + 1 < chunks) {
            if constexpr (!P::kFold) wg_wait_one();  // the low half's wgmmas: alo is free
            mbar_wait(smem_u32(&full[stage]), phase);
            dequant_half<P, false>(alo, wrow + stage * S::kStageBytes, xo, t, sel, zpa, zpb);
          }
          wg_wait_all();
          if constexpr (P::kFold) {
#pragma unroll
            for (int b = 0; b < S::kBanks; ++b) {
              reg_fence(part[b]);
              if (b < banks) fold_bank(acc[b], part[b], xs + S::kRows + kBank * b + 2 * t, fa, fb, 1);
            }
          } else {
            reg_fence(acc);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(&empty[done]));
        }

        // The pass's rows in use: y[m, n] = (K2: s[n] *) acc
        const float s_a = P::kFold ? 1.f : __ldg(sa), s_b = P::kFold ? 1.f : __ldg(sb);
#pragma unroll
        for (int b = 0; b < S::kBanks; ++b) {
          if (b < banks) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int m = kBank * b + 8 * i + 2 * t;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int mm = m + (j & 1);
                if (mm < rows) {
                  const float v = acc[b][4 * i + j];
                  p.y[static_cast<size_t>(r0 + mm) * p.N + ((j >> 1) ? nb : na)] =
                      __float2bfloat16((j >> 1) ? s_b * v : s_a * v);
                }
              }
            }
          }
        }
      }
      // The run's rows after its last flagged row: 0 in the warpgroup's 64
      // features, 16 bytes a thread.
      const int tq = threadIdx.x & 127;
      for (int i = tq; i < (re - ru) * 8; i += 128) {
        const int r = ru + (i >> 3);
        *reinterpret_cast<uint4*>(p.y + static_cast<size_t>(r) * p.N + n0 + 64 * q + 8 * (i & 7)) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
}

// The ring's barriers (full: the stage's TMA landed; empty: its consumers
// are done; K7's xfull: its X are summed), then the CTA synchronised.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, uint64_t* xfull,
                                          int stages) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), kWgConsumerWarps);
      if (xfull != nullptr) mbar_init(smem_u32(&xfull[i]), kXsumThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A linear's work item (K1, K7): output features n0 .. n0 + 127, x rows r0 ..
// r0 + 127 (those below T), chunks c0 .. c1 of K/2, range z (-1: all of K/2,
// y written directly). The first p.full items take all of K/2, the slices
// after them p.splits ranges each; items run slice by slice, then range by
// range, the row blocks innermost.
struct LinearItem {
  int n0, r0, c0, c1, z;
};

__device__ __forceinline__ LinearItem linear_item(const WgArgs& p, int item, int chunks) {
  if (item < p.full) {
    const int slice = item / p.blocks, block = item - slice * p.blocks;
    return LinearItem{slice * kWgSlice, block * kLinearRows, 0, chunks, -1};
  }
  const int j = item - p.full, per_slice = p.splits * p.blocks;
  const int slice = p.full / p.blocks + j / per_slice, rest = j % per_slice;
  const int z = rest / p.blocks, block = rest - z * p.blocks;
  const int span = (chunks + p.splits - 1) / p.splits;
  return LinearItem{slice * kWgSlice, block * kLinearRows, z * span, min(chunks, (z + 1) * span),
                    z};
}

// The items of a linear's launch: p.full whole, then p.splits ranges of each
// slice left.
__device__ __forceinline__ int linear_items(const WgArgs& p) {
  return p.full + (p.N / kWgSlice - p.full / p.blocks) * p.splits * p.blocks;
}

// A linear's second pass: y[m, n0 + n] = the ranges' f32 partials [splits, M,
// N - n0] added in order z = 0, 1, ..., then (K1: scales not null) times
// s[n0 + n]; a CTA per row of y and 256 of its columns.
__global__ void __launch_bounds__(kMmaThreads) int4_linear_reduce_kernel(
    const float* __restrict__ partial, const float* __restrict__ scales,
    __nv_bfloat16* __restrict__ y, int M, int N, int n0, int splits) {
  const int m = blockIdx.x;
  const int n = blockIdx.y * kMmaThreads + threadIdx.x;
  const int nt = N - n0;
  if (n >= nt) return;
  const size_t mn = static_cast<size_t>(M) * nt, at = static_cast<size_t>(m) * nt + n;
  float v = partial[at];
  for (int z = 1; z < splits; ++z) v += partial[z * mn + at];
  if (scales != nullptr) v = __ldg(scales + n0 + n) * v;
  y[static_cast<size_t>(m) * N + n0 + n] = __float2bfloat16(v);
}

// A linear item's outputs: y[m, n] = (K1: s[n] *) acc (all of K/2), or the
// range's raw f32 partial.
template <class P>
__device__ __forceinline__ void linear_store(const WgArgs& p, const LinearItem& it,
                                             const float (&acc)[4][16], int na, int nb, int t,
                                             float s_a, float s_b) {
  const int rows = min(kLinearRows, p.T - it.r0);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = kBank * b + 8 * i + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int mm = m + (j & 1);
        if (mm < rows) {
          const size_t at = static_cast<size_t>(it.r0 + mm) * p.N + ((j >> 1) ? nb : na);
          const float v = acc[b][4 * i + j];
          if (it.z < 0) {
            p.y[at] = __float2bfloat16(P::kFold ? v : ((j >> 1) ? s_b : s_a) * v);
          } else {
            const int nt = p.N - p.full / p.blocks * kWgSlice;
            p.partial[(static_cast<size_t>(it.z) * p.T + it.r0 + mm) * nt +
                      ((j >> 1) ? nb : na) - (p.N - nt)] = v;
          }
        }
      }
    }
  }
}

// K1 and K7: the producer warp; K7's three warps that sum the staged x (X of
// each row, chunk and half, in int4_mma.cuh's order: 8 vectors of 8 as
// trees, the 8 in order); and the consumer warpgroups, K7's taking the
// wgmma turns.
template <class P>
__device__ __forceinline__ void linear_body(const CUtensorMap& xmap, const CUtensorMap& wmap,
                                            const WgArgs& p, uint64_t* full, uint64_t* empty,
                                            uint64_t* xfull, uint32_t ring,
                                            unsigned char* ring_ptr) {
  using S = WgShape<P, false>;
  static_assert(S::kRows == kLinearRows, "a linear's block is one m64n128k16 wide");
  const int kh = p.K / 2;
  const int chunks = kh / kChunkBytes;
  const int items = linear_items(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= kWgConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    int stage = 0;
    uint32_t phase = 0;
    if (warp == kWgConsumerWarps) {
      // Keep the ring full: the slice's weight chunk and the block's boxes of x.
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const LinearItem it = linear_item(p, item, chunks);
        const int boxes = (min(S::kRows, p.T - it.r0) + kBank - 1) / kBank;
        const uint32_t bytes = kWTile + 2 * boxes * kXBox;
        for (int c = it.c0; c < it.c1; ++c) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1u);
          if (lane == 0) {
            const uint32_t bar = smem_u32(&full[stage]);
            const uint32_t base = ring + stage * S::kStageBytes;
            mbar_expect(bar, bytes);
            if constexpr (P::kFold) {
              const int g = c * kChunkBytes / p.gs;
              tma_3d(base + 2 * S::kRows * 128, &wmap, bar, c * kChunkBytes - g * p.gs, it.n0, g);
            } else {
              tma_2d(base + 2 * S::kRows * 128, &wmap, bar, c * kChunkBytes, it.n0);
            }
            for (int b = 0; b < boxes; ++b) {
              tma_2d(base + b * kXBox, &xmap, bar, c * kChunkBytes, it.r0 + b * kBank);
              tma_2d(base + S::kRows * 128 + b * kXBox, &xmap, bar, kh + c * kChunkBytes,
                     it.r0 + b * kBank);
            }
          }
          __syncwarp();
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
      return;
    }
    // K7: X of the staged rows, a thread per (half, row): row r's 16-byte
    // vector u sits at u ^ (r % 8) (the 128-byte swizzle). Rows of a box past
    // T are TMA's zeros; rows past the boxes are never stored. K1 has none.
    if constexpr (P::kFold) {
      const int tx = threadIdx.x - (kWgConsumerWarps + 1) * 32;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const LinearItem it = linear_item(p, item, chunks);
        const int xrows = (min(S::kRows, p.T - it.r0) + kBank - 1) / kBank * kBank;
        for (int c = it.c0; c < it.c1; ++c) {
          mbar_wait(smem_u32(&full[stage]), phase);
          const unsigned char* st = ring_ptr + stage * S::kStageBytes;
          float* xs = reinterpret_cast<float*>(const_cast<unsigned char*>(st) +
                                               2 * S::kRows * 128 + kWTile);
          for (int e = tx; e < 2 * S::kRows; e += kXsumThreads) {
            const int h = e / S::kRows, r = e - h * S::kRows;
            if (r < xrows) {
              const unsigned char* row = st + h * S::kRows * 128 + r * 128;
              float sum = 0.f;
#pragma unroll
              for (int u = 0; u < 8; ++u)
                sum += tree8(*reinterpret_cast<const uint4*>(row + ((u ^ (r & 7)) << 4)));
              xs[e] = sum;
            }
          }
          mbar_arrive(smem_u32(&xfull[stage]));
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // The consumer warpgroups: warpgroup q takes output features 64q .. 64q + 63
  // of the item's slice, warp w (of 4) its 16 rows na = .. + 16w + g and
  // nb = na + 8. K7: warpgroup q waits for its turn on barrier 1 + q and
  // passes it on barrier 2 - q; warpgroup 0 has the first.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int q = warp >> 2, w = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = 64 * q + 16 * w + g;      // in the slice
  const uint32_t sel = (t & 1) ? 0x4342u : 0x4140u;
  const int xo = (g >> 1) & 3;                // the 64-byte swizzle of rows row_a, row_a + 8
  const unsigned char* wrow = ring_ptr + 2 * S::kRows * 128 + row_a * kChunkBytes;
  int stage = 0;
  uint32_t phase = 0;

  if constexpr (!P::kFold) {
    // K1: K2's loop per chunk: the low half's wgmmas | the high half's A
    // fragments; the high half's wgmmas | the next chunk's low A fragments
    // (once the low half's are done); free the stage. s[n] waits for the
    // epilogue or the second pass.
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const LinearItem it = linear_item(p, item, chunks);
      const int na = it.n0 + row_a, nb = na + 8;
      const uint32_t zpa = zp_pair(__ldg(p.zps + na)), zpb = zp_pair(__ldg(p.zps + nb));
      // acc[b][4i + j]: (row na for j < 2 else nb, x row r0 + 32b + 8i + 2t + (j & 1))
      float acc[4][16];
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[b][i] = 0.f;

      uint32_t alo[4][4], ahi[4][4];
      if (it.c0 < it.c1) {
        mbar_wait(smem_u32(&full[stage]), phase);
        dequant_half<P, false>(alo, wrow + stage * S::kStageBytes, xo, t, sel, zpa, zpb);
      }
      for (int c = it.c0; c < it.c1; ++c) {
        const uint32_t base = ring + stage * S::kStageBytes;
        const uint64_t dlo = sw128_desc(base), dhi = sw128_desc(base + S::kRows * 128);
        reg_fence(acc);
        wg_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) wgmma_n128(acc, alo[j], dlo + 2 * j, 1);
        wg_commit();
        dequant_half<P, true>(ahi, wrow + stage * S::kStageBytes, xo, t, sel, zpa, zpb);
        wg_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) wgmma_n128(acc, ahi[j], dhi + 2 * j, 1);
        wg_commit();
        const int done = stage;
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1u;
        }
        if (c + 1 < it.c1) {
          wg_wait_one();  // the low half's wgmmas: alo is free
          mbar_wait(smem_u32(&full[stage]), phase);
          dequant_half<P, false>(alo, wrow + stage * S::kStageBytes, xo, t, sel, zpa, zpb);
        }
        wg_wait_all();
        reg_fence(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&empty[done]));
      }
      linear_store<P>(p, it, acc, na, nb, t, __ldg(p.scales + na), __ldg(p.scales + nb));
    }
  } else {
    const int ng = p.K / p.gs;
    const int mine = 1 + q, other = 2 - q;
    if (q == 1) turn_pass(other);

    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const LinearItem it = linear_item(p, item, chunks);
      const int na = it.n0 + row_a, nb = na + 8;
      const float* sa = p.scales + static_cast<size_t>(na) * ng;
      const float* sb = p.scales + static_cast<size_t>(nb) * ng;
      const float* za = p.zps + static_cast<size_t>(na) * ng;
      const float* zb = p.zps + static_cast<size_t>(nb) * ng;
      // acc[b][4i + j]: (row na for j < 2 else nb, x row r0 + 32b + 8i + 2t + (j & 1))
      float acc[4][16];
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[b][i] = 0.f;

      uint32_t alo[4][4], ahi[4][4];
      if (it.c0 < it.c1) {
        mbar_wait(smem_u32(&full[stage]), phase);
        dequant_half<P, false>(alo, wrow + stage * S::kStageBytes, xo, t, sel, 0u, 0u);
      }
      for (int c = it.c0; c < it.c1; ++c) {
        // [s_lo, c_lo, s_hi, c_hi] of rows na, nb
        const int gl = c * kChunkBytes / p.gs, gh = ng / 2 + gl;
        const float sla = __ldg(sa + gl), sha = __ldg(sa + gh);
        const float slb = __ldg(sb + gl), shb = __ldg(sb + gh);
        const float zla = __ldg(za + gl), zha = __ldg(za + gh);
        const float zlb = __ldg(zb + gl), zhb = __ldg(zb + gh);
        const float fa[4] = {sla, -sla * zla, sha, sha * (8.f - zha)};
        const float fb[4] = {slb, -slb * zlb, shb, shb * (8.f - zhb)};
        const uint32_t base = ring + stage * S::kStageBytes;
        const uint64_t dlo = sw128_desc(base), dhi = sw128_desc(base + S::kRows * 128);
        const float* xs = reinterpret_cast<const float*>(ring_ptr + stage * S::kStageBytes +
                                                         2 * S::kRows * 128 + kWTile);
        const uint32_t xbar = smem_u32(&xfull[stage]);
        const uint32_t xphase = phase;
        float part[4][16];  // P of a half, zeroed by its first k step

        turn_wait(mine);
        wg_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) wgmma_n128(part, alo[j], dlo + 2 * j, j);
        wg_commit();
        turn_pass(other);
        dequant_half<P, true>(ahi, wrow + stage * S::kStageBytes, xo, t, sel, 0u, 0u);
        mbar_wait(xbar, xphase);
        wg_wait_all();
        reg_fence(part);
#pragma unroll
        for (int b = 0; b < 4; ++b) fold_bank(acc[b], part[b], xs + kBank * b + 2 * t, fa, fb, 0);
        reg_fence(part);

        turn_wait(mine);
        wg_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) wgmma_n128(part, ahi[j], dhi + 2 * j, j);
        wg_commit();
        turn_pass(other);
        const int done = stage;
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1u;
        }
        if (c + 1 < it.c1) {
          mbar_wait(smem_u32(&full[stage]), phase);
          dequant_half<P, false>(alo, wrow + stage * S::kStageBytes, xo, t, sel, 0u, 0u);
        }
        wg_wait_all();
        reg_fence(part);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          fold_bank(acc[b], part[b], xs + S::kRows + kBank * b + 2 * t, fa, fb, 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&empty[done]));
      }
      linear_store<P>(p, it, acc, na, nb, t, 1.f, 1.f);
    }
    if (q == 0) turn_wait(mine);  // the turn warpgroup 1 passed last
  }
}

template <class P, bool G>
__global__ void __launch_bounds__(kWgThreads, 1) int4_mma_kernel_wg(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const WgArgs p) {
  // G names the grouped addressing, as int4_mma.cuh's flag does; the
  // benchmark's kernel families read it from the symbol (K1, K7: false).
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  // The ring, 1024-byte aligned for the 128-byte swizzle: stage i holds
  // [x low | x high | weights | X low, X high].
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_ptr = smem_raw + (ring - raw);

  if constexpr (G) {
    init_ring(full, empty, nullptr, p.stages);
    grouped_body<P>(xmap, wmap, p, full, empty, ring, ring_ptr);
  } else {
    __shared__ __align__(8) uint64_t xfull[kMaxStages];  // K7: X of the stage summed
    init_ring(full, empty, P::kFold ? xfull : nullptr, p.stages);
    linear_body<P>(xmap, wmap, p, full, empty, xfull, ring, ring_ptr);
  }
}

// cuTensorMapEncodeTiled, looked up in the libcuda the CUDA runtime has loaded.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault) != cudaSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

inline bool encode(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type, int rank,
                   const void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                   const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x [T, K] bf16 in boxes of 32 rows x 64 columns, 128-byte swizzle.
inline bool encode_x(EncodeTiled fn, CUtensorMap* map, const void* x, int T, int K) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(T)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {64, kBank};
  return encode(fn, map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

// planar_groups bytes [E * K/2/gs, N, gs] in boxes of one group's 64 bytes x
// 128 rows, 64-byte swizzle.
inline bool encode_groups(EncodeTiled fn, CUtensorMap* map, const void* packed, int N, int K,
                          int E, int gs) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(gs), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(E) * (K / 2 / gs)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(gs), static_cast<cuuint64_t>(N) * gs};
  const cuuint32_t box[3] = {kChunkBytes, kWgSlice, 1};
  return encode(fn, map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, packed, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_64B);
}

// planar bytes [E * N, K/2] in boxes of 64 bytes x 128 rows, 64-byte swizzle.
inline bool encode_rows(EncodeTiled fn, CUtensorMap* map, const void* packed, int N, int K,
                        int E) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K / 2), static_cast<cuuint64_t>(E) * N};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K / 2)};
  const cuuint32_t box[2] = {kChunkBytes, kWgSlice};
  return encode(fn, map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, packed, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_64B);
}

// As many stages as the card's shared memory holds, at most kMaxStages, and
// the kernel allowed that much dynamic shared memory (once per device).
template <class P, bool G>
int wg_ring(int& stages, size_t& smem) {
  using S = WgShape<P, G>;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int reserve = 1024 + 3 * kMaxStages * 8 + 1024;  // alignment, barriers, spare
  stages = min(kMaxStages, (optin - reserve) / S::kStageBytes);
  if (stages < 2) return static_cast<int>(cudaErrorNotSupported);
  smem = static_cast<size_t>(stages) * S::kStageBytes + 1024;
  constexpr int kDevices = 64;
  static size_t allowed[kDevices] = {};
  if (dev >= kDevices || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(int4_mma_kernel_wg<P, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) allowed[dev] = smem;
  }
  return 0;
}

// The first pass, then `grid` persistent CTAs. x [T, K] bf16; packed [E, N,
// K/2] (K2) or [E, K/2/gs, N, gs] (K13) u8; used: int32 scratch of T; xsum
// (K13): f32 scratch of 2 * K/128 * T.
template <class P>
int launch_int4_mma_wg(const void* x, const void* gids, const void* packed, const void* scales,
                       const void* zps, void* used, void* xsum, void* y, int T, int N, int K,
                       int E, int gs, int tile_m, int grid, void* stream) {
  const bool ok = N > 0 && N % kWgSlice == 0 && K > 0 && (K / 2) % kChunkBytes == 0 && E > 0 &&
                  tile_m > 0 && tile_m % 16 == 0 && T % tile_m == 0 && grid > 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                  (!P::kFold || (gs > 0 && gs % kChunkBytes == 0 && (K / 2) % gs == 0 &&
                                 xsum != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap xmap, wmap;
  if (!encode_x(fn, &xmap, x, T, K)) return static_cast<int>(cudaErrorInvalidValue);
  if (!(P::kFold ? encode_groups(fn, &wmap, packed, N, K, E, gs)
                  : encode_rows(fn, &wmap, packed, N, K, E)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (P::kFold) {
    fold_rows_used_kernel<<<T, kMmaThreads, 0, st>>>(xb, T, K, static_cast<int32_t*>(used),
                                                     static_cast<float*>(xsum));
  } else {
    rows_used_kernel<<<T, kMmaThreads, 0, st>>>(xb, K, static_cast<int32_t*>(used));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int stages = 0;
  size_t smem = 0;
  if (const int e = wg_ring<P, true>(stages, smem)) return e;
  const WgArgs args{static_cast<const int32_t*>(gids), static_cast<const int32_t*>(used),
                    static_cast<const float*>(xsum), static_cast<const float*>(scales),
                    static_cast<const float*>(zps), static_cast<__nv_bfloat16*>(y),
                    T, N, K, E, gs, tile_m, stages};
  int4_mma_kernel_wg<P, true><<<grid, kWgThreads, smem, st>>>(xmap, wmap, args);
  return static_cast<int>(cudaGetLastError());
}

// K1 and K7: `grid` persistent CTAs over M rows in blocks of 128: the first
// `full` items (whole slices) over all of K/2, the other slices' in `splits`
// ranges of whole chunks (none empty), then with those the ordered second
// pass over partial, f32 scratch of splits * M * (N - full / blocks * 128).
// x [M, K] bf16; packed [N, K/2] (K1, gs 0) or [K/2/gs, N, gs] (K7) u8;
// scales/zps [N] or [N, K/gs].
template <class P>
int launch_int4_linear_wg(const void* x, const void* packed, const void* scales, const void* zps,
                          void* y, void* partial, int M, int N, int K, int gs, int full, int splits,
                          int grid, void* stream) {
  const int chunks = K > 0 ? (K / 2) / kChunkBytes : 0;
  const int span = splits > 0 ? (chunks + splits - 1) / splits : 0;
  const int blocks = (M + kLinearRows - 1) / kLinearRows;
  const int slices = N / kWgSlice;
  const bool tail = full < slices * blocks;
  const bool ok = M >= 0 && N > 0 && N % kWgSlice == 0 && K > 0 && (K / 2) % kChunkBytes == 0 &&
                  (P::kFold ? gs > 0 && gs % kChunkBytes == 0 && (K / 2) % gs == 0 : gs == 0) &&
                  splits >= 1 && (splits - 1) * span < chunks && full >= 0 &&
                  full <= slices * blocks && (blocks == 0 || full % blocks == 0) &&
                  (!tail || splits > 1) && (!tail || partial != nullptr) && grid > 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap xmap, wmap;
  if (!encode_x(fn, &xmap, x, M, K) ||
      !(P::kFold ? encode_groups(fn, &wmap, packed, N, K, 1, gs)
                 : encode_rows(fn, &wmap, packed, N, K, 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  int stages = 0;
  size_t smem = 0;
  if (const int e = wg_ring<P, false>(stages, smem)) return e;
  const WgArgs args{nullptr, nullptr, nullptr, static_cast<const float*>(scales),
                    static_cast<const float*>(zps), static_cast<__nv_bfloat16*>(y), M, N, K, 1,
                    gs, 0, stages, full, splits, blocks, static_cast<float*>(partial)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int4_mma_kernel_wg<P, false><<<grid, kWgThreads, smem, st>>>(xmap, wmap, args);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !tail) return static_cast<int>(err);
  const int n0 = full / blocks * kWgSlice;
  const dim3 rgrid(M, (N - n0 + kMmaThreads - 1) / kMmaThreads);
  int4_linear_reduce_kernel<<<rgrid, kMmaThreads, 0, st>>>(
      static_cast<const float*>(partial), P::kFold ? nullptr : static_cast<const float*>(scales),
      static_cast<__nv_bfloat16*>(y), M, N, n0, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace f4b

// K2 on the warpgroup body: x [T, K] bf16; packed [E, N, K/2]; scales/zps
// [E, N]; used: int32 scratch of T; grid: persistent CTAs.
extern "C" int f4b_grouped_int4_matmul_wg_bf16(const void* x, const void* gids,
                                               const void* packed, const void* scales,
                                               const void* zps, void* used, void* y, int T,
                                               int N, int K, int E, int tile_m, int grid,
                                               void* stream) {
  return f4b::launch_int4_mma_wg<f4b::RowScale>(x, gids, packed, scales, zps, used, nullptr, y,
                                                T, N, K, E, 0, tile_m, grid, stream);
}

// K13 on the warpgroup body: packed [E, K/2/gs, N, gs] u8; scales/zps [E, N,
// K/gs]; xsum: f32 scratch of 2 * K/128 * T (the first pass's X).
extern "C" int f4b_grouped_int4_matmul_pg_wg_bf16(const void* x, const void* gids,
                                                  const void* packed, const void* scales,
                                                  const void* zps, void* used, void* xsum,
                                                  void* y, int T, int N, int K, int E, int gs,
                                                  int tile_m, int grid, void* stream) {
  return f4b::launch_int4_mma_wg<f4b::GroupFold>(x, gids, packed, scales, zps, used, xsum, y, T,
                                                 N, K, E, gs, tile_m, grid, stream);
}

// K1 on the warpgroup body: x [M, K] bf16; packed [N, K/2] u8; scales/zps
// [N]; full: items over all of K/2 (whole slices); partial: f32 scratch of
// splits * M * (N - full / ceil(M / 128) * 128) where slices are left for the
// ranges; grid: persistent CTAs.
extern "C" int f4b_int4_matmul_wg_bf16(const void* x, const void* packed, const void* scales,
                                       const void* zps, void* y, void* partial, int M, int N,
                                       int K, int full, int splits, int grid, void* stream) {
  return f4b::launch_int4_linear_wg<f4b::RowScale>(x, packed, scales, zps, y, partial, M, N, K, 0,
                                                   full, splits, grid, stream);
}

// K7 on the warpgroup body: x [M, K] bf16; packed [K/2/gs, N, gs] u8;
// scales/zps [N, K/gs]; full: items over all of K/2 (whole slices); partial:
// f32 scratch of splits * M * (N - full / ceil(M / 128) * 128) where slices
// are left for the ranges; grid: persistent CTAs.
extern "C" int f4b_int4_matmul_pg_wg_bf16(const void* x, const void* packed, const void* scales,
                                          const void* zps, void* y, void* partial, int M, int N,
                                          int K, int gs, int full, int splits, int grid,
                                          void* stream) {
  return f4b::launch_int4_linear_wg<f4b::GroupFold>(x, packed, scales, zps, y, partial, M, N, K,
                                                    gs, full, splits, grid, stream);
}
