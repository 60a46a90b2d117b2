// Tensor-core body of the bf16 w4a16 linears and grouped expert products:
// K1 (per row) and K6 (per group, planar), launched by int4_matmul.cu; K7
// (per group, planar_groups, gs % 64 == 0), launched by int4_matmul_pg.cu;
// and, with grouped addressing (an expert per block of rows), K2 and K9
// (K1's arithmetic; K9 at a launch that splits K across CTAs) and K12 (K6's),
// launched by grouped_matmul.cu, and K13 (K7's, gs % 64 == 0), launched by
// grouped_matmul_pg.cu. The f32 entry points and K7 and K13 at other group
// sizes stay on int4_rows.cuh / int4_rows_pg.cuh.
//
// What it computes (the TPU kernels' arithmetic, with the order of the f32
// sum changed):
//   K1: y[m, n] = s[n] * sum_k x[m, k] * (q[n, k] - zp[n])
//   K6: y[m, n] = sum_k x[m, k] * bf16(bf16(s[n, g(k)]) * (q[n, k] - zp[n, g(k)]))
//   K7: y[m, n] = sum over chunks c of 64 packed bytes, in order, of
//         s_lo * P_lo + c_lo * X_lo + s_hi * P_hi + c_hi * X_hi
//       with P_lo = sum x_lo * q_lo and P_hi = sum x_hi * (q_hi - 8) the raw
//       codes' dot over the chunk's 64 columns of each half, X the sums of x
//       over them, c_lo = -s_lo * zp_lo, c_hi = s_hi * (8 - zp_hi) (the TPU
//       kernel's batched-partials fold, fused4bit_tpu/ops/int4_matmul.py:
//       _int4_group_bp_kernel: its a_hi * P_hi is (s_hi / 16) * 16 P_hi, the
//       same product; it folds per group, here per chunk of its group).
//   K2, K9, K12, K13: K1's, K1's, K6's and K7's sums over the weights of
//       expert e = gids[m / tile_m], the expert of row m's tile (the TPU
//       kernels _grouped_kernel, _grouped_ksplit_kernel, _grouped_pg_kernel
//       and _grouped_pg_bp_kernel, fused4bit_tpu/ops/grouped_matmul.py; the
//       last folds per group).
// with q the 4-bit codes of the planar bytes (byte c of row n: column c in
// the low nibble, column K/2 + c XOR 8 in the high nibble) and integer zero
// points in [0, 15], as the quantizer gives them. (q - zp) lies in [-15, 15]
// and is exact in bf16, and for K6 the bf16 product of two bf16 values is the
// plain version's planar_pg_weight bit for bit (the f32 product is exact and
// both round once to nearest even), so mma.sync with bf16 operands and f32
// sums is the TPU kernels' own bf16 dot with f32 accumulation. K7's codes
// q_lo in [0, 15] and q_hi - 8 in [-8, 7] are exact in bf16 too: the zero
// point and the scale never touch the weights, as in the TPU kernel.
//
// What bounds it on the H100: at decode (M <= 16) the product reads K/2
// bytes per output row and does 2*M*K operations per row, about 32
// operations per byte against the ~295 where the tensor cores become the
// limit, so it is bound by the bytes it streams from HBM (3.35 TB/s). What
// the design does about it:
//
// * Operands swapped: the dequantized weights are mma operand A (16 output
//   rows x 16 k), x is operand B (16 k x 8 rows of x), so M = 8 is one n8
//   tile and each A fragment feeds every n8 tile of the x rows staged.
// * Dequantization in registers with no int-to-float conversion: the bf16
//   with bits 0x4300 | v is 128 + v, so one byte permute and one lop3 give
//   two bf16 values 128 + lo and, with the constant 0x4308 ^ nibble, 128 +
//   (hi XOR 8) = 128 + q; __hsub2 of (128 + zp) leaves q - zp exactly, and
//   for K6 __hmul2 by bf16(s) rounds the product once. K1 applies its scale
//   to the f32 sum in the epilogue, as the TPU kernel does. K7 subtracts 128
//   (low) or 136 (high) and nothing else.
// * The JAX bytes stay as they are; the order of k inside each 16-wide k step
//   is permuted instead. A chunk is 64 packed bytes of a row; lane (g, t) of
//   a warp (g = lane / 4, t = lane % 4) loads bytes 16t .. 16t + 15 of the
//   chunk of rows g and g + 8 of its 16-row tile with one 16-byte load each
//   (K7: of the planar_groups run [g(c), n, 0 .. gs), the chunk's group).
//   K1/K6: k step s (0..7) of the chunk gives mma positions 2t, 2t + 1 the
//   low nibbles of bytes 16t + 2s, 16t + 2s + 1, and positions 2t + 8, 2t + 9
//   their high nibbles (columns K/2 + the same bytes); operand B reads x at
//   the same columns, which are one 32-bit word of the staged low half and
//   one of the high half. K7 keeps the halves apart, each with its own scale:
//   low step s (0..3) gives positions 2t, 2t + 1 the low nibbles of bytes
//   16t + 4s, +1 and positions 2t + 8, 2t + 9 those of bytes 16t + 4s + 2, +3,
//   and operand B reads the same 4 columns of the staged low half as one
//   64-bit word; high step s the same with the high nibbles and the high
//   half. Each half's 4 steps sum into f32 fragments P that are folded into
//   the accumulator at the chunk's end with the group's (s, c) and the sums X
//   of the staged x (one f32 per row, chunk and half, summed per row in a
//   fixed order after the stage is staged, so no row reads another's).
// * Filling the card: a warp owns a 16-row tile and a slice of `ws` k steps;
//   a CTA of 8 warps is `kw` warps along K times 8 / kw row tiles, and grid z
//   splits K into `splits` ranges of kw * ws steps. A warp walks its slice in
//   stages of up to 32 steps; in stage i the CTA's kw warps take kw
//   consecutive runs of the stage's steps, warp 0 first. The launch rule
//   (ops._mma._mma_launch; K7: _fold_mma_launch, whole chunks per
//   warp; K2, K12, K13: _grouped_mma_launch; K9:
//   _ksplit_mma_launch, at least two CTAs along K) picks (ws, kw, splits)
//   from (N, K, SM count) only, so every row's sum runs in the same order
//   whatever rows sit beside it: a row's output does not depend on M up to
//   64 (the self-draft speculative verify at M = 40 must reproduce the M = 8
//   decode bit for bit), nor, for K2, K9, K12 and K13, on the T, the tile_m
//   (up to 64; K9 at every tile_m) or the routing of the dispatch. Partial
//   sums meet in a fixed order:
//   through shared memory inside a CTA (warps kw = 0, 1, ...), then, with
//   splits > 1, as f32 partials [splits, M, N] that a second kernel adds in
//   order z = 0, 1, ... No float atomics.
// * Every weight load of a warp's stage (up to 4 chunks: 8 x 16 bytes per
//   lane) is issued before the x staging completes and before the MMAs that
//   consume them. x is staged once per CTA with cp.async (16 bytes), a warp
//   per staged row and half, rows padded by 16 bytes so the fragment loads
//   are free of bank conflicts.
// * Rows of x: a CTA takes 16 at M <= 64 (each A fragment feeds 1 or 2
//   MMAs; above 16 rows the weights stream once per 16 rows, the repeats
//   from L2). Above 64 rows (prefill) it takes 64, so each A fragment feeds
//   8 MMAs, and its warps (one per row tile) walk their range of K in stages
//   of 32 k steps; there K is split across CTAs only until every SM has one
//   (ops._mma._mma_tall_launch; K2, K12 and K13 at tile_m 128; K9
//   keeps its own split there).
// * Grouped addressing (K2, K9, K12, K13): a CTA's block of rows lies in one tile
//   (tile_m % 16 == 0, or % 64 with the tall tile) and reads its expert from
//   gids, offsetting the weights, scales and zero points (size_t: a stack of
//   experts passes 2^31 bytes). A first pass (rows_used_kernel, a CTA per
//   row) flags the rows that hold a nonzero; a block computes only up to its
//   last flagged row (the dispatch's zero padding sits at the end of each
//   expert's rows), stages and multiplies only the n8 tiles of x those rows
//   fill (one MMA per A fragment at 8 rows or fewer), writes the rows after
//   it as exactly 0, and a block of padding alone exits before any weight
//   load. (Each CTA reading its block's rows of x itself before its weight
//   loads, every CTA along N repeating the read, measured 7-12 % slower on
//   the H100 than the first pass; PERF.md.)
//
// Masking: output rows past N read zero bytes and are not stored; x rows past
// M and columns past K/2 (K % 128 != 0) are staged as zero.
#pragma once

#include "common.cuh"

namespace f4b {
namespace {

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kChunkBytes = 64;  // packed bytes of a row per chunk: 4 lanes x 16 B
constexpr int kStepsPerChunk = 8;
constexpr int kStageSteps = 32;  // k steps a warp holds in registers at once (4 chunks)
constexpr int kStageChunks = kStageSteps / kStepsPerChunk;

// What a weight byte becomes on the way into the tensor cores: the body's
// dequantization policy.
//   RowScale     (K1): q - zp[n] in registers, s[n] times the f32 sum;
//   GroupDequant (K6): bf16(bf16(s[n, g]) * (q - zp[n, g])) in registers;
//   GroupFold    (K7): the raw codes, planar_groups bytes, and the group's
//                      scale and zero point folded into the f32 sums per chunk.
struct RowScale {
  static constexpr bool kGroupScales = false, kFold = false;
};
struct GroupDequant {
  static constexpr bool kGroupScales = true, kFold = false;
};
struct GroupFold {
  static constexpr bool kGroupScales = true, kFold = true;
};

struct MmaArgs {
  const __nv_bfloat16* x;   // [M, K], 16-byte aligned
  const uint8_t* packed;    // [N, K/2] planar (K1, K6) or [K/2/gs, N, gs] planar_groups (K7); a stack of E (K2, K12, K13)
  const float* scales;      // [N] (K1) or [N, K/gs] (K6, K7); a stack of E (K2, K12, K13)
  const float* zps;         // the same shape, integers in [0, 15]
  __nv_bfloat16* y;         // [M, N]
  float* partial;           // [splits, M, N] f32 scratch when splits > 1
  const int32_t* gids;      // grouped: [M / tile_m] the expert of each tile of tile_m rows
  int32_t* used;            // grouped: [M] int32 scratch for the first pass's row flags
  int M, N, K, gs;
  int ws, kw, splits;       // k steps per warp, warps along K per CTA, CTAs along K
  int tile_m;               // grouped: rows per tile, each tile one expert's
};

inline MmaArgs mma_args(const void* x, const void* packed, const void* scales, const void* zps,
                        void* y, void* partial, int M, int N, int K, int gs, int ws, int kw,
                        int splits, const void* gids = nullptr, void* used = nullptr,
                        int tile_m = 0) {
  return MmaArgs{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
                 static_cast<const float*>(scales), static_cast<const float*>(zps),
                 static_cast<__nv_bfloat16*>(y), static_cast<float*>(partial),
                 static_cast<const int32_t*>(gids), static_cast<int32_t*>(used),
                 M, N, K, gs, ws, kw, splits, tile_m};
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// Two packed bytes of `w` (bytes 0, 1 with sel 0x4140; bytes 2, 3 with
// 0x4342) as bf16 pairs: lo = (128 + low nibble) and hi = (128 + (high
// nibble XOR 8)), the first byte's value in the low half of each pair.
__device__ __forceinline__ void nibbles_bf16x2(uint32_t w, uint32_t sel, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t r = __byte_perm(w, 0u, sel);  // byte 0 -> bits 0-7, byte 1 -> bits 16-23
  lo = (r & 0x000F000Fu) | 0x43004300u;
  hi = ((r >> 4) & 0x000F000Fu) ^ 0x43084308u;
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// (128 + zp) as a bf16 pair: exact for integer zp in [0, 15].
__device__ __forceinline__ uint32_t zp_pair(float zp) {
  return bf2_bits(__float2bfloat162_rn(128.f + zp));
}

// The packed bytes of row n at byte `byte` of its K/2 (a lane's 16-byte run):
// planar rows, or (GroupFold) the run of group byte / gs in planar_groups.
template <class P>
__device__ __forceinline__ const uint4* weight_run(const MmaArgs& p, int n, int byte) {
  if constexpr (P::kFold) {
    const int g = byte / p.gs;
    return reinterpret_cast<const uint4*>(
        p.packed + (static_cast<size_t>(g) * p.N + n) * p.gs + (byte - g * p.gs));
  } else {
    return reinterpret_cast<const uint4*>(p.packed + static_cast<size_t>(n) * (p.K / 2) + byte);
  }
}

// The grouped launches' first pass: used[m] = 1 if row m of x holds a nonzero
// bit, else 0. A CTA per row.
__global__ void __launch_bounds__(kMmaThreads) rows_used_kernel(const __nv_bfloat16* __restrict__ x,
                                                                int K, int32_t* __restrict__ used) {
  const uint4* row = reinterpret_cast<const uint4*>(x + static_cast<size_t>(blockIdx.x) * K);
  uint32_t bits = 0u;
  for (int i = threadIdx.x; i < K / 8; i += kMmaThreads) {
    const uint4 u = __ldg(row + i);
    bits |= u.x | u.y | u.z | u.w;
  }
  const int any = __syncthreads_or(bits != 0u);
  if (threadIdx.x == 0) used[blockIdx.x] = any != 0;
}

// 1 + the last of the `rows` rows from m0 that the first pass flagged (0: all
// zero padding). CTA-uniform; every thread of the CTA must call it.
__device__ __forceinline__ int mma_rows_in_use(const int32_t* used, int m0, int rows) {
  __shared__ int last;
  if (threadIdx.x == 0) last = 0;
  __syncthreads();
  if (threadIdx.x < rows && used[m0 + threadIdx.x]) atomicMax(&last, threadIdx.x + 1);
  __syncthreads();
  return last;
}

// NT n8 tiles of x rows per CTA (16 or 64 rows). One CTA: 8 warps, warp w
// on row tile blockIdx.x * (8 / kw) + w / kw and K slice w % kw of the CTA's
// range blockIdx.z; x rows blockIdx.y * 8 * NT onward. G: grouped addressing
// (K2, K12, K13), the block's expert from gids and only its rows in use.
template <class P, int NT, bool G>
__global__ void __launch_bounds__(kMmaThreads, NT <= 2 ? 2 : 1) int4_mma_kernel(const MmaArgs args) {
  constexpr int MT = NT * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);

  MmaArgs p = args;
  const int kh = p.K / 2;
  const int chunks = (kh + kChunkBytes - 1) / kChunkBytes;
  const int steps = chunks * kStepsPerChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kwi = warp % p.kw;
  const int n0 = (blockIdx.x * (kMmaWarps / p.kw) + warp / p.kw) * 16;
  const int na = n0 + g, nb = n0 + g + 8;  // the lane's two weight rows
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, p.M - m0);
  const int ng = P::kGroupScales ? p.K / p.gs : 1;
  // x rows the CTA computes: all of them, or (G) up to the block's last row
  // in use; the rows after it are zero padding and give exactly 0.
  int mcount = mrows;
  if constexpr (G) {
    mcount = mma_rows_in_use(p.used, m0, mrows);
    if (mcount == 0) {  // all zero padding: no weights, the outputs are 0
      if (p.splits == 1) {
        const int nb0 = blockIdx.x * (kMmaWarps / p.kw) * 16;
        const int ncols = min((kMmaWarps / p.kw) * 16, p.N - nb0);
        for (int i = threadIdx.x; i < mrows * ncols; i += kMmaThreads) {
          const int r = i / ncols;
          p.y[static_cast<size_t>(m0 + r) * p.N + nb0 + (i - r * ncols)] = __float2bfloat16(0.f);
        }
      }
      return;
    }
    const size_t e = p.gids[m0 / p.tile_m];  // the block's expert
    p.packed += e * p.N * kh;
    p.scales += e * p.N * ng;
    p.zps += e * p.N * ng;
  }
  const int stage_cap = p.kw * min(kStageSteps, p.ws) / kStepsPerChunk;  // chunks per stage
  const int rs = stage_cap * 2 * kChunkBytes + 8;  // staged row: [lo | hi | 8 pad] bf16
  const int cs = blockIdx.z * p.kw * p.ws;         // the CTA's first k step
  const int ce = min(steps, cs + p.kw * p.ws);
  const int xrows = min(MT, (mcount + 7) & ~7);    // staged rows: whole n8 tiles
  // GroupFold: X, the sums of the staged x per [chunk of the stage][half][row]
  float* xsum = reinterpret_cast<float*>(smem + static_cast<size_t>(MT) * rs * 2);

  uint32_t zrow[2] = {0u, 0u};  // K1: (128 + zp) of rows na, nb
  if (!P::kGroupScales) {
    zrow[0] = zp_pair(na < p.N ? __ldg(p.zps + na) : 0.f);
    zrow[1] = zp_pair(nb < p.N ? __ldg(p.zps + nb) : 0.f);
  }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int o = 0; o < p.ws; o += kStageSteps) {
    // Stage o of a warp's slice (its k steps o .. o + 32): the CTA's steps
    // from s0, the chunks the CTA stages for them, and the warp's steps
    // [wa, wb) among them.
    const int len = min(kStageSteps, p.ws - o);
    const int s0 = cs + o * p.kw;
    const int c_first = s0 / kStepsPerChunk;
    const int c_count = min(p.kw * len / kStepsPerChunk, chunks - c_first);  // may be <= 0
    const int wa = min(s0 + kwi * len, ce);
    const int wb = min(wa + len, ce);
    const int ca = wa / kStepsPerChunk;

    // The warp's weight bytes for the stage, all loads in flight at once.
    uint4 wr[kStageChunks][2];
#pragma unroll
    for (int i = 0; i < kStageChunks; ++i) {
      const int c = ca + i;
      const int byte = c * kChunkBytes + 16 * t;
      const bool in = c * kStepsPerChunk < wb && byte < kh;
      wr[i][0] = wr[i][1] = make_uint4(0u, 0u, 0u, 0u);
      if (in && na < p.N) wr[i][0] = __ldg(weight_run<P>(p, na, byte));
      if (in && nb < p.N) wr[i][1] = __ldg(weight_run<P>(p, nb, byte));
    }

    // Stage x rows [m0, m0 + xrows) at the stage's chunks, low and high half:
    // a warp per (row, half), its lanes over the run's 16-byte vectors (8 per
    // chunk), no division in the index arithmetic.
    __syncthreads();  // the previous stage's x is consumed
    const int run = max(c_count, 0) * (kChunkBytes / 8);  // 16-byte vectors per row half
    for (int rh = warp; rh < 2 * xrows; rh += kMmaWarps) {
      const int r = rh >> 1, h = rh & 1;
      const __nv_bfloat16* xrow = p.x + static_cast<size_t>(m0 + r) * p.K + h * kh;
      __nv_bfloat16* srow = xs + r * rs + h * stage_cap * kChunkBytes;
      for (int u = lane; u < run; u += 32) {
        const int col = c_first * kChunkBytes + u * 8;  // column within the half
        const bool valid = r < mrows && col < kh;
        cp_async16(srow + u * 8, valid ? xrow + col : p.x, valid);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if constexpr (P::kFold) {
      // X of each staged (chunk, half, row): the row's 64 values, 8 vectors
      // of 8 each summed as a tree, the 8 vector sums added in order.
      for (int e = threadIdx.x; e < max(c_count, 0) * 2 * xrows; e += kMmaThreads) {
        const int r = e % xrows, ch = e / xrows;  // ch = chunk * 2 + half
        const __nv_bfloat16* v = xs + r * rs + (ch & 1) * stage_cap * kChunkBytes +
                                 (ch >> 1) * kChunkBytes;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kChunkBytes / 8; ++u) {
          const uint4 w = *reinterpret_cast<const uint4*>(v + 8 * u);
          const float2 f0 = __bfloat1622float2(bits_bf2(w.x));
          const float2 f1 = __bfloat1622float2(bits_bf2(w.y));
          const float2 f2 = __bfloat1622float2(bits_bf2(w.z));
          const float2 f3 = __bfloat1622float2(bits_bf2(w.w));
          sum += ((f0.x + f0.y) + (f1.x + f1.y)) + ((f2.x + f2.y) + (f3.x + f3.y));
        }
        xsum[ch * MT + r] = sum;
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kStageChunks; ++i) {
      const int c = ca + i;
      if (c * kStepsPerChunk >= wb) break;  // warp-uniform
      // B fragments come from the lane's 16 staged values of each half
      const int sc_off = (c - c_first) * kChunkBytes + 16 * t;
      const uint32_t w_a[4] = {wr[i][0].x, wr[i][0].y, wr[i][0].z, wr[i][0].w};
      const uint32_t w_b[4] = {wr[i][1].x, wr[i][1].y, wr[i][1].z, wr[i][1].w};
      if constexpr (P::kFold) {
        // The chunk's group (gs % 64 == 0: one group per chunk) and its fold
        // constants for rows na, nb: [s_lo, c_lo, s_hi, c_hi] each.
        const int gl = min(c * kChunkBytes, kh - 1) / p.gs;
        float f[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = r == 0 ? na : nb;
          const bool in = n < p.N;
          const float* s = p.scales + static_cast<size_t>(n) * ng;
          const float* z = p.zps + static_cast<size_t>(n) * ng;
          const float s_lo = in ? __ldg(s + gl) : 0.f, s_hi = in ? __ldg(s + ng / 2 + gl) : 0.f;
          const float z_lo = in ? __ldg(z + gl) : 0.f, z_hi = in ? __ldg(z + ng / 2 + gl) : 0.f;
          f[r][0] = s_lo;
          f[r][1] = -s_lo * z_lo;
          f[r][2] = s_hi;
          f[r][3] = s_hi * (8.f - z_hi);
        }
        const float* xc = xsum + (c - c_first) * 2 * MT;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // A fragments of the half's 4 k steps: raw codes, low half q in
          // [0, 15], high half q - 8 in [-8, 7]; registers [a 0-1, b 0-1, a 2-3, b 2-3]
          const uint32_t off = h ? 0x43084308u : 0x43004300u;
          uint32_t a[4][4];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            uint32_t v[4], hv[4];
            nibbles_bf16x2(w_a[s], 0x4140u, v[0], hv[0]);
            nibbles_bf16x2(w_b[s], 0x4140u, v[1], hv[1]);
            nibbles_bf16x2(w_a[s], 0x4342u, v[2], hv[2]);
            nibbles_bf16x2(w_b[s], 0x4342u, v[3], hv[3]);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              a[s][q] = bf2_bits(__hsub2(bits_bf2(h ? hv[q] : v[q]), bits_bf2(off)));
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (8 * j < mcount) {  // CTA-uniform
              const __nv_bfloat16* row = xs + (8 * j + g) * rs + h * stage_cap * kChunkBytes +
                                         sc_off;
              const uint4 x0 = *reinterpret_cast<const uint4*>(row);
              const uint4 x1 = *reinterpret_cast<const uint4*>(row + 8);
              const uint32_t b[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
              float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int s = 0; s < 4; ++s) mma_bf16_16816(d, a[s], b[2 * s], b[2 * s + 1]);
              // d: (row na, x rows 8j + 2t, +1), (row nb, the same)
              const float2 xx = *reinterpret_cast<const float2*>(xc + h * MT + 8 * j + 2 * t);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float* fr = f[e >> 1];
                float v = fmaf(fr[2 * h], d[e], acc[j][e]);
                acc[j][e] = fmaf(fr[2 * h + 1], (e & 1) ? xx.y : xx.x, v);
              }
            }
          }
        }
      } else {
        const int s_lo = max(wa - c * kStepsPerChunk, 0);
        const int s_hi = min(wb - c * kStepsPerChunk, kStepsPerChunk);
        // per-half zero points (and, K6, scales) of rows na, nb: [lo a, lo b, hi a, hi b]
        uint32_t z[4] = {zrow[0], zrow[1], zrow[0], zrow[1]};
        __nv_bfloat162 sc[4];
        if constexpr (P::kGroupScales) {
          const int byte = c * kChunkBytes + 16 * t;
          const int gl = min(byte, kh - 1) / p.gs;  // the run's group; one group per run
          const bool ia = na < p.N && byte < kh, ib = nb < p.N && byte < kh;
          const float* sa = p.scales + static_cast<size_t>(na) * ng;
          const float* sb = p.scales + static_cast<size_t>(nb) * ng;
          const float* za = p.zps + static_cast<size_t>(na) * ng;
          const float* zb = p.zps + static_cast<size_t>(nb) * ng;
          const float f[8] = {ia ? __ldg(sa + gl) : 0.f, ib ? __ldg(sb + gl) : 0.f,
                              ia ? __ldg(sa + ng / 2 + gl) : 0.f, ib ? __ldg(sb + ng / 2 + gl) : 0.f,
                              ia ? __ldg(za + gl) : 0.f, ib ? __ldg(zb + gl) : 0.f,
                              ia ? __ldg(za + ng / 2 + gl) : 0.f, ib ? __ldg(zb + ng / 2 + gl) : 0.f};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            sc[q] = __float2bfloat162_rn(f[q]);
            z[q] = zp_pair(f[4 + q]);
          }
        }
        // A fragments of the chunk's 8 k steps: mma registers a0..a3 = [lo a, lo b, hi a, hi b]
        uint32_t a[kStepsPerChunk][4];
#pragma unroll
        for (int s = 0; s < kStepsPerChunk; ++s) {
          const uint32_t sel = (s & 1) ? 0x4342u : 0x4140u;
          uint32_t v[4];
          nibbles_bf16x2(w_a[s >> 1], sel, v[0], v[2]);
          nibbles_bf16x2(w_b[s >> 1], sel, v[1], v[3]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            __nv_bfloat162 d = __hsub2(bits_bf2(v[q]), bits_bf2(z[q]));
            if constexpr (P::kGroupScales) d = __hmul2(d, sc[q]);
            a[s][q] = bf2_bits(d);
          }
        }
        // B fragments: word s of the lane's 16 staged values of each half is
        // k step s's b0 (low half) and b1 (high half).
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (8 * j < mcount) {  // CTA-uniform
            const __nv_bfloat16* row = xs + (8 * j + g) * rs + sc_off;
            const uint4 l0 = *reinterpret_cast<const uint4*>(row);
            const uint4 l1 = *reinterpret_cast<const uint4*>(row + 8);
            const uint4 h0 = *reinterpret_cast<const uint4*>(row + stage_cap * kChunkBytes);
            const uint4 h1 = *reinterpret_cast<const uint4*>(row + stage_cap * kChunkBytes + 8);
            const uint32_t bl[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
            const uint32_t bh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
            for (int s = 0; s < kStepsPerChunk; ++s) {
              if (s >= s_lo && s < s_hi) mma_bf16_16816(acc[j], a[s], bl[s], bh[s]);
            }
          }
        }
      }
    }
  }

  // Epilogue. acc[j]: (row g, x rows 8j + 2t, +1), (row g + 8, the same).
  // Rows past the rows in use are 0 (with splits > 1, the second pass's).
  auto store = [&](int m, int n, float v) {
    if (m >= p.M || n >= p.N) return;
    const size_t at = static_cast<size_t>(m) * p.N + n;
    const bool live = m < m0 + mcount;
    if (p.splits > 1) {
      if (live) p.partial[static_cast<size_t>(blockIdx.z) * p.M * p.N + at] = v;
    } else {
      p.y[at] = __float2bfloat16(!live ? 0.f : P::kGroupScales ? v : __ldg(p.scales + n) * v);
    }
  };
  if (p.kw == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int m = m0 + 8 * j + 2 * t;
      store(m, na, acc[j][0]);
      store(m + 1, na, acc[j][1]);
      store(m, nb, acc[j][2]);
      store(m + 1, nb, acc[j][3]);
    }
    return;
  }
  // Add the kw warps of each row tile in order kwi = 0, 1, ... through
  // shared memory: red[warp][16 rows][MT x rows].
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();  // x is consumed
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float* r = red + (warp * 16) * MT + 8 * j + 2 * t;
    r[g * MT] = acc[j][0];
    r[g * MT + 1] = acc[j][1];
    r[(g + 8) * MT] = acc[j][2];
    r[(g + 8) * MT + 1] = acc[j][3];
  }
  __syncthreads();
  const int tiles = kMmaWarps / p.kw;
  for (int e = threadIdx.x; e < tiles * 16 * MT; e += kMmaThreads) {
    const int col = e % MT, row = (e / MT) % 16, tile = e / (16 * MT);
    float v = red[((tile * p.kw) * 16 + row) * MT + col];
    for (int k = 1; k < p.kw; ++k) v += red[((tile * p.kw + k) * 16 + row) * MT + col];
    store(m0 + col, (blockIdx.x * tiles + tile) * 16 + row, v);
  }
}

// The splits' f32 partials added in order z = 0, 1, ..., then (K1, K2, K9)
// the scale: a CTA per row of y and 256 of its columns, a thread per
// element. Grouped (gids): the row's expert's scale, and 0 for a row past
// its block's rows in use (blocks of mt <= kMmaThreads rows), for which no
// partial was written and none is read; a row is in use if a row from it to
// its block's end is flagged, which the CTA reads once (a flag per thread).
template <class P>
__global__ void __launch_bounds__(kMmaThreads) int4_mma_reduce_kernel(const MmaArgs p, int mt) {
  const int m = blockIdx.x;
  const int n = blockIdx.y * kMmaThreads + threadIdx.x;
  const size_t at = static_cast<size_t>(m) * p.N + n;
  const float* s = p.scales;
  if (p.gids != nullptr) {
    const int r = m + static_cast<int>(threadIdx.x);
    const bool flagged = r < min(m - m % mt + mt, p.M) && p.used[r] != 0;
    if (!__syncthreads_or(flagged)) {  // CTA-uniform
      if (n < p.N) p.y[at] = __float2bfloat16(0.f);
      return;
    }
    s += static_cast<size_t>(p.gids[m / p.tile_m]) * p.N;
  }
  if (n >= p.N) return;
  const size_t mn = static_cast<size_t>(p.M) * p.N;
  float v = p.partial[at];
  for (int z = 1; z < p.splits; ++z) v += p.partial[z * mn + at];
  p.y[at] = __float2bfloat16(P::kGroupScales ? v : s[n] * v);
}

template <class P, int NT, bool G>
int launch_mma_tile(const MmaArgs& p, dim3 grid, size_t smem, cudaStream_t st) {
  // The dynamic shared memory each device already allows the kernel (48 KB
  // by default); raised once per device to the largest launch so far.
  constexpr int kDevices = 64;
  static size_t allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024 && (dev >= kDevices || smem > allowed[dev])) {
    err = cudaFuncSetAttribute(int4_mma_kernel<P, NT, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) allowed[dev] = smem;
  }
  int4_mma_kernel<P, NT, G><<<grid, kMmaThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream` with `mt` rows of x per CTA (16, or 64 above 64 rows). Requires
// K % 32 == 0, ws >= 1, kw in {1, 2, 4, 8}, kw * min(32, ws) a multiple of 8
// (a CTA's stage is whole chunks), ws <= 32 or a multiple of 8, and
// partial != nullptr when splits > 1. GroupFold also requires whole chunks
// per warp (ws % 8 == 0) and gs % 64 == 0 dividing K/2. G (grouped: K2, K12, K13)
// requires gids, tile_m % mt == 0 and `used` (M ints of scratch for the first
// pass, which runs before the main kernel).
template <class P, bool G = false>
int launch_int4_mma(const MmaArgs& p, int mt, void* stream) {
  const bool fold_ok = !P::kFold || (p.ws % kStepsPerChunk == 0 && p.gs > 0 &&
                                     p.gs % kChunkBytes == 0 && (p.K / 2) % p.gs == 0);
  const bool grouped_ok = !G || (p.gids != nullptr && p.used != nullptr && p.tile_m > 0 &&
                                 p.tile_m % mt == 0);
  const bool ok = p.ws >= 1 && (p.kw == 1 || p.kw == 2 || p.kw == 4 || p.kw == 8) &&
                  (p.kw * min(kStageSteps, p.ws)) % kStepsPerChunk == 0 &&
                  (p.ws <= kStageSteps || p.ws % kStepsPerChunk == 0) && p.splits >= 1 &&
                  (p.splits == 1 || p.partial != nullptr) && (mt == 16 || mt == 64) &&
                  p.K % 32 == 0 && fold_ok && grouped_ok;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (p.M == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G) {
    rows_used_kernel<<<p.M, kMmaThreads, 0, st>>>(p.x, p.K, p.used);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (p.N + 15) / 16;
  const int per_cta = kMmaWarps / p.kw;
  const int stage_cap = p.kw * min(kStageSteps, p.ws) / kStepsPerChunk;
  size_t xs_bytes = static_cast<size_t>(mt) * (stage_cap * 2 * kChunkBytes + 8) * 2;
  if (P::kFold) xs_bytes += static_cast<size_t>(stage_cap) * 2 * mt * 4;  // X sums
  const size_t red_bytes = p.kw > 1 ? static_cast<size_t>(kMmaWarps) * 16 * mt * 4 : 0;
  const dim3 grid((tiles + per_cta - 1) / per_cta, (p.M + mt - 1) / mt, p.splits);
  const size_t smem = xs_bytes > red_bytes ? xs_bytes : red_bytes;
  const int err = mt == 16 ? launch_mma_tile<P, 2, G>(p, grid, smem, st)
                           : launch_mma_tile<P, 8, G>(p, grid, smem, st);
  if (err != 0 || p.splits == 1) return err;
  const dim3 rgrid(p.M, (p.N + kMmaThreads - 1) / kMmaThreads);
  int4_mma_reduce_kernel<P><<<rgrid, kMmaThreads, 0, st>>>(p, mt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace f4b
