// Int8 tensor-core body of the w4a8 products: the grouped expert products K10
// and K11 (per-row scales, planar bytes; grouped_matmul_a8.cu) and K14
// (per-group scales, planar_groups bytes, gs % 32 == 0; grouped_matmul_pg.cu),
// and the linears K4 and K5 (per row) and K8 (per group, gs % 32 == 0), which
// run their grouped twin's entry point as one expert with no tile map (gids
// NULL: every row reads expert 0, and M need not be a multiple of 16). K8 and
// K14 at other group sizes stay on int4_rows_pg.cuh.
//
// What it computes. The activations are quantized per row, symmetric int8,
// by a first pass (a8_prepass_kernel) with the host quantizer's arithmetic,
// operation for operation:
//   sx[m] = max(max_c |x[m, c]|, 1e-8) / 127   (K10, K4: IEEE division)
//         = max(...) * f32(1/127)             (K5, K11, K14, K8: XLA's folded
//                                              reciprocal)
//   xq[m, c] = clamp(rint(x[m, c] / sx[m]), -127, 127)
// The same pass (a CTA per row) writes each row's exact int32 sums of xq
// over every group of gsum columns of the low half, then of the high half
// (K10: gsum = K/2, two sums; K14: gsum = gs), and whether the row holds a
// nonzero (the dispatch's zero padding rows do not).
// Then, with q the 4-bit codes of the JAX bytes (byte c of row n: column c in
// the low nibble, column K/2 + c XOR 8 in the high nibble), e the expert of
// the row's tile:
//   K10, K11, K4, K5: acc = sum_c xq[m, c] * q[e, n, c]         (int32, exact)
//        y   = (s[e, n] * sx[m]) * (f32(acc) - zp[e, n] * f32(xsum[m]))
//   K14: per group g of gs columns, the exact int32 products
//        P_lo = xq_lo . q_lo and P_hi = xq_hi . 16 (q_hi - 8), folded in
//        group order into an f32 sum, one rounding per operation:
//          acc += s_lo * P_lo;  acc += c_lo * X_lo;
//          acc += (s_hi / 16) * P_hi;  acc += c_hi * X_hi;
//        with c_lo = -s_lo * zp_lo, c_hi = s_hi * (8 - zp_hi), X the group's
//        sums of xq; y = acc * sx[m] (the TPU kernels' per-group terms,
//        fused4bit_tpu/ops/grouped_matmul.py:_grouped_pg_bp_a8_kernel and,
//        for K8, int4_matmul.py:_int4_group_bp_a8_kernel, which sum them in
//        another order).
// The epilogues use __fmul_rn / __fadd_rn / __fsub_rn so that nvcc cannot
// contract them into FMAs. K10, K11, K4 and K5 equal
// ops._int8._a8_product bit for bit for any split of K (their integers
// are exact), so K4's and K5's launch rule may read M; K14 and K8 equal
// ops._int8._pg_a8_fold_product at
// the same launch shape.
//
// What bounds it on the H100: at decode (T = 8 tokens, top-2) a block of 16
// rows holds a token or a few, so the product streams each selected expert's
// packed weights (N * K/2 bytes) for a handful of rows: about 32 int8
// operations per byte against the ~590 where the int8 tensor cores become the
// limit, so it is bound by the HBM bytes. What the design does about it:
//
// * mma.sync m16n8k32 s8 x s8 -> s32, operands swapped as in int4_mma.cuh:
//   16 weight rows are operand A, 8 rows of xq operand B, so a decode token
//   tile is one n8 tile. The codes need no conversion: the low nibbles of 4
//   packed bytes are one word of 4 codes after & 0x0F0F0F0F; K10's high
//   codes are ((w >> 4) & 0x0F0F0F0F) ^ 0x08080808, K14's high operand is
//   w & 0xF0F0F0F0, which as s8 is 16 (q_hi - 8), the TPU kernel's own.
// * The JAX bytes stay as they are. Lane (g, t) (g = lane / 4, t = lane % 4)
//   loads R bytes (R = 16; K14 at gs % 64 != 0: 8) at byte R*t of a chunk of
//   4R bytes of rows g and g + 8 of its 16-row tile, and the same columns of
//   the low and the high half of its row of xq, so the k order inside an MMA
//   is a permutation both operands share: K10 step s (0..3) puts the low
//   codes of word s in k 4t..4t+3 and the high codes of word s in k
//   16+4t..16+4t+3, operand B the same word of the low and the high half of
//   xq; K14 keeps the halves apart
//   (each has its own scale): a low step takes words 2s, 2s+1 of the low
//   codes and of the low half of xq, a high step the same of the high ones.
//   A chunk never straddles two groups (4R divides gs).
// * Bytes in flight without registers: each warp streams its slice of K
//   through a ring of kI8Ring chunks in shared memory, kI8Ring - 1 chunks in
//   flight while one is used. Each lane copies in (cp.async) exactly the
//   bytes it reads back, its weight runs and its columns of xq, so the ring
//   needs no barrier. Weight copies bypass L1 and ask L2 for 256-byte lines,
//   which prefetches the next chunks of the row; xq stays in L1, where the
//   CTA's warps share it. K14's scales, zero points and row sums are loaded
//   a group ahead of the fold that uses them. (A register double buffer and
//   rings of 4 and 6 measured slower on the H100; PERF.md.)
// * Filling the card: a CTA of 8 warps takes 16 rows of xq and 8 / kw row
//   tiles of 16 output rows, kw warps along K each on a slice of ws chunks;
//   grid z splits K into `splits` ranges of kw * ws chunks (K14, K8: whole
//   groups). The launch rules (ops._int8._a8_mma_launch; K8:
//   _linear_a8_launch, more warps along K and no split) read (N, K, gs, SM
//   count) only, never M, T, tile_m or the routing, so a row's output
//   bits do not depend on the tile, the T or the M it sits in (K4's and
//   K5's rule, _row_a8_launch, reads M: their sums are exact). Partial sums meet in
//   a fixed order: through shared memory in the CTA (warps kwi = 0, 1, ...),
//   then, with splits > 1, as partials [splits, M, N] that a second kernel
//   adds in order z = 0, 1, ... (int32 for K10, f32 for K14). No float
//   atomics.
// * The epilogue stages the CTA's outputs in shared memory and writes them
//   row by row of y, consecutive threads on consecutive columns. Rows past
//   the block's last row in use are written as exactly 0, and a block with
//   none streams no weights. The first pass takes a CTA per row, so a few
//   hundred rows of a long K still fill the card, and each row is quantized
//   once. (K5 quantizing its CTA's 16 rows in the main kernel's prologue
//   instead, in one launch, measured 1.4-1.5x slower at 8 rows on the H100:
//   the rows' divisions and two reads on one SM, repeated by every CTA
//   along N, cost more than the first pass and the gap; PERF.md.)
//
// Masking: output rows past N read zero bytes and are not stored; columns
// past K/2 (K10 at K % 128 != 0) read zero bytes of both operands.
#pragma once

#include <type_traits>

#include "int4_rows_a8.cuh"  // stage16, load16, kInv127: the quantizer

namespace f4b {
namespace {

constexpr int kI8Warps = 8;
constexpr int kI8Threads = kI8Warps * 32;
constexpr int kI8Mt = 16;      // rows of xq per CTA: two n8 tiles
constexpr int kI8Ring = 3;     // chunks in a warp's ring: 2 in flight while one is used

// The body's policies: what a weight byte becomes and how the sums fold.
//   RowA8      (K10, K11, K4, K5): low and high codes in one int32 sum, JAX's
//              epilogue.
//   GroupA8<R> (K14): low and high halves in separate int32 sums per group,
//                     folded into f32 at each group's end; R bytes per lane.
struct RowA8 {
  static constexpr bool kGroups = false;
  static constexpr int kRun = 16;
};
template <int R>
struct GroupA8 {
  static constexpr bool kGroups = true;
  static constexpr int kRun = R;
};

struct I8Args {
  const int8_t* xq;          // [M, K] quantized rows
  const float* sx;           // [M] their scales
  const int32_t* sums;       // [M, K / gsum] int32 sums of xq per group (lo groups, hi groups)
  const int32_t* used;       // [M] 1 for a row that holds a nonzero, 0 for zero padding
  const int32_t* gids;       // [M / tile_m] the expert of each tile; NULL: a linear (expert 0)
  const uint8_t* packed;     // [E, N, K/2] planar (K10) or [E, K/2/gs, N, gs] planar_groups (E = 1: K8)
  const float* scales;       // [E, N] (K10) or [E, N, K/gs] (K14)
  const float* zps;          // the same shape, integers in [0, 15]
  void* y;                   // [M, N], bf16 or f32 (out_f32)
  void* partial;             // [splits, M, N] int32 (K10) or f32 (K14) when splits > 1
  int M, N, K, gs, tile_m, out_f32;
  int ws, kw, splits;        // chunks per warp, warps along K per CTA, CTAs along K
};

// A slot of a warp's ring: per lane, R bytes of each of its two weight rows,
// then R bytes of the low and of the high half of its row of xq in each of
// the two n8 tiles; lanes side by side, so the 16-byte reads back are free of
// bank conflicts.
template <int R>
struct I8Slot {
  static constexpr int kBytes = 6 * 32 * R;
  static __device__ __forceinline__ int weights(int row, int lane) { return (row * 32 + lane) * R; }
  static __device__ __forceinline__ int x(int tile, int half, int lane) {
    return ((2 + tile * 2 + half) * 32 + lane) * R;
  }
};

// R bytes from global to shared memory, zero-filled when !valid: weights
// (kStream) bypass L1 and ask L2 for 256-byte lines, which prefetches the
// next chunks of the row; xq stays in L1 for the CTA's other warps.
template <int R, bool kStream>
__device__ __forceinline__ void i8_cp_async(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (R == 16 && kStream) {
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0));
  } else if constexpr (kStream) {
    asm volatile("cp.async.ca.shared.global.L2::256B [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(R), "r"(valid ? R : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(R),
                 "r"(valid ? R : 0));
  }
}

__device__ __forceinline__ void i8_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void i8_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void i8_lds(const uint8_t* src, uint32_t (&dst)[R / 4]) {
  if constexpr (R == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    dst[0] = u.x, dst[1] = u.y, dst[2] = u.z, dst[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    dst[0] = u.x, dst[1] = u.y;
  }
}

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lo_codes(uint32_t w) { return w & 0x0F0F0F0Fu; }
// K10: the high codes q_hi in [0, 15]
__device__ __forceinline__ uint32_t hi_codes(uint32_t w) {
  return ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}
// K14: 16 (q_hi - 8) as s8, the TPU kernel's bitcast of p & 0xF0
__device__ __forceinline__ uint32_t hi_shifted(uint32_t w) { return w & 0xF0F0F0F0u; }

__device__ __forceinline__ void store_out(void* y, size_t at, float v, int out_f32) {
  if (out_f32) {
    static_cast<float*>(y)[at] = v;
  } else {
    static_cast<__nv_bfloat16*>(y)[at] = __float2bfloat16(v);
  }
}

// 1 + the last row of block b (16 rows) that holds a nonzero, 0 for a block
// of zero padding rows; rows past M (a linear's last block) count as padding.
__device__ __forceinline__ int rows_in_use(const int32_t* __restrict__ used, int b, int M) {
  int last = 0;
#pragma unroll
  for (int r = 0; r < kI8Mt; ++r) {
    const int m = b * kI8Mt + r;
    last = m < M && used[m] ? r + 1 : last;
  }
  return last;
}

// The expert of row m: its tile's, or 0 for a linear (gids NULL).
__device__ __forceinline__ int i8_expert(const I8Args& p, int m) {
  return p.gids != nullptr ? p.gids[m / p.tile_m] : 0;
}

// The output of row m, column n from its (reduced) sum v.
template <class P>
__device__ __forceinline__ float a8_epilogue(const I8Args& p, int e, int m, int n,
                                             typename std::conditional<P::kGroups, float,
                                                                       int>::type v) {
  if constexpr (P::kGroups) {
    return __fmul_rn(v, p.sx[m]);
  } else {
    const size_t en = static_cast<size_t>(e) * p.N + n;
    const int xsum = p.sums[2 * m] + p.sums[2 * m + 1];
    const float yq = __fsub_rn(static_cast<float>(v),
                               __fmul_rn(p.zps[en], static_cast<float>(xsum)));
    return __fmul_rn(__fmul_rn(p.scales[en], p.sx[m]), yq);
  }
}

// One CTA: 16 rows of xq (blockIdx.x), 8 / kw row tiles (blockIdx.y), split
// blockIdx.z of K; warp w on row tile w / kw and K slice w % kw.
template <class P>
__global__ void __launch_bounds__(kI8Threads, 2) int8_mma_kernel(const I8Args p) {
  constexpr int R = P::kRun;      // bytes per lane per row per chunk
  constexpr int CB = 4 * R;       // packed bytes of a row per chunk
  constexpr int W = R / 4;        // 32-bit words per lane per row per chunk
  using Acc = typename std::conditional<P::kGroups, float, int>::type;
  extern __shared__ __align__(16) uint8_t smem[];  // the warps' rings
  __shared__ Acc red[kI8Warps][16][kI8Mt];

  const int kh = p.K / 2;
  const int chunks = (kh + CB - 1) / CB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int per_cta = kI8Warps / p.kw;
  const int kwi = warp % p.kw;
  const int ncta0 = blockIdx.y * per_cta * 16;            // the CTA's first output row
  const int ncols = min(per_cta * 16, p.N - ncta0);
  const int na = ncta0 + (warp / p.kw) * 16 + g, nb = na + 8;
  const int m0 = blockIdx.x * kI8Mt;
  const int mrows = min(kI8Mt, p.M - m0);  // rows of y the CTA writes
  const int mcount = rows_in_use(p.used, blockIdx.x, p.M);

  if (mcount == 0) {  // all zero padding: no weights, the outputs are 0
    if (p.splits == 1) {
      for (int i = threadIdx.x; i < mrows * ncols; i += kI8Threads) {
        const int r = i / ncols;
        store_out(p.y, static_cast<size_t>(m0 + r) * p.N + ncta0 + (i - r * ncols), 0.f,
                  p.out_f32);
      }
    }
    return;
  }
  const int e = i8_expert(p, m0);
  const uint8_t* wexp = p.packed + static_cast<size_t>(e) * p.N * kh;
  const int nt = (mcount + 7) / 8;  // n8 tiles of xq in use, CTA-uniform
  const int c_begin = (blockIdx.z * p.kw + kwi) * p.ws;
  const int c_end = min(c_begin + p.ws, chunks);

  // The warp's ring of kI8Ring chunks in shared memory. A slot holds, lane by
  // lane, the lane's R bytes of rows na and nb and of its row of xq (low and
  // high half) in each n8 tile: each lane copies in (cp.async) exactly the
  // bytes it reads back, so the ring needs no barrier.
  uint8_t* ring = smem + static_cast<size_t>(warp) * kI8Ring * I8Slot<R>::kBytes;
  auto issue = [&](int c) {  // chunk c's copies into its slot, as one commit group
    if (c < c_end) {
      uint8_t* slot = ring + (c % kI8Ring) * I8Slot<R>::kBytes;
      const int byte = c * CB + R * t;  // the lane's column in each half
      const bool in_k = byte < kh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = r == 0 ? na : nb;
        const bool valid = in_k && n < p.N;
        const uint8_t* src = p.packed;
        if (valid) {
          if constexpr (P::kGroups) {
            const int grp = byte / p.gs;
            src = wexp + (static_cast<size_t>(grp) * p.N + n) * p.gs + (byte - grp * p.gs);
          } else {
            src = wexp + static_cast<size_t>(n) * kh + byte;
          }
        }
        i8_cp_async<R, true>(slot + I8Slot<R>::weights(r, lane), src, valid);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j >= nt) break;  // CTA-uniform
        const int m = m0 + 8 * j + g;
        const bool vx = in_k && m < p.M;  // rows past M read zeros
        const int8_t* xr = p.xq + static_cast<size_t>(m) * p.K + byte;
        i8_cp_async<R, false>(slot + I8Slot<R>::x(j, 0, lane), vx ? xr : p.xq, vx);
        i8_cp_async<R, false>(slot + I8Slot<R>::x(j, 1, lane), vx ? xr + kh : p.xq, vx);
      }
    }
    i8_cp_async_commit();
  };

  int pl[2][4] = {}, ph[2][4] = {};  // int32 MMA sums (K10: pl only)
  float acc[2][4] = {};              // K14's f32 fold

  // The MMAs of the chunk in `slot`.
  auto chunk_mma = [&](const uint8_t* slot) {
    uint32_t w[2][W];
    i8_lds<R>(slot + I8Slot<R>::weights(0, lane), w[0]);
    i8_lds<R>(slot + I8Slot<R>::weights(1, lane), w[1]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= nt) break;  // CTA-uniform
      uint32_t xl[W], xh[W];
      i8_lds<R>(slot + I8Slot<R>::x(j, 0, lane), xl);
      i8_lds<R>(slot + I8Slot<R>::x(j, 1, lane), xh);
      if constexpr (P::kGroups) {
#pragma unroll
        for (int s = 0; s < W / 2; ++s) {
          mma_s8_16832(pl[j], lo_codes(w[0][2 * s]), lo_codes(w[1][2 * s]),
                       lo_codes(w[0][2 * s + 1]), lo_codes(w[1][2 * s + 1]), xl[2 * s],
                       xl[2 * s + 1]);
          mma_s8_16832(ph[j], hi_shifted(w[0][2 * s]), hi_shifted(w[1][2 * s]),
                       hi_shifted(w[0][2 * s + 1]), hi_shifted(w[1][2 * s + 1]), xh[2 * s],
                       xh[2 * s + 1]);
        }
      } else {
#pragma unroll
        for (int s = 0; s < W; ++s) {
          mma_s8_16832(pl[j], lo_codes(w[0][s]), lo_codes(w[1][s]), hi_codes(w[0][s]),
                       hi_codes(w[1][s]), xl[s], xh[s]);
        }
      }
    }
  };

  // K14: the raw fold operands of a group, loaded one group ahead of its fold:
  // (s_lo, s_hi, zp_lo, zp_hi) of rows na, nb and the int32 sums (X_lo, X_hi)
  // of x rows 8j + 2t, 8j + 2t + 1.
  const int ng = P::kGroups ? p.K / p.gs : 2, gh = ng / 2;
  float fv[2][4] = {};
  int xv[2][4] = {};
  auto load_fold = [&](int grp) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = r == 0 ? na : nb;
      const bool in = n < p.N;
      const size_t at = (static_cast<size_t>(e) * p.N + n) * ng + grp;
      fv[r][0] = in ? __ldg(p.scales + at) : 0.f;
      fv[r][1] = in ? __ldg(p.scales + at + gh) : 0.f;
      fv[r][2] = in ? __ldg(p.zps + at) : 0.f;
      fv[r][3] = in ? __ldg(p.zps + at + gh) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= nt) break;
      const int m = m0 + 8 * j + 2 * t;  // rows m and m + 1; past M: 0
      const int32_t* xs = p.sums + static_cast<size_t>(m) * ng + grp;
      xv[j][0] = m < p.M ? __ldg(xs) : 0;
      xv[j][1] = m + 1 < p.M ? __ldg(xs + ng) : 0;
      xv[j][2] = m < p.M ? __ldg(xs + gh) : 0;
      xv[j][3] = m + 1 < p.M ? __ldg(xs + ng + gh) : 0;
    }
  };
  // K14: fold the group's int32 sums into acc (the group order is the loop's).
  auto fold = [&]() {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= nt) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // q: (row na/nb) x (x row 2t / 2t + 1)
        const float* f = fv[q >> 1];
        const float s_lo = f[0], s_hi = f[1];
        float a = acc[j][q];
        a = __fadd_rn(a, __fmul_rn(s_lo, static_cast<float>(pl[j][q])));
        a = __fadd_rn(a, __fmul_rn(__fmul_rn(-s_lo, f[2]),
                                   static_cast<float>(xv[j][q & 1])));
        a = __fadd_rn(a, __fmul_rn(__fmul_rn(s_hi, 0.0625f), static_cast<float>(ph[j][q])));
        a = __fadd_rn(a, __fmul_rn(__fmul_rn(s_hi, __fsub_rn(8.f, f[3])),
                                   static_cast<float>(xv[j][2 + (q & 1)])));
        acc[j][q] = a;
        pl[j][q] = ph[j][q] = 0;
      }
    }
  };

  const int cpg = P::kGroups ? p.gs / CB : 1;  // chunks per group
  if constexpr (P::kGroups) {
    if (c_begin < c_end) load_fold(c_begin / cpg);
  }
#pragma unroll
  for (int i = 0; i < kI8Ring - 1; ++i) issue(c_begin + i);
  for (int c = c_begin; c < c_end; ++c) {
    issue(c + kI8Ring - 1);             // kI8Ring - 1 chunks stay in flight
    i8_cp_async_wait<kI8Ring - 1>();    // chunk c's copies have landed
    chunk_mma(ring + (c % kI8Ring) * I8Slot<R>::kBytes);
    if constexpr (P::kGroups) {
      if ((c + 1) % cpg == 0) {
        fold();
        if (c + 1 < c_end) load_fold((c + 1) / cpg);
      }
    }
  }
  i8_cp_async_wait<0>();

  // Stage the warp's sums: red[warp][row of its tile][x row].
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      Acc v;
      if constexpr (P::kGroups) {
        v = acc[j][q];
      } else {
        v = pl[j][q];
      }
      red[warp][g + 8 * (q >> 1)][8 * j + 2 * t + (q & 1)] = v;
    }
  }
  __syncthreads();
  // Add the kw warps of each row tile in order kwi = 0, 1, ...; write row by
  // row of y (or of the split's partials), consecutive threads on consecutive
  // columns.
  for (int i = threadIdx.x; i < mrows * ncols; i += kI8Threads) {
    const int r = i / ncols, col = i - r * ncols;
    const int tile = col >> 4, row = col & 15;
    const int m = m0 + r, n = ncta0 + col;
    const size_t at = static_cast<size_t>(m) * p.N + n;
    Acc v = red[tile * p.kw][row][r];
    for (int k = 1; k < p.kw; ++k) {
      if constexpr (P::kGroups) {
        v = __fadd_rn(v, red[tile * p.kw + k][row][r]);
      } else {
        v += red[tile * p.kw + k][row][r];
      }
    }
    if (p.splits > 1) {
      if (r < mcount) {
        static_cast<Acc*>(p.partial)[static_cast<size_t>(blockIdx.z) * p.M * p.N + at] = v;
      }
    } else {
      store_out(p.y, at, r < mcount ? a8_epilogue<P>(p, e, m, n, v) : 0.f, p.out_f32);
    }
  }
}

// The splits' partials added in order z = 0, 1, ..., then the epilogue; rows
// past their block's count of rows in use are 0.
template <class P>
__global__ void __launch_bounds__(kI8Threads) int8_mma_reduce_kernel(const I8Args p) {
  using Acc = typename std::conditional<P::kGroups, float, int>::type;
  const size_t i = static_cast<size_t>(blockIdx.x) * kI8Threads + threadIdx.x;
  const size_t mn = static_cast<size_t>(p.M) * p.N;
  if (i >= mn) return;
  const int m = static_cast<int>(i / p.N), n = static_cast<int>(i % p.N);
  float out = 0.f;
  if (m % kI8Mt < rows_in_use(p.used, m / kI8Mt, p.M)) {
    const Acc* part = static_cast<const Acc*>(p.partial);
    Acc v = part[i];
    for (int z = 1; z < p.splits; ++z) {
      if constexpr (P::kGroups) {
        v = __fadd_rn(v, part[z * mn + i]);
      } else {
        v += part[z * mn + i];
      }
    }
    out = a8_epilogue<P>(p, i8_expert(p, m), m, n, v);
  }
  store_out(p.y, i, out, p.out_f32);
}

// The first pass: one CTA per row of x. Writes the row's xq and sx, its int32
// sums of xq per group of gsum columns ([M, K/gsum]: the low half's groups,
// then the high half's) and used[m] (1 if the row holds a nonzero, 0 for a
// zero padding row, whose xq is written as zeros without a second read).
// fused: sx = amax * f32(1/127) (K5, K11, K14, K8), else amax / 127 (K10, K4). Requires K % 32 == 0, gsum
// % 16 == 0 dividing K/2, x 16-byte aligned.
constexpr int kPrepassThreads = 512;  // a row of x per CTA of the first pass

template <typename Tin>
__global__ void __launch_bounds__(kPrepassThreads) a8_prepass_kernel(
    const Tin* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
    int32_t* __restrict__ sums, int32_t* __restrict__ used, int K, int gsum, int fused) {
  extern __shared__ int group_sums[];  // [K / gsum]
  __shared__ float warp_amax[kPrepassThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ng = K / gsum;
  const size_t m = blockIdx.x;
  const Tin* row = x + m * K;
  for (int i = threadIdx.x; i < ng; i += kPrepassThreads) group_sums[i] = 0;
  float a = 0.f;
  for (int c = threadIdx.x * 16; c < K; c += kPrepassThreads * 16) {
    float v[16];
    load16(row + c, v);
#pragma unroll
    for (int j = 0; j < 16; ++j) a = fmaxf(a, fabsf(v[j]));
  }
  a = warp_max(a);
  if (lane == 0) warp_amax[warp] = a;
  __syncthreads();
  float amax = warp_amax[0];
#pragma unroll
  for (int w = 1; w < kPrepassThreads / 32; ++w) amax = fmaxf(amax, warp_amax[w]);
  const float s = fused ? __fmul_rn(fmaxf(amax, 1e-8f), kInv127)
                        : __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  for (int c = threadIdx.x * 16; c < K; c += kPrepassThreads * 16) {
    int sum = 0;
    // a zero row quantizes to zeros: no second read of it
    const uint4 q = amax > 0.f ? stage16(row + c, s, sum) : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(xq + m * K + c) = q;
    if (sum != 0) atomicAdd(group_sums + c / gsum, sum);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng; i += kPrepassThreads) sums[m * ng + i] = group_sums[i];
  if (threadIdx.x == 0) {
    sx[m] = s;
    used[m] = amax > 0.f;
  }
}

template <typename Tin>
int launch_a8_prepass(const void* x, void* xq, void* sx, void* sums, void* used, int M,
                      int K, int gsum, int fused, void* stream) {
  if (K % 32 != 0 || gsum <= 0 || gsum % 16 != 0 || (K / 2) % gsum != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(K / gsum) * sizeof(int);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  a8_prepass_kernel<Tin><<<M, kPrepassThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Tin*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx),
      static_cast<int32_t*>(sums), static_cast<int32_t*>(used), K, gsum, fused);
  return static_cast<int>(cudaGetLastError());
}

// Launch the main kernel (and, with splits > 1, the ordered second pass) on
// `stream`. Requires K % 32 == 0, kw in {1, 2, 4, 8}, ws >= 1, partial !=
// nullptr when splits > 1; with gids (grouped) tile_m % 16 == 0 (M a multiple
// of tile_m is the caller's); K14 and K8 also 4R | gs, gs | K/2 and whole
// groups per warp (ws % (gs / 4R) == 0).
template <class P>
int launch_int8_mma(const I8Args& p, void* stream) {
  constexpr int CB = 4 * P::kRun;
  const bool groups_ok = !P::kGroups || (p.gs > 0 && p.gs % CB == 0 && (p.K / 2) % p.gs == 0 &&
                                         p.ws % (p.gs / CB) == 0);
  const bool tiles_ok = p.gids == nullptr || (p.tile_m > 0 && p.tile_m % kI8Mt == 0);
  const bool ok = tiles_ok && p.K % 32 == 0 && p.ws >= 1 &&
                  (p.kw == 1 || p.kw == 2 || p.kw == 4 || p.kw == 8) && p.splits >= 1 &&
                  (p.splits == 1 || p.partial != nullptr) && groups_ok;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (p.M == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (p.N + 15) / 16;
  const int per_cta = kI8Warps / p.kw;
  const dim3 grid((p.M + kI8Mt - 1) / kI8Mt, (tiles + per_cta - 1) / per_cta, p.splits);
  const size_t smem = static_cast<size_t>(kI8Warps) * kI8Ring * I8Slot<P::kRun>::kBytes;
  // above 48 KB of dynamic shared memory, raised once per device
  constexpr int kDevices = 64;
  static bool allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(int8_mma_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) allowed[dev] = true;
  }
  int8_mma_kernel<P><<<grid, kI8Threads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(p.M) * p.N;
  int8_mma_reduce_kernel<P><<<static_cast<unsigned>((mn + kI8Threads - 1) / kI8Threads),
                              kI8Threads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

inline I8Args i8_args(const void* xq, const void* sx, const void* sums, const void* used,
                      const void* gids, const void* packed, const void* scales, const void* zps,
                      void* y, void* partial, int M, int N, int K, int gs, int tile_m,
                      int out_f32, int ws, int kw, int splits) {
  return I8Args{static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
                static_cast<const int32_t*>(sums), static_cast<const int32_t*>(used),
                static_cast<const int32_t*>(gids), static_cast<const uint8_t*>(packed),
                static_cast<const float*>(scales), static_cast<const float*>(zps),
                y, partial, M, N, K, gs, tile_m, out_f32, ws, kw, splits};
}

}  // namespace
}  // namespace f4b
