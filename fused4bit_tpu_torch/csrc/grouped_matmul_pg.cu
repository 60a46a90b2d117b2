// K13 and K14: grouped per-group INT4 product for the MoE experts,
//   y[t] = x_sorted[t] @ dequant(W[gid[t / tile_m]])^T  for every row t,
// with stacked planar_groups expert weights [E, Gh, N, gs].
//
// K13 replaces fused4bit_tpu/ops/grouped_matmul.py:_grouped_pg_bp_kernel
// (w4a16): in bf16 at gs % 64 == 0 it runs the tensor-core body of
// int4_mma.cuh (K7's GroupFold arithmetic with grouped addressing: the raw
// codes as mma operand A, each 64-byte chunk's f32 partials folded with its
// group's scale and zero point, a first pass that flags the rows in use, the
// launch shape of ops._mma._grouped_mma_launch, which reads N, K
// and the SM count only, or the 64-row tile at tile_m 128); in f32 or at the
// other group sizes planar_groups allows, the CUDA-core kernel of
// int4_rows_pg.cuh. K14 replaces _grouped_pg_bp_a8_kernel (w4a8): at gs % 32
// == 0 it runs the int8 tensor-core body of int8_mma.cuh (after its first
// pass, f4b_a8_prepass_*, in grouped_matmul_a8.cu), at the other group sizes
// the CUDA-core kernel of int4_rows_pg.cuh. All take the expert per block of
// rows from tile_group_ids, K2's contract: one launch, no host loop and no
// device-to-host sync, every column of N written (also past 256), zero
// padding rows written as exactly 0 and an all-padding block streams no
// weights.
//
// What bounds the CUDA-core kernels on the H100: at decode (T = 8 tokens,
// top-2) a tile holds a token or two, so the op streams each selected
// expert's packed weights (N*K/2 bytes, plus N*K/gs*8 bytes of scales and
// zero points) for a handful of rows: bound by HBM bytes. A first pass finds
// the zero padding rows at the end of each block of MT rows. At prefill
// (tile_m = 128) each weight byte serves MT rows per read and the CUDA-core
// loop (FMA in K13, __dp4a in K14) becomes the bound.
#include "int4_mma.cuh"
#include "int4_rows_pg.cuh"
#include "int8_mma.cuh"

// K13 on the tensor cores: x [T, K] bf16; packed [E, K/2/gs, N, gs] u8;
// scales/zps [E, N, K/gs]; gs % 64 == 0 dividing K/2; used, partial and mt as
// for K2 (grouped_matmul.cu).
extern "C" int f4b_grouped_int4_matmul_pg_mma_bf16(const void* x, const void* gids,
                                                   const void* packed, const void* scales,
                                                   const void* zps, void* used, void* y,
                                                   void* partial, int T, int N, int K, int gs,
                                                   int tile_m, int ws, int kw, int splits, int mt,
                                                   void* stream) {
  return f4b::launch_int4_mma<f4b::GroupFold, true>(
      f4b::mma_args(x, packed, scales, zps, y, partial, T, N, K, gs, ws, kw, splits, gids, used,
                    tile_m),
      mt, stream);
}

// K13 on the CUDA cores: x [T, K] bf16 or f32; rows_used: int32 scratch of ceil(T / MT), MT = 16
// (bf16) or 8 (f32).
extern "C" int f4b_grouped_int4_matmul_pg_bf16(const void* x, const void* gids,
                                               const void* packed, const void* scales,
                                               const void* zps, void* rows_used, void* y, int T,
                                               int N, int K, int gs, int tile_m, void* stream) {
  return f4b::launch_int4_pg_rows<__nv_bfloat16>(x, packed, scales, zps, gids, tile_m,
                                                 rows_used, y, T, N, K, gs, stream);
}

extern "C" int f4b_grouped_int4_matmul_pg_f32(const void* x, const void* gids,
                                              const void* packed, const void* scales,
                                              const void* zps, void* rows_used, void* y, int T,
                                              int N, int K, int gs, int tile_m, void* stream) {
  return f4b::launch_int4_pg_rows<float>(x, packed, scales, zps, gids, tile_m, rows_used, y,
                                         T, N, K, gs, stream);
}

// K14 at other group sizes: xq [T, K] int8, sx [T] f32; rows_used: int32 scratch of
// ceil(T / 16).
extern "C" int f4b_grouped_int4_matmul_pg_a8_bf16(const void* xq, const void* sx,
                                                  const void* gids, const void* packed,
                                                  const void* scales, const void* zps,
                                                  void* rows_used, void* y, int T, int N, int K,
                                                  int gs, int tile_m, void* stream) {
  return f4b::launch_int4_pg_a8_rows<__nv_bfloat16>(xq, sx, packed, scales, zps, gids, tile_m,
                                                    rows_used, y, T, N, K, gs, stream);
}

extern "C" int f4b_grouped_int4_matmul_pg_a8_f32(const void* xq, const void* sx,
                                                 const void* gids, const void* packed,
                                                 const void* scales, const void* zps,
                                                 void* rows_used, void* y, int T, int N, int K,
                                                 int gs, int tile_m, void* stream) {
  return f4b::launch_int4_pg_a8_rows<float>(xq, sx, packed, scales, zps, gids, tile_m,
                                            rows_used, y, T, N, K, gs, stream);
}

// K14 at gs % 32 == 0 on the first pass's outputs (sums per group of gs);
// y in bf16, or f32 with out_f32; partial: f32 scratch of splits * M * N when
// splits > 1. 16 bytes per lane at gs % 64 == 0, else 8. With gids NULL
// (tile_m unread) it is K8: the linear [M, K] x [N, K] over packed [K/2/gs,
// N, gs] and scales/zps [N, K/gs], at any M.
extern "C" int f4b_grouped_int4_matmul_pg_a8_mma(const void* xq, const void* sx,
                                                 const void* sums, const void* used,
                                                 const void* gids, const void* packed,
                                                 const void* scales, const void* zps, void* y,
                                                 void* partial, int M, int N, int K, int gs,
                                                 int tile_m, int out_f32, int ws, int kw,
                                                 int splits, void* stream) {
  const f4b::I8Args p = f4b::i8_args(xq, sx, sums, used, gids, packed, scales, zps, y,
                                     partial, M, N, K, gs, tile_m, out_f32, ws, kw, splits);
  if (gs % 64 == 0) return f4b::launch_int8_mma<f4b::GroupA8<16>>(p, stream);
  return f4b::launch_int8_mma<f4b::GroupA8<8>>(p, stream);
}
