// K2: grouped w4a16 INT4 product for the MoE experts.
//   y[t] = x_sorted[t] @ dequant(W[gid[t / tile_m]])^T  for every row t.
// K12: the same over per-group expert weights in the planar layout.
// K9: K2 with the K dimension split.
//
// K2 replaces the TPU kernel fused4bit_tpu/ops/grouped_matmul.py:_grouped_kernel,
// K12 replaces _grouped_pg_kernel (K6's arithmetic, int4_matmul.cu, per
// expert tile), K9 replaces _grouped_ksplit_kernel (K2's arithmetic with an
// f32 accumulator carried over k-tiles). Tokens arrive sorted by expert, each
// expert's group zero-padded to a multiple of tile_m, and tile_group_ids maps
// each tile to its expert (padding tiles past the last group map to expert
// E-1 and hold zero rows).
//
// One launch covers every (row block, column block): each CTA reads the
// expert of its own rows from tile_group_ids, so there is no host loop and no
// device-to-host sync. Every column of N (also past 256) and every row of a
// tile is written; zero padding rows give exactly zero, and a block of
// padding alone streams no weights (at decode, T=8, top-2, tile_m 16, 9
// tiles, of which one per expert hit holds tokens).
//
// K2, K12 and K9 in bf16 run the tensor-core body of int4_mma.cuh with
// grouped addressing (its note gives the design and the bound): K2 and K9
// under K1's RowScale policy, K12 under K6's GroupDequant (bf16(bf16(s) *
// (q - zp)) in registers, the scales and zero points [E, N, K/gs] offset by
// the block's expert). A first pass flags the rows in use, then the main
// kernel runs at the launch shape of the Python wrapper's rule
// (ops._mma: _grouped_mma_launch for K2 and K12 at tile_m <= 64,
// _ksplit_mma_launch for K9 at every tile_m, which read N, K and the SM
// count only, so a token row's bits do not depend on its dispatch; K2's and
// K12's 64-row tile of _mma_tall_launch at tile_m 128), and with splits > 1
// the ordered second pass. f32 K2, K12 and K9 run the CUDA-core loop of
// int4_rows.cuh (K1's old inner loop with the weight base chosen per CTA;
// an f32 tensor-core product would be TF32), after a first pass that finds
// the zero padding rows at the end of each block of rows.
//
// K9: on the TPU the k-split is a grid order that keeps one f32 accumulator
// in VMEM across the k steps. Blocks of a GPU run in no order, so here the
// split is split-K: `splits` CTAs share each output tile, each walking its
// own range of K/2 and writing f32 partial sums of the rows in use; a second
// kernel adds them in a fixed order and applies the scale. In bf16 that is
// K2's entry at K9's launch shape (K/2 cut into at least two slices handed
// to CTAs along K, where K2's rule hands them to the warps of a CTA first);
// in f32 the CUDA-core loop over `splits` ranges of whole 512-byte chunks.
// Deterministic; equal to K2 up to the reassociation of the f32 sum.
#include "int4_mma.cuh"
#include "int4_rows.cuh"

// K2 and K9 on the tensor cores: x [T, K] bf16; packed [E, N, K/2]; scales/zps [E, N];
// used: int32 scratch of T (the first pass's row flags); partial: f32 scratch
// of splits * T * N when splits > 1; mt 16, or 64 with tile_m % 64 == 0.
extern "C" int f4b_grouped_int4_matmul_mma_bf16(const void* x, const void* gids,
                                                const void* packed, const void* scales,
                                                const void* zps, void* used, void* y,
                                                void* partial, int T, int N, int K, int tile_m,
                                                int ws, int kw, int splits, int mt,
                                                void* stream) {
  return f4b::launch_int4_mma<f4b::RowScale, true>(
      f4b::mma_args(x, packed, scales, zps, y, partial, T, N, K, 0, ws, kw, splits, gids, used,
                    tile_m),
      mt, stream);
}

// K2 in f32 on the CUDA cores; rows_used: int32 scratch of ceil(T / 8).
extern "C" int f4b_grouped_int4_matmul_f32(const void* x, const void* gids,
                                           const void* packed, const void* scales,
                                           const void* zps, void* rows_used, void* y,
                                           int T, int N, int K, int tile_m,
                                           void* stream) {
  return f4b::launch_int4_rows<float, false>(x, packed, scales, zps, gids, tile_m, rows_used,
                                             y, T, N, K, 0, stream);
}

// K12 on the tensor cores: x [T, K] bf16; packed [E, N, K/2]; scales/zps
// [E, N, K/gs] f32, gs % 128 == 0 and gs | K/2; used, partial and mt as for K2.
extern "C" int f4b_grouped_int4_matmul_planar_pg_mma_bf16(const void* x, const void* gids,
                                                          const void* packed, const void* scales,
                                                          const void* zps, void* used, void* y,
                                                          void* partial, int T, int N, int K,
                                                          int gs, int tile_m, int ws, int kw,
                                                          int splits, int mt, void* stream) {
  return f4b::launch_int4_mma<f4b::GroupDequant, true>(
      f4b::mma_args(x, packed, scales, zps, y, partial, T, N, K, gs, ws, kw, splits, gids, used,
                    tile_m),
      mt, stream);
}

// K12 in f32 on the CUDA cores; rows_used: int32 scratch of ceil(T / 8).
extern "C" int f4b_grouped_int4_matmul_planar_pg_f32(const void* x, const void* gids,
                                                     const void* packed, const void* scales,
                                                     const void* zps, void* rows_used,
                                                     void* y, int T, int N, int K, int gs,
                                                     int tile_m, void* stream) {
  return f4b::launch_int4_rows<float, true>(x, packed, scales, zps, gids, tile_m, rows_used,
                                            y, T, N, K, gs, stream);
}

// K9 in f32 on the CUDA cores; partial: f32 scratch of splits * T * N.
extern "C" int f4b_grouped_int4_matmul_ksplit_f32(const void* x, const void* gids,
                                                  const void* packed, const void* scales,
                                                  const void* zps, void* rows_used,
                                                  void* partial, void* y, int T, int N,
                                                  int K, int tile_m, int splits,
                                                  void* stream) {
  return f4b::launch_int4_rows_ksplit<float>(x, packed, scales, zps, gids, tile_m, rows_used,
                                             partial, y, T, N, K, splits, stream);
}
