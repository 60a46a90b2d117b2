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
// tile is written; zero rows give exactly zero.
//
// What bounds it on the H100: at decode a tile holds a few tokens, so the op
// streams each selected expert's packed weights (N*K/2 bytes) for a handful of
// rows: bound by HBM bytes, like K1. At prefill (tile_m = 128) each weight
// byte serves MT rows per read, and the CUDA-core FMA loop becomes the bound.
// The design is K1's inner loop (int4_rows.cuh) with the weight base chosen
// per CTA. A first pass finds the zero padding rows at the end of each block
// of MT rows: they are written as 0 without being computed, and an all-padding
// block streams no weights (at decode, 7 of the 9 tiles of T=8, top-2).
//
// K9: on the TPU the k-split is a grid order that keeps one f32 accumulator
// in VMEM across the k steps. Blocks of a GPU run in no order, so here the
// split is split-K: `splits` CTAs share each output tile, each walking its
// own range of K/2 and writing f32 partial sums; a second kernel adds them in
// a fixed order and applies the scale. Deterministic, and equal to K2 up to
// the reassociation of the f32 sum. Splitting pays only where the grid has
// fewer CTAs than SMs (one CTA of 256 threads is resident per SM at these
// register counts): at the layer2 shapes every extra split measured slower,
// so the wrapper picks 1 there and K9 is K2 plus the ordered reduction.
// Tensor-core MMA is later work.
#include "int4_rows.cuh"

// rows_used: int32 scratch of ceil(T / MT) entries, MT = 16 (bf16) or 8 (f32).
extern "C" int f4b_grouped_int4_matmul_bf16(const void* x, const void* gids,
                                            const void* packed, const void* scales,
                                            const void* zps, void* rows_used, void* y,
                                            int T, int N, int K, int tile_m,
                                            void* stream) {
  return f4b::launch_int4_rows<__nv_bfloat16, false>(x, packed, scales, zps, gids, tile_m,
                                                     rows_used, y, T, N, K, 0, stream);
}

extern "C" int f4b_grouped_int4_matmul_f32(const void* x, const void* gids,
                                           const void* packed, const void* scales,
                                           const void* zps, void* rows_used, void* y,
                                           int T, int N, int K, int tile_m,
                                           void* stream) {
  return f4b::launch_int4_rows<float, false>(x, packed, scales, zps, gids, tile_m, rows_used,
                                             y, T, N, K, 0, stream);
}

// K12: scales/zps [E, N, K/gs] f32, gs % 128 == 0 and gs | K/2.
extern "C" int f4b_grouped_int4_matmul_planar_pg_bf16(const void* x, const void* gids,
                                                      const void* packed, const void* scales,
                                                      const void* zps, void* rows_used,
                                                      void* y, int T, int N, int K, int gs,
                                                      int tile_m, void* stream) {
  return f4b::launch_int4_rows<__nv_bfloat16, true>(x, packed, scales, zps, gids, tile_m,
                                                    rows_used, y, T, N, K, gs, stream);
}

extern "C" int f4b_grouped_int4_matmul_planar_pg_f32(const void* x, const void* gids,
                                                     const void* packed, const void* scales,
                                                     const void* zps, void* rows_used,
                                                     void* y, int T, int N, int K, int gs,
                                                     int tile_m, void* stream) {
  return f4b::launch_int4_rows<float, true>(x, packed, scales, zps, gids, tile_m, rows_used,
                                            y, T, N, K, gs, stream);
}

// K9: partial: f32 scratch of splits * T * N.
extern "C" int f4b_grouped_int4_matmul_ksplit_bf16(const void* x, const void* gids,
                                                   const void* packed, const void* scales,
                                                   const void* zps, void* rows_used,
                                                   void* partial, void* y, int T, int N,
                                                   int K, int tile_m, int splits,
                                                   void* stream) {
  return f4b::launch_int4_rows_ksplit<__nv_bfloat16>(x, packed, scales, zps, gids, tile_m,
                                                     rows_used, partial, y, T, N, K, splits,
                                                     stream);
}

extern "C" int f4b_grouped_int4_matmul_ksplit_f32(const void* x, const void* gids,
                                                  const void* packed, const void* scales,
                                                  const void* zps, void* rows_used,
                                                  void* partial, void* y, int T, int N,
                                                  int K, int tile_m, int splits,
                                                  void* stream) {
  return f4b::launch_int4_rows_ksplit<float>(x, packed, scales, zps, gids, tile_m, rows_used,
                                             partial, y, T, N, K, splits, stream);
}
