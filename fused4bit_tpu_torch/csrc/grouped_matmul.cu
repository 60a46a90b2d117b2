// K2: grouped w4a16 INT4 product for the MoE experts.
//   y[t] = x_sorted[t] @ dequant(W[gid[t / tile_m]])^T  for every row t.
//
// Replaces the TPU kernel fused4bit_tpu/ops/grouped_matmul.py:_grouped_kernel.
// Tokens arrive sorted by expert, each expert's group zero-padded to a
// multiple of tile_m, and tile_group_ids maps each tile to its expert (padding
// tiles past the last group map to expert E-1 and hold zero rows).
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
// Tensor-core MMA is later work.
#include "int4_rows.cuh"

// rows_used: int32 scratch of ceil(T / MT) entries, MT = 16 (bf16) or 8 (f32).
extern "C" int f4b_grouped_int4_matmul_bf16(const void* x, const void* gids,
                                            const void* packed, const void* scales,
                                            const void* zps, void* rows_used, void* y,
                                            int T, int N, int K, int tile_m,
                                            void* stream) {
  return f4b::launch_int4_rows<__nv_bfloat16>(x, packed, scales, zps, gids, tile_m,
                                              rows_used, y, T, N, K, stream);
}

extern "C" int f4b_grouped_int4_matmul_f32(const void* x, const void* gids,
                                           const void* packed, const void* scales,
                                           const void* zps, void* rows_used, void* y,
                                           int T, int N, int K, int tile_m,
                                           void* stream) {
  return f4b::launch_int4_rows<float>(x, packed, scales, zps, gids, tile_m, rows_used,
                                      y, T, N, K, stream);
}
