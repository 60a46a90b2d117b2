// K10 and K11: grouped w4a8 INT4 product for the MoE experts.
//   y[t] = x_sorted[t] @ dequant(W[gid[t / tile_m]])^T  for every row t,
// with per-row symmetric int8 activations and an exact integer dot.
//
// K10 replaces fused4bit_tpu/ops/grouped_matmul.py:_grouped_a8_kernel (int8
// activations and their scales in); K11 replaces _grouped_a8_fused_kernel
// (raw bf16/f32 activations in, quantized inside the kernel). Both run the
// kernel of int4_rows_a8.cuh with the expert chosen per CTA from
// tile_group_ids, K2's contract: one launch, no host loop and no
// device-to-host sync, every column of N written (also past 256), zero
// padding rows written as exactly 0.
//
// What bounds it on the H100: at decode (T = 8 tokens, top-2, tile_m = 32:
// T_pad = 288) a tile holds a token or two, so the op streams each selected
// expert's packed weights (N*K/2 bytes) for a handful of rows: bound by HBM
// bytes. A first pass finds the zero padding rows at the end of each block of
// 16 rows; an all-padding block streams no weights. At prefill (tile_m = 128)
// each weight byte serves 16 rows per read, and the __dp4a loop becomes the
// bound. Tensor-core int8 MMA is later work.
#include "int4_rows_a8.cuh"

// K10: xq [T, K] int8, sx [T] f32; rows_used: int32 scratch of ceil(T / 16).
extern "C" int f4b_grouped_int4_matmul_a8_bf16(const void* xq, const void* sx,
                                               const void* gids, const void* packed,
                                               const void* scales, const void* zps,
                                               void* rows_used, void* y, int T, int N, int K,
                                               int tile_m, void* stream) {
  return f4b::launch_int4_a8_rows<int8_t, __nv_bfloat16>(xq, sx, packed, scales, zps, gids,
                                                         tile_m, rows_used, y, T, N, K, stream);
}

extern "C" int f4b_grouped_int4_matmul_a8_f32(const void* xq, const void* sx,
                                              const void* gids, const void* packed,
                                              const void* scales, const void* zps,
                                              void* rows_used, void* y, int T, int N, int K,
                                              int tile_m, void* stream) {
  return f4b::launch_int4_a8_rows<int8_t, float>(xq, sx, packed, scales, zps, gids, tile_m,
                                                 rows_used, y, T, N, K, stream);
}

// K11: x [T, K] bf16 or f32, quantized in the kernel; y in x's type.
extern "C" int f4b_grouped_int4_matmul_a8_fused_bf16(const void* x, const void* gids,
                                                     const void* packed, const void* scales,
                                                     const void* zps, void* rows_used, void* y,
                                                     int T, int N, int K, int tile_m,
                                                     void* stream) {
  return f4b::launch_int4_a8_rows<__nv_bfloat16, __nv_bfloat16>(
      x, nullptr, packed, scales, zps, gids, tile_m, rows_used, y, T, N, K, stream);
}

extern "C" int f4b_grouped_int4_matmul_a8_fused_f32(const void* x, const void* gids,
                                                    const void* packed, const void* scales,
                                                    const void* zps, void* rows_used, void* y,
                                                    int T, int N, int K, int tile_m,
                                                    void* stream) {
  return f4b::launch_int4_a8_rows<float, float>(x, nullptr, packed, scales, zps, gids, tile_m,
                                                rows_used, y, T, N, K, stream);
}
