// K10 and K11: grouped w4a8 INT4 product for the MoE experts.
//   y[t] = x_sorted[t] @ dequant(W[gid[t / tile_m]])^T  for every row t,
// with per-row symmetric int8 activations and an exact integer dot.
//
// K10 replaces fused4bit_tpu/ops/grouped_matmul.py:_grouped_a8_kernel (int8
// activations and their scales in) and K11 replaces _grouped_a8_fused_kernel
// (raw bf16/f32 activations in, quantized inside the kernel). Both run the
// int8 tensor-core body of int8_mma.cuh after its first pass
// (a8_prepass_kernel), which quantizes the rows, sums them, and marks the zero
// padding rows: K10 with the host quantizer's division by 127, K11 with XLA's
// folded multiply by f32(1/127) (fused = 1). See int8_mma.cuh for what bounds
// them and what the design does about it. Both take the expert per block of
// rows from tile_group_ids, K2's contract: one launch of each kernel, no host
// loop and no device-to-host sync, every column of N written (also past 256),
// zero padding rows written as exactly 0 and an all-padding block streams no
// weights. The linears K4 (the dividing first pass) and K5 (the multiplying
// one) run the same entries with gids NULL (ops.int4_matmul.int4_matmul_a8).
#include "int8_mma.cuh"

// The int8 body's first pass, shared with K4, K5, K11, K14 and K8: x [M, K]
// bf16 or f32 -> xq [M, K] i8, sx [M] f32, sums [M, K / gsum] i32, used [M]
// i32 (the row holds a nonzero); fused: sx by XLA's folded reciprocal (K5,
// K11, K14, K8), else a division (K10, K4).
extern "C" int f4b_a8_prepass_bf16(const void* x, void* xq, void* sx, void* sums,
                                   void* used, int M, int K, int gsum, int fused,
                                   void* stream) {
  return f4b::launch_a8_prepass<__nv_bfloat16>(x, xq, sx, sums, used, M, K, gsum, fused,
                                               stream);
}

extern "C" int f4b_a8_prepass_f32(const void* x, void* xq, void* sx, void* sums,
                                  void* used, int M, int K, int gsum, int fused,
                                  void* stream) {
  return f4b::launch_a8_prepass<float>(x, xq, sx, sums, used, M, K, gsum, fused, stream);
}

// K10 and K11 (and K4, K5 with gids NULL) on the first pass's outputs (sums per
// half: gsum = K/2); y in bf16, or f32 with out_f32; partial: int32 scratch of
// splits * M * N when splits > 1.
extern "C" int f4b_grouped_int4_matmul_a8_mma(const void* xq, const void* sx, const void* sums,
                                              const void* used, const void* gids,
                                              const void* packed, const void* scales,
                                              const void* zps, void* y, void* partial, int M,
                                              int N, int K, int tile_m, int out_f32, int ws,
                                              int kw, int splits, void* stream) {
  return f4b::launch_int8_mma<f4b::RowA8>(
      f4b::i8_args(xq, sx, sums, used, gids, packed, scales, zps, y, partial, M, N, K, 0,
                   tile_m, out_f32, ws, kw, splits),
      stream);
}
