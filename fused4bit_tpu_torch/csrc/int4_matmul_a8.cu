// K4 (and K5): w4a8 per-row INT4 linear, y[M, N] = x[M, K] @ dequant(W[N, K])^T
// with per-row symmetric int8 activations and an exact integer dot.
//
// K4 replaces fused4bit_tpu/ops/int4_matmul.py:_int4_a8_kernel (int8
// activations and their scales in, quantized by the caller) and runs the
// CUDA-core __dp4a loop of int4_rows_a8.cuh. What bounds it on the H100: at
// decode (M <= 16) it streams K/2 bytes of packed weight per output row for
// 2*M*K integer operations, so it is bound by HBM bytes and by the latency of
// walking K/2 in 512-byte chunks; the weights stay packed and are split into
// nibbles with two masks, and each __dp4a does four byte products.
//
// K5 replaces _int4_a8_fused_kernel (raw bf16/f32 activations in, quantized
// with XLA's folded f32(1/127)). It has no entry here: it runs the int8
// tensor-core body of int8_mma.cuh through K10's entries in
// grouped_matmul_a8.cu, the first pass (f4b_a8_prepass_*, fused) and then
// f4b_grouped_int4_matmul_a8_mma with gids NULL (one expert, any M), so its
// bits equal its plain version at any launch shape (exact int32 sums).
#include "int4_rows_a8.cuh"

// K4: xq [M, K] int8, sx [M] f32.
extern "C" int f4b_int4_matmul_a8_bf16(const void* xq, const void* sx, const void* packed,
                                       const void* scales, const void* zps, void* y, int M,
                                       int N, int K, void* stream) {
  return f4b::launch_int4_a8_rows<__nv_bfloat16>(xq, sx, packed, scales, zps, y, M, N, K,
                                                 stream);
}

extern "C" int f4b_int4_matmul_a8_f32(const void* xq, const void* sx, const void* packed,
                                      const void* scales, const void* zps, void* y, int M,
                                      int N, int K, void* stream) {
  return f4b::launch_int4_a8_rows<float>(xq, sx, packed, scales, zps, y, M, N, K, stream);
}
