// K4 and K5: w4a8 per-row INT4 linear, y[M, N] = x[M, K] @ dequant(W[N, K])^T
// with per-row symmetric int8 activations and an exact integer dot.
//
// K4 replaces fused4bit_tpu/ops/int4_matmul.py:_int4_a8_kernel (int8
// activations and their scales in, quantized by the caller); K5 replaces
// _int4_a8_fused_kernel (raw bf16/f32 activations in, quantized inside the
// kernel). One kernel template serves both (int4_rows_a8.cuh): the
// integer math is the same, with or without the quantization prologue.
//
// What bounds it on the H100: at decode (M <= 16) the op streams K/2 bytes of
// packed weight per output row for 2*M*K integer operations, so, like K1, it
// is bound by HBM bytes and by the latency of walking K/2 in 512-byte chunks.
// What the design does about it: the weights stay packed and are split into
// nibbles with two masks (no float conversion at all), each __dp4a does four
// byte products, and x is staged once per CTA as int8, so a 16-byte shared
// load holds 16 activations. K5 requantizes its 16 rows of x in every CTA
// (each CTA reads the rows twice from L2: amax, then staging), as the TPU
// kernel requantizes per (i, j) grid step. Tensor-core int8 MMA is later work.
#include "int4_rows_a8.cuh"

// K4: xq [M, K] int8, sx [M] f32.
extern "C" int f4b_int4_matmul_a8_bf16(const void* xq, const void* sx, const void* packed,
                                       const void* scales, const void* zps, void* y, int M,
                                       int N, int K, void* stream) {
  return f4b::launch_int4_a8_rows<int8_t, __nv_bfloat16>(xq, sx, packed, scales, zps, nullptr,
                                                         1, nullptr, y, M, N, K, stream);
}

extern "C" int f4b_int4_matmul_a8_f32(const void* xq, const void* sx, const void* packed,
                                      const void* scales, const void* zps, void* y, int M,
                                      int N, int K, void* stream) {
  return f4b::launch_int4_a8_rows<int8_t, float>(xq, sx, packed, scales, zps, nullptr, 1,
                                                 nullptr, y, M, N, K, stream);
}

// K5: x [M, K] bf16 or f32, quantized in the kernel; y in x's type.
extern "C" int f4b_int4_matmul_a8_fused_bf16(const void* x, const void* packed,
                                             const void* scales, const void* zps, void* y,
                                             int M, int N, int K, void* stream) {
  return f4b::launch_int4_a8_rows<__nv_bfloat16, __nv_bfloat16>(
      x, nullptr, packed, scales, zps, nullptr, 1, nullptr, y, M, N, K, stream);
}

extern "C" int f4b_int4_matmul_a8_fused_f32(const void* x, const void* packed,
                                            const void* scales, const void* zps, void* y,
                                            int M, int N, int K, void* stream) {
  return f4b::launch_int4_a8_rows<float, float>(x, nullptr, packed, scales, zps, nullptr, 1,
                                                nullptr, y, M, N, K, stream);
}
