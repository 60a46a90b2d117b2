// K7 and K8: per-group INT4 linear over planar_groups weights,
// y[M, N] = x[M, K] @ dequant(W[N, K])^T with W in groups of gs columns.
//
// K7 replaces fused4bit_tpu/ops/int4_matmul.py:_int4_group_bp_kernel (w4a16,
// batched partials); K8 replaces _int4_group_bp_a8_kernel (w4a8: int8
// activations and their scales in, quantized by the caller, as the TPU
// wrapper does). Both run the kernels of int4_rows_pg.cuh: a partial dot per
// run of one group, then the group's scale and zero-point fold; the weights
// are never dequantized.
//
// What bounds it on the H100: at decode (M <= 16) the op streams K/2 bytes of
// packed weight per output row plus 2 * K/gs f32 scales and zero points
// (1/16 of the packed bytes at gs = 128) for 2*M*K operations: bound by HBM
// bytes, in practice by the latency of walking K/2 in 512-byte chunks, as K1
// (int4_matmul.cu). What the design does about it: K1's work split (16-byte
// loads, next chunk's weights in flight during this chunk's math, x staged
// once per CTA and reused by its 32 output rows); the planar_groups layout
// keeps each lane's 16 bytes contiguous inside one group, so the per-group
// scaling costs four multiply-adds per run of 16 columns. At prefill
// (M = 640) each weight byte serves MT rows per read, and the CUDA-core loop
// is the bound; tensor-core MMA is later work.
#include "int4_rows_pg.cuh"

// K7: x [M, K] bf16 or f32; packed [K/2/gs, N, gs] u8; scales/zps [N, K/gs].
extern "C" int f4b_int4_matmul_pg_bf16(const void* x, const void* packed, const void* scales,
                                       const void* zps, void* y, int M, int N, int K, int gs,
                                       void* stream) {
  return f4b::launch_int4_pg_rows<__nv_bfloat16>(x, packed, scales, zps, nullptr, 1, nullptr,
                                                 y, M, N, K, gs, stream);
}

extern "C" int f4b_int4_matmul_pg_f32(const void* x, const void* packed, const void* scales,
                                      const void* zps, void* y, int M, int N, int K, int gs,
                                      void* stream) {
  return f4b::launch_int4_pg_rows<float>(x, packed, scales, zps, nullptr, 1, nullptr, y, M, N,
                                         K, gs, stream);
}

// K8: xq [M, K] int8, sx [M] f32; y in the caller's activation type.
extern "C" int f4b_int4_matmul_pg_a8_bf16(const void* xq, const void* sx, const void* packed,
                                          const void* scales, const void* zps, void* y, int M,
                                          int N, int K, int gs, void* stream) {
  return f4b::launch_int4_pg_a8_rows<__nv_bfloat16>(xq, sx, packed, scales, zps, nullptr, 1,
                                                    nullptr, y, M, N, K, gs, stream);
}

extern "C" int f4b_int4_matmul_pg_a8_f32(const void* xq, const void* sx, const void* packed,
                                         const void* scales, const void* zps, void* y, int M,
                                         int N, int K, int gs, void* stream) {
  return f4b::launch_int4_pg_a8_rows<float>(xq, sx, packed, scales, zps, nullptr, 1, nullptr,
                                            y, M, N, K, gs, stream);
}
