// K1: w4a16 per-row INT4 linear, y[M, N] = x[M, K] @ dequant(W[N, K])^T.
// K6: the same linear over per-group weights in the planar layout.
//
// K1 replaces the TPU kernel fused4bit_tpu/ops/int4_matmul.py:_int4_matmul_kernel
// (planar layout, zero point before the dot, scale after it, f32 sums). K6
// replaces _int4_group_kernel: per-group scales and zero points [N, K/gs] on
// the planar bytes, dequantized to the compute type before the dot as the TPU
// kernel does (int4_rows.cuh). The TPU kernel expands each group's scale to
// its columns with a 0/1 matrix product, a Mosaic workaround; here a lane's
// 16-byte run lies in one group (gs % 128 == 0) and reads the group's scale
// directly.
//
// What bounds it on the H100: at decode (M <= 16) the op reads K/2 bytes per
// output row (plus, for K6, 2 * K/gs f32 scales and zero points: 1/8 of the
// packed bytes at gs = 128) and does 2*M*K flops per row, far below the ~295
// flops per byte where the tensor cores become the limit, so it is bound by
// the bytes it streams from HBM (3.35 TB/s). What the design does about
// it: weights stay packed in HBM and are unpacked in registers, every weight
// byte is read once per 16 rows of x (the x rows are staged in shared memory
// and reused by all 32 output rows of the CTA), and the loads are 16 bytes
// per lane, neighbouring lanes on neighbouring addresses. K6 dequantizes each
// weight once per CTA (a multiply and a rounding more per weight than K1),
// then runs K1's FMA loop. The FMA loop runs on the CUDA cores; tensor-core
// MMA is later work (see PERF.md).
//
// The rows of the CTA past N are masked, so any N works (the MoE router has
// N = num_experts). K must be a multiple of 32 so each packed row is 16-byte
// aligned.
#include "int4_rows.cuh"

extern "C" int f4b_int4_matmul_bf16(const void* x, const void* packed,
                                    const void* scales, const void* zps, void* y,
                                    int M, int N, int K, void* stream) {
  return f4b::launch_int4_rows<__nv_bfloat16, false>(x, packed, scales, zps, nullptr, 1,
                                                     nullptr, y, M, N, K, 0, stream);
}

extern "C" int f4b_int4_matmul_f32(const void* x, const void* packed,
                                   const void* scales, const void* zps, void* y,
                                   int M, int N, int K, void* stream) {
  return f4b::launch_int4_rows<float, false>(x, packed, scales, zps, nullptr, 1, nullptr, y,
                                             M, N, K, 0, stream);
}

// K6: scales/zps [N, K/gs] f32, gs % 128 == 0 and gs | K/2.
extern "C" int f4b_int4_matmul_planar_pg_bf16(const void* x, const void* packed,
                                              const void* scales, const void* zps, void* y,
                                              int M, int N, int K, int gs, void* stream) {
  return f4b::launch_int4_rows<__nv_bfloat16, true>(x, packed, scales, zps, nullptr, 1,
                                                    nullptr, y, M, N, K, gs, stream);
}

extern "C" int f4b_int4_matmul_planar_pg_f32(const void* x, const void* packed,
                                             const void* scales, const void* zps, void* y,
                                             int M, int N, int K, int gs, void* stream) {
  return f4b::launch_int4_rows<float, true>(x, packed, scales, zps, nullptr, 1, nullptr, y,
                                            M, N, K, gs, stream);
}

extern "C" const char* f4b_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
