// K1: w4a16 per-row INT4 linear, y[M, N] = x[M, K] @ dequant(W[N, K])^T.
// K6: the same linear over per-group weights in the planar layout.
//
// K1 replaces the TPU kernel fused4bit_tpu/ops/int4_matmul.py:_int4_matmul_kernel
// (planar layout, zero point before the dot, scale after it, f32 sums). K6
// replaces _int4_group_kernel: per-group scales and zero points [N, K/gs] on
// the planar bytes, dequantized to the compute type before the dot as the TPU
// kernel does. The TPU kernel expands each group's scale to its columns with
// a 0/1 matrix product, a Mosaic workaround; here a lane's 16-byte run lies
// in one group (gs % 128 == 0) and reads the group's scale directly.
//
// bf16 x runs the tensor-core body of int4_mma.cuh (its note gives the design
// and the bound); the launch shape (ws, kw, splits, mt) comes from the Python
// wrapper's rule, ops._mma._mma_launch, and partial is f32 scratch of
// splits * M * N when splits > 1. f32 x stays on the CUDA-core loop of
// int4_rows.cuh: an f32 tensor-core product would be TF32.
//
// The rows of the CTA past N are masked, so any N works (the MoE router has
// N = num_experts). K must be a multiple of 32 so each packed row is 16-byte
// aligned.
#include "int4_mma.cuh"
#include "int4_rows.cuh"

extern "C" int f4b_int4_matmul_bf16(const void* x, const void* packed,
                                    const void* scales, const void* zps, void* y,
                                    void* partial, int M, int N, int K, int ws, int kw,
                                    int splits, int mt, void* stream) {
  return f4b::launch_int4_mma<f4b::RowScale>(
      f4b::mma_args(x, packed, scales, zps, y, partial, M, N, K, 0, ws, kw, splits), mt, stream);
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
                                              void* partial, int M, int N, int K, int gs,
                                              int ws, int kw, int splits, int mt,
                                              void* stream) {
  return f4b::launch_int4_mma<f4b::GroupDequant>(
      f4b::mma_args(x, packed, scales, zps, y, partial, M, N, K, gs, ws, kw, splits), mt, stream);
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
