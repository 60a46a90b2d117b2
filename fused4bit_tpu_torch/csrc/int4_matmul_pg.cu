// K7 and K8: per-group INT4 linear over planar_groups weights,
// y[M, N] = x[M, K] @ dequant(W[N, K])^T with W in groups of gs columns.
//
// K7 replaces fused4bit_tpu/ops/int4_matmul.py:_int4_group_bp_kernel (w4a16,
// batched partials); K8 replaces _int4_group_bp_a8_kernel (w4a8: int8
// activations and their scales in, quantized by the caller, as the TPU
// wrapper does). Both fold the group's scale and zero point into partial
// dots of the raw codes; the weights are never dequantized.
//
// K7 with bf16 x and gs % 64 == 0 (the production gs = 128 of as_per_group)
// runs the tensor-core body of int4_mma.cuh under its GroupFold policy (its
// note gives the design and the bound): the raw codes as mma operand A, the
// low and high halves in separate MMA steps, each chunk's f32 partials
// folded with its group's (s, c) and the per-row sums of the staged x. The
// launch shape (ws, kw, splits, mt) comes from the Python wrapper's rule,
// ops._mma._fold_mma_launch (decode, whole chunks per warp, reads
// N, K and the SM count only) or _mma_tall_launch (above 64 rows), and
// partial is f32 scratch of splits * M * N when splits > 1.
//
// K8 at gs % 32 == 0 runs the int8 tensor-core body of int8_mma.cuh: its
// first pass (f4b_a8_prepass_*, grouped_matmul_a8.cu) quantizes x with the
// TPU wrapper's arithmetic and sums each row per group, then K14's entry
// point (f4b_grouped_int4_matmul_pg_a8_mma, grouped_matmul_pg.cu) runs the
// linear as one expert with no tile map (gids NULL, any M), at the launch
// shape of ops._int8._linear_a8_launch (N, K, gs and the SM count only).
//
// K7 in f32 (an f32 tensor-core product would be TF32) or at the other
// group sizes planar_groups allows (gs % 16 == 0), and K8 at gs % 32 != 0
// (on activations the wrapper quantizes before the launch), run the
// CUDA-core kernels of int4_rows_pg.cuh: a lane's 16-byte run lies in one
// group and takes its fold at once. What bounds them on the H100 at decode
// is the HBM bytes (K/2 packed bytes per output row plus 2 * K/gs f32 scales
// and zero points), in practice the latency of walking K/2 in 512-byte
// chunks.
#include "int4_mma.cuh"
#include "int4_rows_pg.cuh"

// K7 on the tensor cores: x [M, K] bf16; packed [K/2/gs, N, gs] u8;
// scales/zps [N, K/gs]; gs % 64 == 0 dividing K/2.
extern "C" int f4b_int4_matmul_pg_mma_bf16(const void* x, const void* packed,
                                           const void* scales, const void* zps, void* y,
                                           void* partial, int M, int N, int K, int gs, int ws,
                                           int kw, int splits, int mt, void* stream) {
  return f4b::launch_int4_mma<f4b::GroupFold>(
      f4b::mma_args(x, packed, scales, zps, y, partial, M, N, K, gs, ws, kw, splits), mt, stream);
}

// K7 on the CUDA cores: x [M, K] bf16 or f32, gs % 16 == 0; the rest as above.
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

// K8 at gs % 32 != 0: xq [M, K] int8, sx [M] f32; y in the caller's activation type.
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
