// The w4a8 activation quantizer's helpers, included by the int8 tensor-core
// body (int8_mma.cuh: its first pass quantizes for K4, K5, K8, K10, K11 and
// K14) and by the per-group CUDA-core loop (int4_rows_pg.cuh: K8 and K14 at
// gs % 32 != 0): stage16, kInv127, kA8Mt.
//
// Activations are quantized per row, symmetric int8, in one of two
// arithmetics:
//   host (K4, K10; ops.int8_xla._quantize_acts):
//     sx[m] = max(max_c |x[m, c]|, 1e-8) / 127           (IEEE division)
//   fused (K5, K11, K8, K14):
//     sx[m] = max(max_c |x[m, c]|, 1e-8) * f32(1/127)    (kInv127: XLA
//                                                          folds the TPU
//                                                          kernels' / 127.0)
//   xq[m, c] = clamp(rint(x[m, c] / sx[m]), -127, 127)   (IEEE division,
//                                                          half to even)
// with no FMA contraction, so the bits are the plain version's.
#pragma once

#include "int4_rows.cuh"

namespace f4b {
namespace {

constexpr int kA8Mt = 16;                         // x rows per CTA of int4_rows_pg.cuh
constexpr int kA8RowsPerWarp = kA8Mt / kWarps;    // x rows each warp stages there
// f32(1/127): XLA folds the TPU kernels' `amax / 127.0` into this multiply.
constexpr float kInv127 = 1.0f / 127.0f;

// 16 raw activations quantized with scale sx to int8 (byte j of the result
// is value j); adds their sum to `sum`.
template <typename T>
__device__ __forceinline__ uint4 stage16(const T* src, float sx, int& sum) {
  float v[16];
  load16(src, v);
  uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v[j], sx)), -127.f), 127.f);
    const int qi = static_cast<int>(q);
    sum += qi;
    words[j >> 2] |= (static_cast<uint32_t>(qi) & 0xFFu) << (8 * (j & 3));
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

}  // namespace
}  // namespace f4b
