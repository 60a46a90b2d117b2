// CUDA-core kernel of K4, the per-row w4a8 linear on activations quantized
// before the kernel (int4_matmul_a8.cu), and the quantizer helpers that the
// int8 tensor-core body (int8_mma.cuh: K5, K8, K10, K11, K14) and the per-group
// CUDA-core loop (int4_rows_pg.cuh) include: stage16, kInv127, kA8Mt.
//
// K4's activations come quantized per row, symmetric int8, by the host
// quantizer (ops.int8_xla._quantize_acts):
//   sx[m] = max(max_c |x[m, c]|, 1e-8) / 127
//   xq[m, c] = clamp(rint(x[m, c] / sx[m]), -127, 127)   (IEEE division,
//                                                         half to even)
// The fused quantizer of K5, K11, K8 and K14 (the first pass of int8_mma.cuh,
// through stage16 below) multiplies by f32(1/127) instead, as XLA compiles the
// TPU kernels' `/ 127.0`.
// The product is an exact integer dot followed by JAX's f32 epilogue:
//   acc[m, n]  = sum_c xq[m, c] * q[n, c]               (int32, exact)
//   xsum[m]    = sum_c xq[m, c]                          (int32, exact)
//   yq         = f32(acc) - zp[n] * f32(xsum)
//   y[m, n]    = (s[n] * sx[m]) * yq
// with q the 4-bit codes in [0, 15]. The TPU kernel sums xq_hi * vhi with
// vhi = 16 * (q_hi - 8) and adds 8 * xsum_hi back; acc here is the same
// integer, summed directly against q_hi. Every partial sum is an exact int32,
// so the summation order is free; |acc| <= 127 * 15 * K stays below 2^31 for
// any K below 1.1M. The epilogue uses __fmul_rn / __fsub_rn so that nvcc
// cannot contract it into an FMA: the rounding is JAX's, operation by
// operation.
//
// Work split, as in int4_rows.cuh: a CTA of 8 warps owns 32 output rows (4 per
// warp) and 16 rows of xq, and walks K/2 in chunks of 512 packed bytes. Per
// chunk each warp copies 2 of the CTA's xq rows into shared memory (both
// halves, 16 activations per lane), then every lane streams 16 packed bytes of
// each of its warp's 4 weight rows with one 16-byte load, splits them into low
// and high nibbles with two masks, and accumulates against every staged row
// with __dp4a (4 byte products per instruction). A warp shuffle reduces each
// (row, m) sum at the end. K4 is not yet on the tensor cores (ROADMAP).
#pragma once

#include "int4_rows.cuh"

namespace f4b {
namespace {

constexpr int kA8Mt = 16;                         // x rows per CTA
constexpr int kA8RowsPerWarp = kA8Mt / kWarps;    // x rows each warp stages
// f32(1/127): XLA folds the TPU kernels' `amax / 127.0` into this multiply.
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 int8 activations from int8 input: a copy; adds their sum to `sum`.
__device__ __forceinline__ uint4 stage16(const int8_t* src, float, int& sum) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  sum = __dp4a(static_cast<int>(u.x), 0x01010101, sum);
  sum = __dp4a(static_cast<int>(u.y), 0x01010101, sum);
  sum = __dp4a(static_cast<int>(u.z), 0x01010101, sum);
  sum = __dp4a(static_cast<int>(u.w), 0x01010101, sum);
  return u;
}

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

// xq [M, K] int8 with their scales sx [M] (K4); packed [N, K/2]; scales/zps
// [N]; y [M, N] in Tout. Requires K % 32 == 0, xq 16-byte aligned.
template <typename Tout>
__global__ void __launch_bounds__(kThreads) int4_a8_rows_kernel(
    const int8_t* __restrict__ x, const float* __restrict__ sx_in,
    const uint8_t* __restrict__ packed, const float* __restrict__ scales,
    const float* __restrict__ zps, Tout* __restrict__ y, int M, int N, int K) {
  constexpr int MT = kA8Mt;
  __shared__ __align__(16) int8_t xs[2][MT][kChunk];
  __shared__ float sx_s[MT];
  __shared__ int xsum_s[MT];

  const int kh = K / 2;
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, M - m0);  // rows of y this CTA writes
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kRowsPerCta + warp * kRowsPerWarp;

  // The scale of each x row this warp stages: rows warp and warp + kWarps.
  float sx_mine[kA8RowsPerWarp];
  int xsum_mine[kA8RowsPerWarp];
#pragma unroll
  for (int i = 0; i < kA8RowsPerWarp; ++i) {
    const int m = warp + i * kWarps;
    sx_mine[i] = 1.f;
    xsum_mine[i] = 0;
    if (m < mrows) {
      sx_mine[i] = sx_in[m0 + m];
      if (lane == 0) sx_s[m] = sx_mine[i];
    }
  }

  float zp[kRowsPerWarp];
  int acc[kRowsPerWarp][MT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    zp[r] = (n0 + r < N) ? zps[n0 + r] : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0;
  }

  const bool has_rows = n0 < N;  // warp-uniform: the router has N = 8
  const int cb = lane * 16;
  uint4 wcur[kRowsPerWarp] = {};
  load_weights(packed, n0, N, kh, kh, cb, wcur);
  for (int c0 = 0; c0 < kh; c0 += kChunk) {
    const int clen = min(kChunk, kh - c0);
    __syncthreads();  // the previous chunk is consumed
    if (cb < clen) {
#pragma unroll
      for (int i = 0; i < kA8RowsPerWarp; ++i) {
        const int m = warp + i * kWarps;
        if (m < mrows) {
          const int8_t* row = x + static_cast<size_t>(m0 + m) * K + c0 + cb;
          *reinterpret_cast<uint4*>(&xs[0][m][cb]) = stage16(row, sx_mine[i], xsum_mine[i]);
          *reinterpret_cast<uint4*>(&xs[1][m][cb]) = stage16(row + kh, sx_mine[i], xsum_mine[i]);
        }
      }
    }
    // Issue the next chunk's weight loads before this chunk's math.
    uint4 wnext[kRowsPerWarp];
    load_weights(packed, n0, N, kh, kh, c0 + kChunk + cb, wnext);
    __syncthreads();

    if (has_rows && cb < clen) {
      // lo: codes of columns c..c+3 (low nibbles); hi: codes of columns
      // K/2 + c..c+3 (high nibble XOR 8). Both are bytes in [0, 15].
      uint32_t lo[kRowsPerWarp][4], hi[kRowsPerWarp][4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const uint32_t words[4] = {wcur[r].x, wcur[r].y, wcur[r].z, wcur[r].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[r][j] = words[j] & 0x0F0F0F0Fu;
          hi[r][j] = ((words[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < mrows) {
          const uint4 xl = *reinterpret_cast<const uint4*>(&xs[0][m][cb]);
          const uint4 xh = *reinterpret_cast<const uint4*>(&xs[1][m][cb]);
          const int xlw[4] = {static_cast<int>(xl.x), static_cast<int>(xl.y),
                              static_cast<int>(xl.z), static_cast<int>(xl.w)};
          const int xhw[4] = {static_cast<int>(xh.x), static_cast<int>(xh.y),
                              static_cast<int>(xh.z), static_cast<int>(xh.w)};
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            int a = acc[r][m];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              a = __dp4a(xlw[j], static_cast<int>(lo[r][j]), a);
              a = __dp4a(xhw[j], static_cast<int>(hi[r][j]), a);
            }
            acc[r][m] = a;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) wcur[r] = wnext[r];
  }

#pragma unroll
  for (int i = 0; i < kA8RowsPerWarp; ++i) {
    const int m = warp + i * kWarps;
    const int v = warp_sum_int(xsum_mine[i]);
    if (lane == 0 && m < mrows) xsum_s[m] = v;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = n0 + r;
    const float sn = n < N ? scales[n] : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int v = warp_sum_int(acc[r][m]);
      if (lane == 0 && n < N && m < mrows) {
        const float yq = __fsub_rn(static_cast<float>(v),
                                   __fmul_rn(zp[r], static_cast<float>(xsum_s[m])));
        y[static_cast<size_t>(m0 + m) * N + n] =
            from_float<Tout>(__fmul_rn(__fmul_rn(sn, sx_s[m]), yq));
      }
    }
  }
}

// Launch K4 on `stream`.
template <typename Tout>
int launch_int4_a8_rows(const void* xq, const void* sx, const void* packed, const void* scales,
                        const void* zps, void* y, int M, int N, int K, void* stream) {
  const dim3 grid((N + kRowsPerCta - 1) / kRowsPerCta, (M + kA8Mt - 1) / kA8Mt);
  int4_a8_rows_kernel<Tout><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
      static_cast<const float*>(zps), static_cast<Tout*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace f4b
