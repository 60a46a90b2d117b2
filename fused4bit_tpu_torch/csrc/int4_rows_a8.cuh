// Shared CUDA-core kernel of the per-row w4a8 products: the linear (K4, K5;
// int4_matmul_a8.cu) and the grouped MoE product with the quantization in
// the kernel (K11; grouped_matmul_a8.cu). K10 runs the int8 tensor-core body
// of int8_mma.cuh.
//
// Activations are quantized per row, symmetric int8, as the TPU kernels do:
//   sx[m] = max(max_c |x[m, c]|, 1e-8) * f32(1/127)  (raw x: K5, K11)
//   xq[m, c] = clamp(rint(x[m, c] / sx[m]), -127, 127)   (IEEE division,
//                                                         half to even)
// The fused TPU kernels write `/ 127.0`, which XLA compiles as the multiply;
// for int8 input (K4) sx comes from the host quantizer, which divides.
// and the product is an exact integer dot followed by JAX's f32 epilogue:
//   acc[m, n]  = sum_c xq[m, c] * q[e, n, c]            (int32, exact)
//   xsum[m]    = sum_c xq[m, c]                          (int32, exact)
//   yq         = f32(acc) - zp[e, n] * f32(xsum)
//   y[m, n]    = (s[e, n] * sx[m]) * yq
// with q the 4-bit codes in [0, 15] and e the expert of the row block (0 for
// the linear). The TPU kernel sums xq_hi * vhi with vhi = 16 * (q_hi - 8)
// and adds 8 * xsum_hi back; acc here is the same integer, summed directly
// against q_hi. Every partial sum is an exact int32, so the summation order
// is free; |acc| <= 127 * 15 * K stays below 2^31 for any K below 1.1M.
// The epilogue uses __fmul_rn / __fsub_rn so that nvcc cannot contract it
// into an FMA: the rounding is JAX's, operation by operation.
//
// Work split, as in int4_rows.cuh: a CTA of 8 warps owns 32 output rows (4 per
// warp) and 16 rows of x, and walks K/2 in chunks of 512 packed bytes. Per
// chunk each warp stages 2 of the CTA's x rows as int8 in shared memory
// (both halves, 16 activations per lane), then every lane streams 16 packed
// bytes of each of its warp's 4 weight rows with one 16-byte load, splits
// them into low and high nibbles with two masks, and accumulates against
// every staged x row with __dp4a (4 byte products per instruction). A warp
// shuffle reduces each (row, m) sum at the end. With raw activations (K5,
// K11) each CTA quantizes its own x rows: a first pass over each row finds
// its amax, and the staging quantizes 16 values per lane. With int8
// activations (K4) the staging is a copy. For the grouped product a
// first pass marks the zero padding rows at the end of each block of 16 rows;
// they are written as 0 without being computed (a zero row quantizes to
// xq = 0, so its output is exactly 0).
#pragma once

#include <type_traits>

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

// max |x| over a row of K values (16-byte aligned, K % 16 == 0), reduced
// over the warp.
template <typename T>
__device__ __forceinline__ float row_absmax(const T* __restrict__ row, int K, int lane) {
  float a = 0.f;
  for (int c = lane * 16; c < K; c += 32 * 16) {
    float v[16];
    load16(row + c, v);
#pragma unroll
    for (int j = 0; j < 16; ++j) a = fmaxf(a, fabsf(v[j]));
  }
  return warp_max(a);
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

// x [M, K] row-major: int8 codes with their scales sx [M] (K4), or raw
// bf16/f32 activations quantized here (K5, K11; sx unused); packed [E, N,
// K/2]; scales/zps [E, N]; gids [M / tile_m] or nullptr for E = 1; rows_used
// [ceil(M / 16)] or nullptr; y [M, N] in Tout. Requires K % 32 == 0, x
// 16-byte aligned, tile_m % 16 == 0.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) int4_a8_rows_kernel(
    const Tin* __restrict__ x, const float* __restrict__ sx_in,
    const uint8_t* __restrict__ packed, const float* __restrict__ scales,
    const float* __restrict__ zps, const int32_t* __restrict__ gids, int tile_m,
    const int32_t* __restrict__ rows_used, Tout* __restrict__ y, int M, int N, int K) {
  constexpr int MT = kA8Mt;
  constexpr bool kRaw = !std::is_same<Tin, int8_t>::value;
  __shared__ __align__(16) int8_t xs[2][MT][kChunk];
  __shared__ float sx_s[MT];
  __shared__ int xsum_s[MT];

  const int kh = K / 2;
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, M - m0);  // rows of y this CTA writes
  // rows it computes: zero rows at the end of the block give zero outputs
  const int mcount = rows_used != nullptr ? min(mrows, rows_used[blockIdx.y]) : mrows;
  const int expert = gids != nullptr ? gids[m0 / tile_m] : 0;
  const uint8_t* w = packed + static_cast<size_t>(expert) * N * kh;
  const float* s = scales + static_cast<size_t>(expert) * N;
  const float* z = zps + static_cast<size_t>(expert) * N;
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
    if (m < mcount) {
      if constexpr (kRaw) {
        const float amax = row_absmax(x + static_cast<size_t>(m0 + m) * K, K, lane);
        sx_mine[i] = __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
      } else {
        sx_mine[i] = sx_in[m0 + m];
      }
      if (lane == 0) sx_s[m] = sx_mine[i];
    }
  }

  float zp[kRowsPerWarp];
  int acc[kRowsPerWarp][MT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    zp[r] = (n0 + r < N) ? z[n0 + r] : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0;
  }

  // mcount is the same for the whole CTA, so the barriers below are uniform.
  const int kend = mcount > 0 ? kh : 0;
  const bool has_rows = n0 < N;  // warp-uniform: the router has N = 8
  const int cb = lane * 16;
  uint4 wcur[kRowsPerWarp] = {};
  if (kend > 0) load_weights(w, n0, N, kh, kh, cb, wcur);  // none for an all-zero block
  for (int c0 = 0; c0 < kend; c0 += kChunk) {
    const int clen = min(kChunk, kh - c0);
    __syncthreads();  // the previous chunk is consumed
    if (cb < clen) {
#pragma unroll
      for (int i = 0; i < kA8RowsPerWarp; ++i) {
        const int m = warp + i * kWarps;
        if (m < mcount) {
          const Tin* row = x + static_cast<size_t>(m0 + m) * K + c0 + cb;
          *reinterpret_cast<uint4*>(&xs[0][m][cb]) = stage16(row, sx_mine[i], xsum_mine[i]);
          *reinterpret_cast<uint4*>(&xs[1][m][cb]) = stage16(row + kh, sx_mine[i], xsum_mine[i]);
        }
      }
    }
    // Issue the next chunk's weight loads before this chunk's math.
    uint4 wnext[kRowsPerWarp];
    load_weights(w, n0, N, kh, kh, c0 + kChunk + cb, wnext);
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
        if (m < mcount) {
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
    if (lane == 0 && m < mcount) xsum_s[m] = v;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = n0 + r;
    const float sn = n < N ? s[n] : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int v = warp_sum_int(acc[r][m]);  // 0 for rows past mcount
      if (lane == 0 && n < N && m < mrows) {
        float out = 0.f;
        if (m < mcount) {
          const float yq = __fsub_rn(static_cast<float>(v),
                                     __fmul_rn(zp[r], static_cast<float>(xsum_s[m])));
          out = __fmul_rn(__fmul_rn(sn, sx_s[m]), yq);
        }
        y[static_cast<size_t>(m0 + m) * N + n] = from_float<Tout>(out);
      }
    }
  }
}

// Launch on `stream`. With rows_used != nullptr (scratch of ceil(M / 16)
// ints), a first pass finds the zero rows at the end of each block of 16
// rows; the main kernel neither computes them nor streams weights for an
// all-zero block, and writes their outputs as 0.
template <typename Tin, typename Tout>
int launch_int4_a8_rows(const void* x, const void* sx, const void* packed,
                        const void* scales, const void* zps, const void* gids, int tile_m,
                        void* rows_used, void* y, int M, int N, int K, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (M + kA8Mt - 1) / kA8Mt;
  if (rows_used != nullptr) {
    rows_in_use_kernel<Tin, kA8Mt><<<blocks, kThreads, 0, st>>>(
        static_cast<const Tin*>(x), M, K, static_cast<int32_t*>(rows_used));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + kRowsPerCta - 1) / kRowsPerCta, blocks);
  int4_a8_rows_kernel<Tin, Tout><<<grid, kThreads, 0, st>>>(
      static_cast<const Tin*>(x), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
      static_cast<const float*>(zps), static_cast<const int32_t*>(gids), tile_m,
      static_cast<const int32_t*>(rows_used), static_cast<Tout*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace f4b
