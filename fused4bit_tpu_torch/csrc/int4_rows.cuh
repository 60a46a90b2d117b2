// Shared inner loop of the per-row w4a16 kernels: the linear (int4_matmul.cu)
// and the grouped MoE product (grouped_matmul.cu).
//
//   y[m, n] = s[e, n] * sum_c ( x[m, c]        * (lo(p[e, n, c]) - zp[e, n])
//                             + x[m, K/2 + c]  * (hi(p[e, n, c]) - zp[e, n]) )
//
// with p the planar packed row (byte c: column c in the low nibble, column
// c + K/2 XOR 8 in the high nibble), e the expert of the row block (0 for the
// linear), and the sum in f32. The zero point is subtracted before the dot and
// the scale applied after it, as in the TPU kernels.
//
// Work split: a CTA of 8 warps owns 32 output rows (4 per warp) and MT rows of
// x. It walks K/2 in chunks of 512 packed bytes. Per chunk the CTA stages both
// halves of its MT x rows in shared memory, then every lane streams 16 bytes
// of each of its warp's 4 weight rows with one 16-byte load, unpacks the 32
// nibbles with shifts, and accumulates against every staged x row in
// registers; the next chunk's weight loads are issued before this chunk's
// math. A warp shuffle reduces each (row, m) sum at the end; the scale is
// applied in the epilogue. Weight bytes are read once per MT rows of x, so a
// decode step (M <= 16 in bf16) streams the weights exactly once. For the
// grouped product a first pass marks the zero padding rows at the end of each
// block of MT rows; they are not computed, and a block of padding streams no
// weights at all.
#pragma once

#include "common.cuh"

namespace f4b {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;  // output rows per CTA
constexpr int kChunk = 512;                          // packed bytes per chunk: 32 lanes x 16 B
constexpr int kStageBytes = 32 * 1024;               // x staging buffer, [2][MT][kChunk] of T

// x rows per CTA: 16 in bf16, 8 in f32 (the staging buffer stays 32 KB).
template <typename T>
struct RowsTile {
  static constexpr int kMt = kStageBytes / (2 * kChunk * static_cast<int>(sizeof(T)));
};

// 16 consecutive values of a 16-byte-aligned shared-memory run, as f32.
__device__ __forceinline__ void load16(const float* src, float (&dst)[16]) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float4 f = reinterpret_cast<const float4*>(src)[v];
    dst[4 * v + 0] = f.x;
    dst[4 * v + 1] = f.y;
    dst[4 * v + 2] = f.z;
    dst[4 * v + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float (&dst)[16]) {
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const uint4 u = reinterpret_cast<const uint4*>(src)[v];
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 -> f32 is exact: the bf16 bits become the f32's upper half.
      dst[8 * v + 2 * i] = __uint_as_float(words[i] << 16);
      dst[8 * v + 2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
    }
  }
}

// The packed bytes c0 + lane*16 .. +15 of the warp's kRowsPerWarp rows (zero
// past N or past the row), as one 16-byte load each.
__device__ __forceinline__ void load_weights(const uint8_t* __restrict__ w, int n0, int N,
                                             int kh, int c, uint4 (&dst)[kRowsPerWarp]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    dst[r] = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < N && c < kh) {
      dst[r] = __ldg(reinterpret_cast<const uint4*>(w + static_cast<size_t>(n0 + r) * kh + c));
    }
  }
}

// x [M, K] row-major; packed [E, N, K/2]; scales/zps [E, N]; gids [M / tile_m]
// (the expert of each tile of tile_m rows) or nullptr for E = 1; rows_used
// [ceil(M / MT)] (how many leading rows of each block of MT rows hold a
// nonzero; the rest are zero padding) or nullptr; y [M, N]. Requires
// K % 32 == 0 (16-byte aligned rows), x 16-byte aligned, tile_m % MT == 0.
template <typename T>
__global__ void __launch_bounds__(kThreads) int4_rows_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, const float* __restrict__ zps,
    const int32_t* __restrict__ gids, int tile_m, const int32_t* __restrict__ rows_used,
    T* __restrict__ y, int M, int N, int K) {
  constexpr int MT = RowsTile<T>::kMt;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kVecsPerRow = kChunk / kVec;
  __shared__ __align__(16) T xs[2][MT][kChunk];

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

  float zp[kRowsPerWarp];
  float acc[kRowsPerWarp][MT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    zp[r] = (n0 + r < N) ? z[n0 + r] : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;
  }

  // mcount is the same for the whole CTA, so the barriers below are uniform.
  const int kend = mcount > 0 ? kh : 0;
  uint4 wcur[kRowsPerWarp] = {};
  if (kend > 0) load_weights(w, n0, N, kh, lane * 16, wcur);  // none for an all-zero block
  for (int c0 = 0; c0 < kend; c0 += kChunk) {
    const int clen = min(kChunk, kh - c0);
    __syncthreads();  // the previous chunk is consumed
    // Stage the rows in use, 16 bytes per load (rows and halves are 16-byte
    // aligned since K % 32 == 0; clen is a multiple of 16 elements).
    for (int i = threadIdx.x; i < mcount * kVecsPerRow; i += kThreads) {
      const int m = i / kVecsPerRow;
      const int c = (i - m * kVecsPerRow) * kVec;
      if (c < clen) {
        const T* row = x + static_cast<size_t>(m0 + m) * K + c0 + c;
        *reinterpret_cast<uint4*>(&xs[0][m][c]) = *reinterpret_cast<const uint4*>(row);
        *reinterpret_cast<uint4*>(&xs[1][m][c]) = *reinterpret_cast<const uint4*>(row + kh);
      }
    }
    // Issue the next chunk's weight loads before this chunk's math, so they
    // are in flight while it runs.
    uint4 wnext[kRowsPerWarp];
    load_weights(w, n0, N, kh, c0 + kChunk + lane * 16, wnext);
    __syncthreads();

    const int cb = lane * 16;
    if (cb < clen) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (n0 + r < N) {
          const uint32_t words[4] = {wcur[r].x, wcur[r].y, wcur[r].z, wcur[r].w};
          float lo[16], hi[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const uint32_t p = (words[j >> 2] >> (8 * (j & 3))) & 0xFFu;
            lo[j] = static_cast<float>(p & 0xFu) - zp[r];
            hi[j] = static_cast<float>((p >> 4) ^ 8u) - zp[r];
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < mcount) {
              float xl[16], xh[16];
              load16(&xs[0][m][cb], xl);
              load16(&xs[1][m][cb], xh);
              float a = acc[r][m];
#pragma unroll
              for (int j = 0; j < 16; ++j) {
                a = fmaf(lo[j], xl[j], a);
                a = fmaf(hi[j], xh[j], a);
              }
              acc[r][m] = a;
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) wcur[r] = wnext[r];
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = n0 + r;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float v = warp_sum(acc[r][m]);  // 0 for rows past mcount
      if (lane == 0 && n < N && m < mrows) {
        y[static_cast<size_t>(m0 + m) * N + n] = from_float<T>(s[n] * v);
      }
    }
  }
}

// rows_used[b] = 1 + the last row of block b (MT rows of x) that holds a
// nonzero bit, 0 for an all-zero block. One CTA per block.
template <typename T, int MT = RowsTile<T>::kMt>
__global__ void __launch_bounds__(kThreads) rows_in_use_kernel(
    const T* __restrict__ x, int M, int K, int32_t* __restrict__ rows_used) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  __shared__ int last;
  if (threadIdx.x == 0) last = 0;
  __syncthreads();
  const int m0 = blockIdx.x * MT;
  const int rows = min(MT, M - m0);
  const int vecs = K / kVec;
  int mine = 0;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int m = i / vecs;
    const uint4 u = reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + m) * K)[i - m * vecs];
    if ((u.x | u.y | u.z | u.w) != 0u) mine = max(mine, m + 1);
  }
  atomicMax(&last, mine);
  __syncthreads();
  if (threadIdx.x == 0) rows_used[blockIdx.x] = last;
}

// Launch on `stream`. With rows_used != nullptr (scratch of ceil(M / MT)
// ints), a first pass finds the zero rows at the end of each block of MT
// rows, and the main kernel neither computes them nor streams weights for an
// all-zero block: it writes their outputs as 0.
template <typename T>
int launch_int4_rows(const void* x, const void* packed, const void* scales,
                     const void* zps, const void* gids, int tile_m, void* rows_used,
                     void* y, int M, int N, int K, void* stream) {
  constexpr int MT = RowsTile<T>::kMt;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (M + MT - 1) / MT;
  if (rows_used != nullptr) {
    rows_in_use_kernel<T><<<blocks, kThreads, 0, st>>>(static_cast<const T*>(x), M, K,
                                                      static_cast<int32_t*>(rows_used));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + kRowsPerCta - 1) / kRowsPerCta, blocks);
  int4_rows_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(zps),
      static_cast<const int32_t*>(gids), tile_m, static_cast<const int32_t*>(rows_used),
      static_cast<T*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace f4b
