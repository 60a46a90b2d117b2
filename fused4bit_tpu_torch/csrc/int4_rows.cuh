// Shared inner loop of the w4a16 kernels on the planar layout in f32 (bf16
// runs int4_mma.cuh): the linear (int4_matmul.cu: K1 per row, K6 per group)
// and the grouped MoE product (grouped_matmul.cu: K2 per row, K12 per group,
// K9 per row split over K).
//
// Per row (K1, K2, K9):
//   y[m, n] = s[e, n] * sum_c ( x[m, c]        * (lo(p[e, n, c]) - zp[e, n])
//                             + x[m, K/2 + c]  * (hi(p[e, n, c]) - zp[e, n]) )
// with p the planar packed row (byte c: column c in the low nibble, column
// c + K/2 XOR 8 in the high nibble), e the expert of the row block (0 for the
// linear), and the sum in f32. The zero point is subtracted before the dot and
// the scale applied after it, as in the TPU kernels.
//
// Per group on the planar layout (K6, K12), with s, zp [e, n, K/gs] (column
// g of the low half's group g, column Gh + g of the high half's, Gh = K/2/gs):
//   w = round_T( round_T(s[e, n, g]) * (q - zp[e, n, g]) ),
//   y[m, n] = sum_c ( x[m, c] * w_lo[c] + x[m, K/2 + c] * w_hi[c] )
// which is the TPU kernels' dequantization to the compute type T before one
// dot per half (the scale expanded to the compute type, then the product
// rounded to it: bf16 twice, f32 once; __fmul_rn, so no FMA contraction),
// with f32 sums. A lane's 16-byte run lies in one group (gs % 128 == 0), so
// it reads its row's two scales and two zero points once per run.
//
// Work split: a CTA of 8 warps owns 32 output rows (4 per warp) and MT rows of
// x. It walks its range of K/2 in chunks of 512 packed bytes. Per chunk the
// CTA stages both halves of its MT x rows in shared memory, then every lane
// streams 16 bytes of each of its warp's 4 weight rows with one 16-byte load,
// unpacks the 32 nibbles with shifts, and accumulates against every staged x
// row in registers; the next chunk's weight loads are issued before this
// chunk's math. A warp shuffle reduces each (row, m) sum at the end; the
// scale is applied in the epilogue. Weight bytes are read once per MT rows of
// x, so a decode step (M <= 16 in bf16) streams the weights exactly once. For
// the grouped product a first pass marks the zero padding rows at the end of
// each block of MT rows; they are not computed, and a block of padding
// streams no weights at all.
//
// Split over K (K9): grid z cuts K/2 into `splits` ranges of whole chunks;
// each CTA writes its unscaled f32 sums to partial[z, m, n], and a second
// kernel adds the splits in order z = 0, 1, ... and applies the scale. No
// atomics: the result does not depend on the order the CTAs ran in.
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
// past N or at or past cend, the end of the CTA's range of the row), as one
// 16-byte load each.
__device__ __forceinline__ void load_weights(const uint8_t* __restrict__ w, int n0, int N,
                                             int kh, int cend, int c,
                                             uint4 (&dst)[kRowsPerWarp]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    dst[r] = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < N && c < cend) {
      dst[r] = __ldg(reinterpret_cast<const uint4*>(w + static_cast<size_t>(n0 + r) * kh + c));
    }
  }
}

// x [M, K] row-major; packed [E, N, K/2]; scales/zps [E, N] (per row) or
// [E, N, K/gs] (kGroups); gids [M / tile_m] (the expert of each tile of
// tile_m rows) or nullptr for E = 1; rows_used [ceil(M / MT)] (how many
// leading rows of each block of MT rows hold a nonzero; the rest are zero
// padding) or nullptr; y [M, N], or with partial != nullptr the unscaled f32
// sums of split blockIdx.z, partial [splits, M, N], each split over
// split_chunks chunks of K/2. Requires K % 32 == 0 (16-byte aligned rows), x
// 16-byte aligned, tile_m % MT == 0; with kGroups gs % 128 == 0 and gs | K/2.
template <typename T, bool kGroups>
__global__ void __launch_bounds__(kThreads) int4_rows_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, const float* __restrict__ zps,
    const int32_t* __restrict__ gids, int tile_m, const int32_t* __restrict__ rows_used,
    T* __restrict__ y, float* __restrict__ partial, int M, int N, int K, int gs,
    int split_chunks) {
  constexpr int MT = RowsTile<T>::kMt;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kVecsPerRow = kChunk / kVec;
  __shared__ __align__(16) T xs[2][MT][kChunk];

  const int kh = K / 2;
  const int ng = kGroups ? K / gs : 1;  // scales per weight row
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, M - m0);  // rows of y this CTA writes
  // rows it computes: zero rows at the end of the block give zero outputs
  const int mcount = rows_used != nullptr ? min(mrows, rows_used[blockIdx.y]) : mrows;
  const int expert = gids != nullptr ? gids[m0 / tile_m] : 0;
  const uint8_t* w = packed + static_cast<size_t>(expert) * N * kh;
  const float* s = scales + static_cast<size_t>(expert) * N * ng;
  const float* z = zps + static_cast<size_t>(expert) * N * ng;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kRowsPerCta + warp * kRowsPerWarp;
  // this CTA's range of packed columns [cbegin, cend)
  const int cbegin = blockIdx.z * split_chunks * kChunk;
  const int cend = min(kh, cbegin + split_chunks * kChunk);

  float zp[kRowsPerWarp];
  float acc[kRowsPerWarp][MT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    zp[r] = (!kGroups && n0 + r < N) ? z[n0 + r] : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;
  }

  // mcount is the same for the whole CTA, so the barriers below are uniform.
  const int kend = mcount > 0 ? cend : cbegin;
  uint4 wcur[kRowsPerWarp] = {};
  // none for an all-zero block
  if (kend > cbegin) load_weights(w, n0, N, kh, cend, cbegin + lane * 16, wcur);
  for (int c0 = cbegin; c0 < kend; c0 += kChunk) {
    const int clen = min(kChunk, kend - c0);
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
    load_weights(w, n0, N, kh, cend, c0 + kChunk + lane * 16, wnext);
    __syncthreads();

    const int cb = lane * 16;
    if (cb < clen) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (n0 + r < N) {
          const uint32_t words[4] = {wcur[r].x, wcur[r].y, wcur[r].z, wcur[r].w};
          float lo[16], hi[16];
          if constexpr (kGroups) {
            // the run's group in each half, its scale rounded to T
            const float* srow = s + static_cast<size_t>(n0 + r) * ng;
            const float* zrow = z + static_cast<size_t>(n0 + r) * ng;
            const int g = (c0 + cb) / gs;
            const float s_lo = round_to<T>(__ldg(srow + g)), z_lo = __ldg(zrow + g);
            const float s_hi = round_to<T>(__ldg(srow + ng / 2 + g));
            const float z_hi = __ldg(zrow + ng / 2 + g);
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const uint32_t p = (words[j >> 2] >> (8 * (j & 3))) & 0xFFu;
              lo[j] = round_to<T>(__fmul_rn(s_lo, static_cast<float>(p & 0xFu) - z_lo));
              hi[j] = round_to<T>(__fmul_rn(s_hi, static_cast<float>((p >> 4) ^ 8u) - z_hi));
            }
          } else {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const uint32_t p = (words[j >> 2] >> (8 * (j & 3))) & 0xFFu;
              lo[j] = static_cast<float>(p & 0xFu) - zp[r];
              hi[j] = static_cast<float>((p >> 4) ^ 8u) - zp[r];
            }
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
        const size_t at = static_cast<size_t>(m0 + m) * N + n;
        if (partial != nullptr) {
          partial[static_cast<size_t>(blockIdx.z) * M * N + at] = v;
        } else {
          y[at] = from_float<T>(kGroups ? v : s[n] * v);
        }
      }
    }
  }
}

// K9's second pass: y[m, n] = s[e, n] * (partial[0, m, n] + partial[1, m, n]
// + ...), the splits added in order, e the expert of row m's tile.
template <typename T>
__global__ void __launch_bounds__(kThreads) ksplit_reduce_kernel(
    const float* __restrict__ partial, int splits, const float* __restrict__ scales,
    const int32_t* __restrict__ gids, int tile_m, T* __restrict__ y, int M, int N) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t mn = static_cast<size_t>(M) * N;
  if (i >= mn) return;
  float v = 0.f;
  for (int zi = 0; zi < splits; ++zi) v += partial[zi * mn + i];
  const int m = static_cast<int>(i / N);
  const int n = static_cast<int>(i - static_cast<size_t>(m) * N);
  y[i] = from_float<T>(scales[static_cast<size_t>(gids[m / tile_m]) * N + n] * v);
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
// all-zero block: it writes their outputs as 0. gs: the group size (kGroups)
// or 0.
template <typename T, bool kGroups>
int launch_int4_rows(const void* x, const void* packed, const void* scales,
                     const void* zps, const void* gids, int tile_m, void* rows_used,
                     void* y, int M, int N, int K, int gs, void* stream,
                     float* partial = nullptr, int splits = 1) {
  constexpr int MT = RowsTile<T>::kMt;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (M + MT - 1) / MT;
  if (rows_used != nullptr) {
    rows_in_use_kernel<T><<<blocks, kThreads, 0, st>>>(static_cast<const T*>(x), M, K,
                                                      static_cast<int32_t*>(rows_used));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int chunks = (K / 2 + kChunk - 1) / kChunk;
  const dim3 grid((N + kRowsPerCta - 1) / kRowsPerCta, blocks, splits);
  int4_rows_kernel<T, kGroups><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(zps),
      static_cast<const int32_t*>(gids), tile_m, static_cast<const int32_t*>(rows_used),
      static_cast<T*>(y), partial, M, N, K, gs, (chunks + splits - 1) / splits);
  return static_cast<int>(cudaGetLastError());
}

// K9 (f32; bf16 runs int4_mma.cuh): the per-row grouped product split over
// K into `splits` ranges (partial: f32 scratch of splits * M * N), then the
// ordered reduction with the scale.
template <typename T>
int launch_int4_rows_ksplit(const void* x, const void* packed, const void* scales,
                            const void* zps, const void* gids, int tile_m, void* rows_used,
                            void* partial, void* y, int M, int N, int K, int splits,
                            void* stream) {
  const int err = launch_int4_rows<T, false>(x, packed, scales, zps, gids, tile_m, rows_used,
                                             nullptr, M, N, K, 0, stream,
                                             static_cast<float*>(partial), splits);
  if (err != 0) return err;
  const size_t mn = static_cast<size_t>(M) * N;
  ksplit_reduce_kernel<T><<<static_cast<unsigned>((mn + kThreads - 1) / kThreads), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), splits, static_cast<const float*>(scales),
      static_cast<const int32_t*>(gids), tile_m, static_cast<T*>(y), M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace f4b
