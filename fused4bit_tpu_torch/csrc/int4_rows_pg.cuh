// Shared kernels of the per-group products over planar_groups weights: the
// w4a16 and w4a8 linears (int4_matmul_pg.cu: K7, and K8 at group sizes that
// are not multiples of 32) and the grouped MoE products (grouped_matmul_pg.cu:
// K13, and K14 at those group sizes; K8 and K14 at gs % 32 == 0 run
// int8_mma.cuh).
//
// Weights: planar_groups bytes packed3[e, g, n, 0..gs) (Gh = K/2 / gs
// groups; byte c of group g holds the code of column g*gs + c in its low
// nibble and the code of column K/2 + g*gs + c, XOR 8, in its high nibble);
// per-group scales and zero points s, zp [e, n, 2*Gh] (group g of the low
// half is column g, of the high half column Gh + g). The product is the TPU
// kernels' batched-partials fold, with the weights never dequantized:
//   a_lo = s_lo              c_lo = -s_lo * zp_lo
//   a_hi = s_hi / 16         c_hi = s_hi * (8 - zp_hi)
//   y[m, n] = sum over runs of 16 columns of each half:
//             a_lo * P_lo + c_lo * X_lo + a_hi * P_hi + c_hi * X_hi
// with P_lo = sum x_lo * q_lo and P_hi = sum x_hi * vhi over the run
// (vhi = int8(p & 0xF0) = 16 * (q_hi - 8)) and X the sums of x over it.
// The TPU kernel takes P and X over a whole group (one MXU dot per group);
// here each lane takes them over its own 16 bytes of a group (gs % 16 == 0,
// so a run never straddles two groups) and applies the group's a and c at
// once, so no partial crosses lanes before the final warp reduction.
//
// w4a16 (K7, K13): x is bf16 or f32, P and X are f32 sums, the fold uses FMA.
// X is the sum of x as given, which for bf16 and f32 input is both JAX's
// xs (f32 of the input) and the dot's operand.
//
// w4a8 (K8, K14): x arrives quantized per row, xq int8 with scale sx (the
// host quantizer, as in the TPU wrappers). P and X are exact int32 dots
// (__dp4a against the codes; P_hi = 16 * (sum xq_hi * q_hi - 8 * X_hi)).
// Every f32 step is __fmul_rn / __fadd_rn in a fixed order, per lane:
//   acc += a_lo * f32(P_lo); acc += c_lo * f32(X_lo);
//   acc += a_hi * f32(P_hi); acc += c_hi * f32(X_hi)
// over its runs in chunk order, then the xor-butterfly warp sum, then
// y = acc * sx: the plain version (ops._rows._pg_a8_product) repeats
// these operations one for one, so the two agree bit for bit.
//
// Work split, as in int4_rows.cuh: a CTA of 8 warps owns 32 output rows (4
// per warp) and MT rows of x, and walks K/2 in chunks of 512 packed bytes;
// per chunk the CTA stages both halves of its x rows in shared memory and
// every lane streams 16 bytes of each of its warp's 4 weight rows with one
// 16-byte load (a run of one group: packed3[g, n, c .. c+16)). The next
// chunk's weight loads are issued before this chunk's math. For the grouped
// product the expert comes from tile_group_ids per CTA, and a first pass
// marks the zero padding rows at the end of each block of MT rows: they are
// written as 0 without being computed (a zero row gives P = X = 0).
#pragma once

#include "int4_rows_a8.cuh"

namespace f4b {
namespace {

// The 16 packed bytes at byte c (c % 16 == 0) of each of the warp's rows, in
// the planar_groups layout [Gh, N, gs] (zero past N or past K/2).
__device__ __forceinline__ void load_weights_pg(const uint8_t* __restrict__ w, int n0, int N,
                                                int kh, int gs, int c,
                                                uint4 (&dst)[kRowsPerWarp]) {
  const int g = c / gs;
  const size_t base = static_cast<size_t>(g) * N;
  const int off = c - g * gs;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    dst[r] = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < N && c < kh) {
      dst[r] = __ldg(reinterpret_cast<const uint4*>(w + (base + n0 + r) * gs + off));
    }
  }
}

// x [M, K] row-major bf16/f32; packed [E, Gh, N, gs]; scales/zps [E, N, 2Gh];
// gids [M / tile_m] or nullptr for E = 1; rows_used [ceil(M / MT)] or
// nullptr; y [M, N]. Requires K % 32 == 0, gs % 16 == 0, gs | K/2, x
// 16-byte aligned, tile_m % MT == 0.
template <typename T>
__global__ void __launch_bounds__(kThreads) int4_pg_rows_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, const float* __restrict__ zps,
    const int32_t* __restrict__ gids, int tile_m, const int32_t* __restrict__ rows_used,
    T* __restrict__ y, int M, int N, int K, int gs) {
  constexpr int MT = RowsTile<T>::kMt;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kVecsPerRow = kChunk / kVec;
  __shared__ __align__(16) T xs[2][MT][kChunk];

  const int kh = K / 2;
  const int gh = kh / gs;
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, M - m0);
  const int mcount = rows_used != nullptr ? min(mrows, rows_used[blockIdx.y]) : mrows;
  const int expert = gids != nullptr ? gids[m0 / tile_m] : 0;
  const uint8_t* w = packed + static_cast<size_t>(expert) * N * kh;
  const float* s = scales + static_cast<size_t>(expert) * N * 2 * gh;
  const float* z = zps + static_cast<size_t>(expert) * N * 2 * gh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kRowsPerCta + warp * kRowsPerWarp;
  const int cb = lane * 16;

  float acc[kRowsPerWarp][MT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;
  }

  // mcount is the same for the whole CTA, so the barriers below are uniform.
  const int kend = mcount > 0 ? kh : 0;
  uint4 wcur[kRowsPerWarp] = {};
  if (kend > 0) load_weights_pg(w, n0, N, kh, gs, cb, wcur);
  for (int c0 = 0; c0 < kend; c0 += kChunk) {
    const int clen = min(kChunk, kh - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < mcount * kVecsPerRow; i += kThreads) {
      const int m = i / kVecsPerRow;
      const int c = (i - m * kVecsPerRow) * kVec;
      if (c < clen) {
        const T* row = x + static_cast<size_t>(m0 + m) * K + c0 + c;
        *reinterpret_cast<uint4*>(&xs[0][m][c]) = *reinterpret_cast<const uint4*>(row);
        *reinterpret_cast<uint4*>(&xs[1][m][c]) = *reinterpret_cast<const uint4*>(row + kh);
      }
    }
    uint4 wnext[kRowsPerWarp];
    load_weights_pg(w, n0, N, kh, gs, c0 + kChunk + cb, wnext);
    __syncthreads();

    if (cb < clen) {
      const int g = (c0 + cb) / gs;
      // X_lo, X_hi: the sums of this lane's 16 columns of each half, per x row
      float xsum[2][MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        xsum[0][m] = 0.f;
        xsum[1][m] = 0.f;
        if (m < mcount) {
          float xl[16], xh[16];
          load16(&xs[0][m][cb], xl);
          load16(&xs[1][m][cb], xh);
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            xsum[0][m] += xl[j];
            xsum[1][m] += xh[j];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int n = n0 + r;
        if (n < N) {
          const float s_lo = s[static_cast<size_t>(n) * 2 * gh + g];
          const float s_hi = s[static_cast<size_t>(n) * 2 * gh + gh + g];
          const float z_lo = z[static_cast<size_t>(n) * 2 * gh + g];
          const float z_hi = z[static_cast<size_t>(n) * 2 * gh + gh + g];
          const float a_lo = s_lo, a_hi = s_hi * 0.0625f;
          const float c_lo = -s_lo * z_lo, c_hi = s_hi * (8.f - z_hi);
          const uint32_t words[4] = {wcur[r].x, wcur[r].y, wcur[r].z, wcur[r].w};
          float lo[16], hi[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const uint32_t p = (words[j >> 2] >> (8 * (j & 3))) & 0xFFu;
            lo[j] = static_cast<float>(p & 0xFu);
            hi[j] = static_cast<float>(static_cast<int8_t>(p & 0xF0u));  // 16 * (q_hi - 8)
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < mcount) {
              float xl[16], xh[16];
              load16(&xs[0][m][cb], xl);
              load16(&xs[1][m][cb], xh);
              float plo = 0.f, phi = 0.f;
#pragma unroll
              for (int j = 0; j < 16; ++j) {
                plo = fmaf(lo[j], xl[j], plo);
                phi = fmaf(hi[j], xh[j], phi);
              }
              float a = acc[r][m];
              a = fmaf(a_lo, plo, a);
              a = fmaf(c_lo, xsum[0][m], a);
              a = fmaf(a_hi, phi, a);
              a = fmaf(c_hi, xsum[1][m], a);
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
        y[static_cast<size_t>(m0 + m) * N + n] = from_float<T>(v);
      }
    }
  }
}

// xq [M, K] int8 with scales sx [M]; the rest as int4_pg_rows_kernel; y in
// Tout. Requires K % 32 == 0, gs % 16 == 0, gs | K/2, xq 16-byte aligned,
// tile_m % 16 == 0.
template <typename Tout>
__global__ void __launch_bounds__(kThreads) int4_pg_a8_rows_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx,
    const uint8_t* __restrict__ packed, const float* __restrict__ scales,
    const float* __restrict__ zps, const int32_t* __restrict__ gids, int tile_m,
    const int32_t* __restrict__ rows_used, Tout* __restrict__ y, int M, int N, int K, int gs) {
  constexpr int MT = kA8Mt;
  __shared__ __align__(16) int8_t xs[2][MT][kChunk];

  const int kh = K / 2;
  const int gh = kh / gs;
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, M - m0);
  const int mcount = rows_used != nullptr ? min(mrows, rows_used[blockIdx.y]) : mrows;
  const int expert = gids != nullptr ? gids[m0 / tile_m] : 0;
  const uint8_t* w = packed + static_cast<size_t>(expert) * N * kh;
  const float* s = scales + static_cast<size_t>(expert) * N * 2 * gh;
  const float* z = zps + static_cast<size_t>(expert) * N * 2 * gh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kRowsPerCta + warp * kRowsPerWarp;
  const int cb = lane * 16;

  float acc[kRowsPerWarp][MT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;
  }

  const int kend = mcount > 0 ? kh : 0;
  const bool has_rows = n0 < N;  // warp-uniform
  uint4 wcur[kRowsPerWarp] = {};
  if (kend > 0) load_weights_pg(w, n0, N, kh, gs, cb, wcur);
  for (int c0 = 0; c0 < kend; c0 += kChunk) {
    const int clen = min(kChunk, kh - c0);
    __syncthreads();  // the previous chunk is consumed
    if (cb < clen) {
#pragma unroll
      for (int i = 0; i < kA8RowsPerWarp; ++i) {
        const int m = warp + i * kWarps;
        if (m < mcount) {
          const int8_t* row = xq + static_cast<size_t>(m0 + m) * K + c0 + cb;
          *reinterpret_cast<uint4*>(&xs[0][m][cb]) = *reinterpret_cast<const uint4*>(row);
          *reinterpret_cast<uint4*>(&xs[1][m][cb]) = *reinterpret_cast<const uint4*>(row + kh);
        }
      }
    }
    uint4 wnext[kRowsPerWarp];
    load_weights_pg(w, n0, N, kh, gs, c0 + kChunk + cb, wnext);
    __syncthreads();

    if (has_rows && cb < clen) {
      const int g = (c0 + cb) / gs;
      // codes of the lane's 16 columns of each half, 4 per word, and the fold
      // constants of its group (0 for rows past N: their bytes are 0 too)
      uint32_t lo[kRowsPerWarp][4], hi[kRowsPerWarp][4];
      float a_lo[kRowsPerWarp], c_lo[kRowsPerWarp], a_hi[kRowsPerWarp], c_hi[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const uint32_t words[4] = {wcur[r].x, wcur[r].y, wcur[r].z, wcur[r].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[r][j] = words[j] & 0x0F0F0F0Fu;
          hi[r][j] = ((words[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        }
        a_lo[r] = c_lo[r] = a_hi[r] = c_hi[r] = 0.f;
        const int n = n0 + r;
        if (n < N) {
          const size_t row = static_cast<size_t>(n) * 2 * gh;
          const float s_lo = s[row + g], s_hi = s[row + gh + g];
          a_lo[r] = s_lo;
          c_lo[r] = __fmul_rn(-s_lo, z[row + g]);
          a_hi[r] = __fmul_rn(s_hi, 0.0625f);
          c_hi[r] = __fmul_rn(s_hi, __fsub_rn(8.f, z[row + gh + g]));
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
          int xsl = 0, xsh = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            xsl = __dp4a(xlw[j], 0x01010101, xsl);
            xsh = __dp4a(xhw[j], 0x01010101, xsh);
          }
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            int plo = 0, qhi = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              plo = __dp4a(xlw[j], static_cast<int>(lo[r][j]), plo);
              qhi = __dp4a(xhw[j], static_cast<int>(hi[r][j]), qhi);
            }
            const int phi = 16 * (qhi - 8 * xsh);  // sum xq_hi * vhi
            float a = acc[r][m];
            a = __fadd_rn(a, __fmul_rn(a_lo[r], static_cast<float>(plo)));
            a = __fadd_rn(a, __fmul_rn(c_lo[r], static_cast<float>(xsl)));
            a = __fadd_rn(a, __fmul_rn(a_hi[r], static_cast<float>(phi)));
            a = __fadd_rn(a, __fmul_rn(c_hi[r], static_cast<float>(xsh)));
            acc[r][m] = a;
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
      const float v = warp_sum(acc[r][m]);  // xor butterfly: the same sum on every lane
      if (lane == 0 && n < N && m < mrows) {
        const float out = m < mcount ? __fmul_rn(v, sx[m0 + m]) : 0.f;
        y[static_cast<size_t>(m0 + m) * N + n] = from_float<Tout>(out);
      }
    }
  }
}

// Launch on `stream`. With rows_used != nullptr (scratch of ceil(M / MT)
// ints) a first pass finds the zero rows at the end of each block of MT rows;
// the main kernel neither computes them nor streams weights for an all-zero
// block, and writes their outputs as 0.
template <typename T>
int launch_int4_pg_rows(const void* x, const void* packed, const void* scales,
                        const void* zps, const void* gids, int tile_m, void* rows_used,
                        void* y, int M, int N, int K, int gs, void* stream) {
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
  int4_pg_rows_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(zps),
      static_cast<const int32_t*>(gids), tile_m, static_cast<const int32_t*>(rows_used),
      static_cast<T*>(y), M, N, K, gs);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tout>
int launch_int4_pg_a8_rows(const void* xq, const void* sx, const void* packed,
                           const void* scales, const void* zps, const void* gids, int tile_m,
                           void* rows_used, void* y, int M, int N, int K, int gs,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (M + kA8Mt - 1) / kA8Mt;
  if (rows_used != nullptr) {
    rows_in_use_kernel<int8_t, kA8Mt><<<blocks, kThreads, 0, st>>>(
        static_cast<const int8_t*>(xq), M, K, static_cast<int32_t*>(rows_used));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + kRowsPerCta - 1) / kRowsPerCta, blocks);
  int4_pg_a8_rows_kernel<Tout><<<grid, kThreads, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
      static_cast<const float*>(zps), static_cast<const int32_t*>(gids), tile_m,
      static_cast<const int32_t*>(rows_used), static_cast<Tout*>(y), M, N, K, gs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace f4b
