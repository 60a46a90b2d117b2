// K3 and K3': flash attention straight over the pair-packed INT4 KV cache,
// for decode (one query per row) and chunked prefill (T queries per row), on
// the contiguous cache (K3) or on a page pool through a page table (K3').
//
// Replaces the TPU kernel fused4bit_tpu/ops/decode_attention.py:_attn_kernel,
// which the JAX package runs under two call sites: _attn_call (contiguous)
// and _paged_attn_call (paged). Here too one kernel body serves both: it is
// templated on an addressing policy that says where a tile of positions lies,
// so the online softmax, the masks and the tile order are one piece of code,
// and K3' on a pool whose pages hold a contiguous cache's bytes gives K3's
// result bit for bit.
//
// Layouts, unchanged from the JAX package. Contiguous: packed [B, Hkv, S/2, D]
// u8, byte (s', d) holds position 2s' in its low nibble and position 2s'+1,
// XOR 8, in its high nibble; scales and zero points [B, Hkv, S] f32 per
// position. Paged: the same per page, packed [P, Hkv, page/2, D] and planes
// [P, Hkv, page]; logical position s of batch row b lies in physical page
// table[b, s / page] at offset s % page. The paged policy looks the page up
// once per tile of 32 positions, so a tile never straddles two pages
// (page % 32 == 0, checked by the wrapper), and it reads the packed bytes and
// the four scale planes through the table. (The TPU kernel takes the planes
// pre-gathered to a logical row per call and layer because of a Mosaic
// block-shape rule; nothing here needs that gather.)
//
// One CTA per (batch row, kv head, query tile). A query tile holds QT query
// positions times the G query heads of the kv head: rows r = (t, g), t-major,
// at most 16 rows. The CTA walks the cache in tiles of 32 positions up to
// min(length, last query position + 1): a tile never starts past that end, so
// a row never reads a page its table parks at page 0 beyond its length. Per
// tile it unpacks K and V into shared memory: K dequantized ((code - zp) *
// scale, each position with its own scale and zp), V as centered codes
// (code - zp). The kernel reads true positions, so no evens|odds permutation
// is needed. Each warp then takes its rows: lane j scores position s0 + j,
// the causal mask (position <= the row's query position, position < length)
// is applied on true positions, and the online-softmax recurrence
//   m' = max(m, max_j s_j),  l' = exp(m - m') l + sum_j exp(s_j - m'),
//   acc' = exp(m - m') acc + sum_j ps_j (c_j - z_j),  ps_j = exp(s_j - m') s_j^v
// runs in f32 registers (each lane owns D/32 channels of acc). As in the TPU
// kernel's numerics contract, ps_j is rounded once to the query dtype before
// the PV product (identity in f32). Masked entries contribute exactly 0, and
// a row that saw no valid entry has l = 0 and writes 0.
//
// What bounds it on the H100: a decode step reads the packed cache once,
// about 1 byte per (position, channel) for K and V together plus 16 bytes of
// scales per position and head, against ~4 flops per byte: bound by HBM bytes.
// The design keeps the cache packed in HBM and unpacks it in shared memory;
// it reads each byte once per CTA. Split-S across CTAs (flash-decoding) for
// long contexts at small batch, and cp.async/TMA page loads, are later work.
#include "common.cuh"

namespace f4b {
namespace {

constexpr int kAttnWarps = 4;
constexpr int kAttnThreads = kAttnWarps * 32;
constexpr int kSTile = 32;   // cache positions per tile: one per lane
constexpr int kMaxRows = 16; // query rows per CTA
constexpr int kRowsPerAttnWarp = kMaxRows / kAttnWarps;
constexpr float kNegInf = -1e30f;

// Where the tile of positions [s0, s0 + 32) of (batch row b, kv head kv)
// lies: the index of its first entry in the scale planes and of its first
// packed byte row (rows of D bytes) in the codes.
struct TileAddr {
  size_t plane;
  size_t packed_row;
};

// K3: each (b, kv) owns S positions.
struct ContiguousCache {
  int S;
  __device__ __forceinline__ TileAddr tile(int b, int kv, int Hkv, int s0) const {
    const size_t bk = static_cast<size_t>(b) * Hkv + kv;
    return {bk * S + s0, bk * (S / 2) + s0 / 2};
  }
};

// K3': positions live in pages of the pool, found through the batch row's
// own table row.
struct PagedCache {
  const int32_t* table;  // [B, max_pages]
  int page;
  int max_pages;
  __device__ __forceinline__ TileAddr tile(int b, int kv, int Hkv, int s0) const {
    const int lp = s0 / page;
    const int off = s0 - lp * page;
    const size_t pk = static_cast<size_t>(table[b * max_pages + lp]) * Hkv + kv;
    return {pk * page + off, pk * (page / 2) + off / 2};
  }
};

template <typename T, int D, typename Cache>
__global__ void __launch_bounds__(kAttnThreads) int4_attention_kernel(
    const T* __restrict__ q,          // [B, Hkv*G, Tq, D]
    const uint8_t* __restrict__ kp,   // codes, laid out as Cache says
    const float* __restrict__ ks, const float* __restrict__ kz,  // planes
    const uint8_t* __restrict__ vp,
    const float* __restrict__ vs, const float* __restrict__ vz,
    const int32_t* __restrict__ lengths,  // [B]
    const int32_t* __restrict__ starts,   // [B] position of each row's first query
    T* __restrict__ out,              // [B, Hkv*G, Tq, D]
    Cache cache, int Hkv, int G, int Tq, int S, int QT) {  // S: logical positions per row
  constexpr int DL = D / 32;  // channels per lane
  __shared__ float qs[kMaxRows][D];
  __shared__ float kt[kSTile][D + 1];  // +1: lane j reads row j without bank conflicts
  __shared__ float vt[kSTile][D];      // centered V codes, code - zp
  __shared__ float sc[4][kSTile];      // k scale, k zp, v scale, v zp of the tile

  const int bk = blockIdx.x;  // b * Hkv + kv
  const int b = bk / Hkv;
  const int kv = bk - b * Hkv;
  const int hq = Hkv * G;
  const int t0 = blockIdx.y * QT;
  const int nq = min(QT, Tq - t0);
  const int rows = nq * G;
  const int length = lengths[b];
  const int qstart = starts[b];
  const int s_end = min(min(length, qstart + t0 + nq), S);  // last query position + 1
  const float sm_scale = 1.f / sqrtf(static_cast<float>(D));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < rows * D; i += kAttnThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int h = kv * G + r % G;
    const int t = t0 + r / G;
    qs[r][d] = to_float(q[((static_cast<size_t>(b) * hq + h) * Tq + t) * D + d]) * sm_scale;
  }

  float m_run[kRowsPerAttnWarp], l_run[kRowsPerAttnWarp], acc[kRowsPerAttnWarp][DL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerAttnWarp; ++rr) {
    m_run[rr] = kNegInf;
    l_run[rr] = 0.f;
#pragma unroll
    for (int dl = 0; dl < DL; ++dl) acc[rr][dl] = 0.f;
  }

  for (int s0 = 0; s0 < s_end; s0 += kSTile) {
    const TileAddr at = cache.tile(b, kv, Hkv, s0);
    __syncthreads();  // the previous tile is consumed (and q is staged)
    if (threadIdx.x < kSTile) {
      const bool in = s0 + threadIdx.x < S;
      const size_t i = at.plane + threadIdx.x;
      sc[0][threadIdx.x] = in ? ks[i] : 0.f;
      sc[1][threadIdx.x] = in ? kz[i] : 0.f;
      sc[2][threadIdx.x] = in ? vs[i] : 0.f;
      sc[3][threadIdx.x] = in ? vz[i] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < (kSTile / 2) * D; i += kAttnThreads) {
      const int pr = i / D;  // packed row in the tile: positions 2pr, 2pr+1
      const int d = i - pr * D;
      uint32_t kb = 0, vb = 0;
      if (s0 / 2 + pr < S / 2) {
        const size_t at_byte = (at.packed_row + pr) * D + d;
        kb = kp[at_byte];
        vb = vp[at_byte];
      }
      const int e = 2 * pr;
      const int o = e + 1;
      kt[e][d] = (static_cast<float>(kb & 0xFu) - sc[1][e]) * sc[0][e];
      kt[o][d] = (static_cast<float>((kb >> 4) ^ 8u) - sc[1][o]) * sc[0][o];
      vt[e][d] = static_cast<float>(vb & 0xFu) - sc[3][e];
      vt[o][d] = static_cast<float>((vb >> 4) ^ 8u) - sc[3][o];
    }
    __syncthreads();

    const int pos = s0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerAttnWarp; ++rr) {
      const int r = warp + rr * kAttnWarps;
      if (r < rows) {  // uniform across the warp
        const int qpos = qstart + t0 + r / G;
        const bool valid = pos < length && pos <= qpos;
        float score = kNegInf;
        if (valid) {
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) dot = fmaf(qs[r][d], kt[lane][d], dot);
          score = dot;
        }
        const float m_new = fmaxf(m_run[rr], warp_max(score));
        const float alpha = expf(m_run[rr] - m_new);
        const float p = valid ? expf(score - m_new) : 0.f;
        l_run[rr] = alpha * l_run[rr] + warp_sum(p);
        const float ps = round_to<T>(p * sc[2][lane]);
#pragma unroll
        for (int dl = 0; dl < DL; ++dl) acc[rr][dl] *= alpha;
#pragma unroll 4
        for (int j = 0; j < kSTile; ++j) {
          const float pj = __shfl_sync(0xffffffffu, ps, j);
#pragma unroll
          for (int dl = 0; dl < DL; ++dl) acc[rr][dl] = fmaf(pj, vt[j][lane + 32 * dl], acc[rr][dl]);
        }
        m_run[rr] = m_new;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerAttnWarp; ++rr) {
    const int r = warp + rr * kAttnWarps;
    if (r < rows) {
      const int h = kv * G + r % G;
      const int t = t0 + r / G;
      const float inv = l_run[rr] > 0.f ? 1.f / l_run[rr] : 0.f;
      T* o = out + ((static_cast<size_t>(b) * hq + h) * Tq + t) * D;
#pragma unroll
      for (int dl = 0; dl < DL; ++dl) o[lane + 32 * dl] = from_float<T>(acc[rr][dl] * inv);
    }
  }
}

template <typename T, int D, typename Cache>
int launch_attention(const void* q, const void* kp, const void* ks, const void* kz,
                     const void* vp, const void* vs, const void* vz,
                     const void* lengths, const void* starts, void* out, Cache cache,
                     int B, int Hkv, int G, int Tq, int S, int QT, void* stream) {
  const dim3 grid(B * Hkv, (Tq + QT - 1) / QT);
  int4_attention_kernel<T, D, Cache>
      <<<grid, kAttnThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const uint8_t*>(kp),
          static_cast<const float*>(ks), static_cast<const float*>(kz),
          static_cast<const uint8_t*>(vp), static_cast<const float*>(vs),
          static_cast<const float*>(vz), static_cast<const int32_t*>(lengths),
          static_cast<const int32_t*>(starts), static_cast<T*>(out), cache, Hkv, G, Tq, S,
          QT);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Cache>
int dispatch_attention(const void* q, const void* kp, const void* ks, const void* kz,
                       const void* vp, const void* vs, const void* vz,
                       const void* lengths, const void* starts, void* out, Cache cache,
                       int B, int Hkv, int G, int Tq, int S, int D, int QT, void* stream) {
  if (QT * G > kMaxRows || QT < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch_attention<T, 64>(q, kp, ks, kz, vp, vs, vz, lengths, starts, out, cache,
                                   B, Hkv, G, Tq, S, QT, stream);
  if (D == 128)
    return launch_attention<T, 128>(q, kp, ks, kz, vp, vs, vz, lengths, starts, out, cache,
                                    B, Hkv, G, Tq, S, QT, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_paged(const void* q, const void* kp, const void* ks, const void* kz,
                   const void* vp, const void* vs, const void* vz, const void* table,
                   const void* lengths, const void* starts, void* out, int B, int Hkv,
                   int G, int Tq, int page, int max_pages, int D, int QT, void* stream) {
  if (page % kSTile != 0 || page <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const PagedCache cache{static_cast<const int32_t*>(table), page, max_pages};
  return dispatch_attention<T>(q, kp, ks, kz, vp, vs, vz, lengths, starts, out, cache, B,
                               Hkv, G, Tq, page * max_pages, D, QT, stream);
}

}  // namespace
}  // namespace f4b

extern "C" int f4b_int4_attention_bf16(const void* q, const void* kp, const void* ks,
                                       const void* kz, const void* vp, const void* vs,
                                       const void* vz, const void* lengths,
                                       const void* starts, void* out, int B, int Hkv,
                                       int G, int Tq, int S, int D, int QT,
                                       void* stream) {
  return f4b::dispatch_attention<__nv_bfloat16>(q, kp, ks, kz, vp, vs, vz, lengths, starts,
                                                out, f4b::ContiguousCache{S}, B, Hkv, G, Tq,
                                                S, D, QT, stream);
}

extern "C" int f4b_int4_attention_f32(const void* q, const void* kp, const void* ks,
                                      const void* kz, const void* vp, const void* vs,
                                      const void* vz, const void* lengths,
                                      const void* starts, void* out, int B, int Hkv,
                                      int G, int Tq, int S, int D, int QT,
                                      void* stream) {
  return f4b::dispatch_attention<float>(q, kp, ks, kz, vp, vs, vz, lengths, starts, out,
                                        f4b::ContiguousCache{S}, B, Hkv, G, Tq, S, D, QT,
                                        stream);
}

extern "C" int f4b_paged_int4_attention_bf16(const void* q, const void* kp, const void* ks,
                                             const void* kz, const void* vp, const void* vs,
                                             const void* vz, const void* table,
                                             const void* lengths, const void* starts,
                                             void* out, int B, int Hkv, int G, int Tq,
                                             int page, int max_pages, int D, int QT,
                                             void* stream) {
  return f4b::dispatch_paged<__nv_bfloat16>(q, kp, ks, kz, vp, vs, vz, table, lengths,
                                            starts, out, B, Hkv, G, Tq, page, max_pages, D,
                                            QT, stream);
}

extern "C" int f4b_paged_int4_attention_f32(const void* q, const void* kp, const void* ks,
                                            const void* kz, const void* vp, const void* vs,
                                            const void* vz, const void* table,
                                            const void* lengths, const void* starts,
                                            void* out, int B, int Hkv, int G, int Tq,
                                            int page, int max_pages, int D, int QT,
                                            void* stream) {
  return f4b::dispatch_paged<float>(q, kp, ks, kz, vp, vs, vz, table, lengths, starts, out,
                                    B, Hkv, G, Tq, page, max_pages, D, QT, stream);
}
