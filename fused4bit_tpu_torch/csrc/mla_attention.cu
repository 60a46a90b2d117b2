// K15: multi-head latent attention (MLA, DeepSeek-V3's) straight over the
// INT4 latent cache, in the absorbed form, for decode (one query per row)
// and chunked prefill (T queries per row).
//
// It replaces no TPU kernel: the JAX package has no latent attention. It was
// added because no kernel of the port computes MLA's attention: K3 reads
// per-head keys and values, while MLA caches one latent vector c_KV a position
// (kv_lora_rank = 512 wide) beside one RoPE key k_pe (64 wide) shared by every
// head. In the absorbed form each head's query is taken into latent space
// before the kernel (q_lat = W_UK^T q_nope, by the grouped matmul), so a
// score is q_lat . c_KV + q_pe . k_pe, and the output sum_s p c_KV is taken
// back by W_UV after it.
//
// Layouts. The latent cache is the KV cache's INT4 per-vector format with one
// head: codes [B, S/2, 512] u8, pair-packed along positions (byte (s', d)
// holds position 2s' in its low nibble and position 2s'+1, XOR 8, in its high
// nibble), a scale and a zero point [B, S] f32 per position, and k_pe
// [B, S, 64] bf16. q_lat and out are [H, rows, 512] bf16 with any head and row
// strides (rows b * T + t), q_pe [rows, H, 64] bf16 likewise.
//
// Arithmetic, as K3's: raw = q_lat . codes (bf16 q, the codes 0..15 exact in
// bf16, f32 sums), s = (raw * sc - qsum * sc * zp + q_pe . k_pe) * scale with
// qsum the f32 sum of the head's q_lat, the causal mask, an online softmax in
// f32, ps = bf16(p * sc) rounded once and feeding both the product with the
// raw codes and the zero-point correction sum(ps * zp); out = (ps . codes -
// sum(ps * zp)) / sum(p), the denominator over the unrounded p.
//
// What bounds it on the H100: per cached position 392 bytes (256 of codes, 8
// of scale and zero point, 128 of k_pe) against 128 heads x (576 + 512) x 2
// operations, about 710 operations a byte, above the card's ridge of ~295: it
// is bound by the tensor cores. What the design does about it, right and
// simple first:
//
// * A CTA holds 64 heads of one query row in the products' M, so a sequence's
//   128 heads read and dequantize each cached position twice (two CTAs side
//   by side in the grid, the second mostly from L2), not once a head. One CTA
//   does not take all 128: the f32 output of 128 heads x 512 would fill the
//   SM's whole register file.
// * 8 warps. For a block of 32 positions the CTA turns the packed codes into
//   bf16 code values in shared memory once (every warp reads them there), and
//   copies k_pe and the two planes; the next block's bytes are loaded into
//   registers while the current one is computed. Warp w takes heads
//   16 (w % 4) .. +16. For QK^T it takes positions 16 (w / 4) .. +16 of the
//   block over all 576 channels (mma.sync m16n8k16, ldmatrix from shared
//   memory); the two warps of a head group share their row maxima and sums
//   through shared memory, so both keep the same softmax state. For PV it
//   takes latent channels 256 (w / 4) .. +256 over the block's 32 positions:
//   its f32 accumulator is 16 heads x 256 channels, 128 registers a thread.
// * Split over positions with K3's fixed-order merge: segments of `seg`
//   positions from ops.mla_attention._mla_segment, which reads the cache's
//   capacity alone, never B, T or the lengths. With Z > 1 segments each CTA
//   writes f32 partials (m, l, acc) and a second kernel merges them in order
//   z = 0, 1, ...; no float atomics. A segment with no valid position writes
//   m = -1e30, l = 0, acc = 0 and merges as an exact identity. So a query
//   row's output does not depend on T or on the other rows: the decode row at
//   position p equals the row at p of a chunked prefill bit for bit.
#include "common.cuh"

namespace f4b {
namespace {

constexpr int kMlaL = 512;                       // latent width (kv_lora_rank)
constexpr int kMlaR = 64;                        // RoPE key width (qk_rope_head_dim)
constexpr int kMlaHeads = 64;                    // heads per CTA
constexpr int kMlaWarps = 8;
constexpr int kMlaThreads = kMlaWarps * 32;
constexpr int kMlaBlock = 32;                    // positions per block of the walk
constexpr int kMlaSplit = 16;                    // positions a warp scores per block
constexpr int kMlaDims = kMlaL / 2;              // latent channels a warp accumulates
constexpr float kMlaNegInf = -1e30f;
// Shared memory rows, in bf16 elements, each padded by 16 bytes so that the 8
// rows of an ldmatrix land in distinct 16-byte bank groups.
constexpr int kQStride = kMlaL + kMlaR + 8;      // q_lat | q_pe of a head
constexpr int kCStride = kMlaL + 8;              // code values of a position
constexpr int kPeStride = kMlaR + 8;             // k_pe of a position
constexpr int kPStride = kMlaBlock + 8;          // ps of a head
constexpr int kSmemBytes =
    2 * (kMlaHeads * kQStride + kMlaBlock * kCStride + kMlaBlock * kPeStride +
         kMlaHeads * kPStride) +
    4 * (2 * kMlaBlock + 3 * 2 * kMlaHeads + kMlaHeads);

struct MlaArgs {
  const __nv_bfloat16* q_lat;   // [H, rows, L] with strides ql_sh, ql_sr
  const __nv_bfloat16* q_pe;    // [rows, H, R] with strides qp_sr, qp_sh
  const uint8_t* packed;        // [B, S/2, L]
  const float* scale;           // [B, S]
  const float* zp;              // [B, S]
  const __nv_bfloat16* kpe;     // [B, S, R]
  const int32_t* lengths;       // [B]
  const int32_t* starts;        // [B] the position of each row's first query
  __nv_bfloat16* out;           // [H, rows, L] with strides out_sh, out_sr
  float* partial;               // Z > 1: acc [Z, H, rows, L], then m and l [Z, H, rows]
  int B, T, H, S;
  int ql_sh, ql_sr, qp_sr, qp_sh, out_sh, out_sr;
  int seg, Z;
  float scale_sm;               // the softmax's scale
};

__device__ __forceinline__ uint32_t mla_minus128(uint32_t v) {
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&v);
  const uint32_t k = 0x43004300u;
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&k);
  __nv_bfloat162 r = __hsub2(a, b);
  return *reinterpret_cast<uint32_t*>(&r);
}

// Bytes 0 and 2 of r as bf16 code values: lo = their low nibbles (the even
// position's codes), hi = their high nibbles XOR 8 (the odd position's).
__device__ __forceinline__ void mla_code_pairs(uint32_t r, uint32_t& lo, uint32_t& hi) {
  lo = mla_minus128((r & 0x000F000Fu) | 0x43004300u);
  hi = mla_minus128(((r >> 4) & 0x000F000Fu) ^ 0x43084308u);
}

__device__ __forceinline__ void mla_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The bytes of one block of 32 positions that a thread carries from device
// memory to shared memory: two 16-byte pieces of the packed codes, one of
// k_pe, and (threads 0-63) one value of the scale or zero-point plane.
struct MlaBlockRegs {
  uint4 codes[2];
  uint4 pe;
  float plane;
};

__device__ __forceinline__ void mla_load(const MlaArgs& p, int b, int pos0, MlaBlockRegs& r) {
  const int tid = threadIdx.x;
  const uint4* codes = reinterpret_cast<const uint4*>(
      p.packed + (static_cast<size_t>(b) * (p.S / 2) + pos0 / 2) * kMlaL);
  r.codes[0] = codes[tid];
  r.codes[1] = codes[tid + kMlaThreads];
  r.pe = reinterpret_cast<const uint4*>(p.kpe + (static_cast<size_t>(b) * p.S + pos0) * kMlaR)[tid];
  const size_t plane = static_cast<size_t>(b) * p.S + pos0 + (tid & 31);
  r.plane = tid < 32 ? p.scale[plane] : (tid < 64 ? p.zp[plane] : 0.f);
}

// The block's code values (bf16, two positions from each packed byte), k_pe
// and planes into shared memory.
__device__ __forceinline__ void mla_store(const MlaBlockRegs& r, __nv_bfloat16* sC,
                                          __nv_bfloat16* sPe, float* sSc, float* sZp) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int piece = tid + i * kMlaThreads;       // of 16 rows x 32 pieces of 16 bytes
    const int row = piece >> 5, d0 = (piece & 31) * 16;
    const uint32_t w[4] = {r.codes[i].x, r.codes[i].y, r.codes[i].z, r.codes[i].w};
    uint32_t even[8], odd[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // bytes (0, 1) and (2, 3) of the word to bytes 0 and 2: channel pairs
      mla_code_pairs(__byte_perm(w[j], 0, 0x3120), even[2 * j], odd[2 * j]);
      mla_code_pairs(__byte_perm(w[j], 0, 0x3302), even[2 * j + 1], odd[2 * j + 1]);
    }
    uint4* de = reinterpret_cast<uint4*>(sC + (2 * row) * kCStride + d0);
    uint4* dodd = reinterpret_cast<uint4*>(sC + (2 * row + 1) * kCStride + d0);
    de[0] = make_uint4(even[0], even[1], even[2], even[3]);
    de[1] = make_uint4(even[4], even[5], even[6], even[7]);
    dodd[0] = make_uint4(odd[0], odd[1], odd[2], odd[3]);
    dodd[1] = make_uint4(odd[4], odd[5], odd[6], odd[7]);
  }
  const int pos = tid >> 3, piece = tid & 7;       // 32 positions x 8 pieces of k_pe
  *reinterpret_cast<uint4*>(sPe + pos * kPeStride + piece * 8) = r.pe;
  if (tid < 32) sSc[tid] = r.plane;
  else if (tid < 64) sZp[tid - 32] = r.plane;
}

__global__ void __launch_bounds__(kMlaThreads, 1) mla_attention_kernel(const MlaArgs p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sC = sQ + kMlaHeads * kQStride;
  __nv_bfloat16* sPe = sC + kMlaBlock * kCStride;
  __nv_bfloat16* sP = sPe + kMlaBlock * kPeStride;
  float* sSc = reinterpret_cast<float*>(sP + kMlaHeads * kPStride);
  float* sZp = sSc + kMlaBlock;
  float* sMax = sZp + kMlaBlock;                   // [2][64]: each warp half's row maxima
  float* sSum = sMax + 2 * kMlaHeads;              // [2][64]: sums of p
  float* sZs = sSum + 2 * kMlaHeads;               // [2][64]: sums of ps * zp
  float* sQsum = sZs + 2 * kMlaHeads;              // [64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int hg = warp & 3, half = warp >> 2;
  const int h0 = blockIdx.x * kMlaHeads;
  const int row = blockIdx.y;
  const int z = blockIdx.z;
  const int b = row / p.T, t = row - b * p.T;
  const int limit = min(min(p.lengths[b], p.starts[b] + t + 1), p.S);
  const int s0 = z * p.seg;
  const int s1 = min(s0 + p.seg, limit);
  const int nblocks = s1 > s0 ? (s1 - s0 + kMlaBlock - 1) / kMlaBlock : 0;

  // q_lat | q_pe of the CTA's 64 heads into shared memory: 72 pieces a head
  for (int i = tid; i < kMlaHeads * 72; i += kMlaThreads) {
    const int h = i / 72, piece = i - h * 72;
    const uint4* src =
        piece < 64
            ? reinterpret_cast<const uint4*>(p.q_lat + static_cast<size_t>(h0 + h) * p.ql_sh +
                                             static_cast<size_t>(row) * p.ql_sr + piece * 8)
            : reinterpret_cast<const uint4*>(p.q_pe + static_cast<size_t>(row) * p.qp_sr +
                                             static_cast<size_t>(h0 + h) * p.qp_sh +
                                             (piece - 64) * 8);
    *reinterpret_cast<uint4*>(sQ + h * kQStride + piece * 8) = *src;
  }
  MlaBlockRegs next;
  if (nblocks > 0) mla_load(p, b, s0, next);
  __syncthreads();
  // qsum: warp w sums heads 8w .. 8w + 7 in a fixed order
  for (int i = 0; i < 8; ++i) {
    const int h = warp * 8 + i;
    float acc = 0.f;
    for (int d = lane; d < kMlaL; d += 32) acc += __bfloat162float(sQ[h * kQStride + d]);
    acc = warp_sum(acc);
    if (lane == 0) sQsum[h] = acc;
  }

  // this lane's heads (local): rows g and g + 8 of the warp's m16 tile
  const int hr[2] = {hg * 16 + g, hg * 16 + g + 8};
  float m[2] = {kMlaNegInf, kMlaNegInf}, l[2] = {0.f, 0.f}, zs[2] = {0.f, 0.f};
  float acc[kMlaDims / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMlaDims / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  // ldmatrix row addresses: A (16 heads x 16 channels), B of QK^T (16
  // positions x 16 channels, non-transposed), B of PV (16 positions x 16
  // channels, transposed)
  const int a_row = hg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int bq_pos = half * kMlaSplit + (lane & 7) + (lane >> 4) * 8;
  const int bq_col = ((lane >> 3) & 1) * 8;
  const int bv_pos = (lane & 7) + ((lane >> 3) & 1) * 8, bv_col = (lane >> 4) * 8;

  for (int blk = 0; blk < nblocks; ++blk) {
    const int pos0 = s0 + blk * kMlaBlock;
    mla_store(next, sC, sPe, sSc, sZp);
    if (blk + 1 < nblocks) mla_load(p, b, pos0 + kMlaBlock, next);
    __syncthreads();

    // S = q_lat . codes and q_pe . k_pe for 16 heads x 16 positions
    float raw[2][4] = {}, pe[2][4] = {};
#pragma unroll 8
    for (int j = 0; j < kMlaL / 16; ++j) {
      uint32_t a[4], bb[4];
      ldsm_x4(a, sQ + a_row * kQStride + 16 * j + a_col);
      ldsm_x4(bb, sC + bq_pos * kCStride + 16 * j + bq_col);
      mla_mma(raw[0], a, bb[0], bb[1]);
      mla_mma(raw[1], a, bb[2], bb[3]);
    }
#pragma unroll
    for (int j = 0; j < kMlaR / 16; ++j) {
      uint32_t a[4], bb[4];
      ldsm_x4(a, sQ + a_row * kQStride + kMlaL + 16 * j + a_col);
      ldsm_x4(bb, sPe + bq_pos * kPeStride + 16 * j + bq_col);
      mla_mma(pe[0], a, bb[0], bb[1]);
      mla_mma(pe[1], a, bb[2], bb[3]);
    }
    float s[2][4];
    float bmax[2] = {kMlaNegInf, kMlaNegInf};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lp = half * kMlaSplit + nt * 8 + 2 * c + (e & 1);   // position in the block
        const int r = e >> 1;
        const float sc = sSc[lp];
        float v = (raw[nt][e] * sc - sQsum[hr[r]] * (sc * sZp[lp]) + pe[nt][e]) * p.scale_sm;
        if (pos0 + lp >= s1) v = kMlaNegInf;
        s[nt][e] = v;
        bmax[r] = fmaxf(bmax[r], v);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bmax[r] = fmaxf(bmax[r], __shfl_xor_sync(0xffffffffu, bmax[r], 1));
      bmax[r] = fmaxf(bmax[r], __shfl_xor_sync(0xffffffffu, bmax[r], 2));
      if (c == 0) sMax[half * kMlaHeads + hr[r]] = bmax[r];
    }
    __syncthreads();
    float m_new[2], alpha[2], psum[2] = {0.f, 0.f}, pzs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m[r], fmaxf(sMax[hr[r]], sMax[kMlaHeads + hr[r]]));
      alpha[r] = expf(m[r] - m_new[r]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int lp = half * kMlaSplit + nt * 8 + 2 * c;
        const int r = e >> 1;
        const float p0 = __expf(s[nt][e] - m_new[r]), p1 = __expf(s[nt][e + 1] - m_new[r]);
        const __nv_bfloat162 ps = __floats2bfloat162_rn(p0 * sSc[lp], p1 * sSc[lp + 1]);
        *reinterpret_cast<__nv_bfloat162*>(sP + hr[r] * kPStride + lp) = ps;
        psum[r] += p0 + p1;
        pzs[r] = fmaf(__low2float(ps), sZp[lp], fmaf(__high2float(ps), sZp[lp + 1], pzs[r]));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      pzs[r] += __shfl_xor_sync(0xffffffffu, pzs[r], 1);
      pzs[r] += __shfl_xor_sync(0xffffffffu, pzs[r], 2);
      if (c == 0) {
        sSum[half * kMlaHeads + hr[r]] = psum[r];
        sZs[half * kMlaHeads + hr[r]] = pzs[r];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + (sSum[hr[r]] + sSum[kMlaHeads + hr[r]]);
      zs[r] = zs[r] * alpha[r] + (sZs[hr[r]] + sZs[kMlaHeads + hr[r]]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int nt = 0; nt < kMlaDims / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    // O += ps . codes over the block's 32 positions, channels 256 half .. +256
#pragma unroll
    for (int kk = 0; kk < kMlaBlock / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sP + a_row * kPStride + 16 * kk + a_col);
#pragma unroll
      for (int np = 0; np < kMlaDims / 16; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, sC + (16 * kk + bv_pos) * kCStride + half * kMlaDims + 16 * np + bv_col);
        mla_mma(acc[2 * np], a, bb[0], bb[1]);
        mla_mma(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();
  }

  // epilogue: the output, or this segment's partials
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = h0 + hr[r];
    if (p.Z == 1) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      __nv_bfloat16* o = p.out + static_cast<size_t>(h) * p.out_sh +
                         static_cast<size_t>(row) * p.out_sr + half * kMlaDims + 2 * c;
#pragma unroll
      for (int nt = 0; nt < kMlaDims / 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) = __floats2bfloat162_rn(
            (acc[nt][2 * r] - zs[r]) * inv, (acc[nt][2 * r + 1] - zs[r]) * inv);
    } else {
      const size_t rows = static_cast<size_t>(p.B) * p.T;
      const size_t hz = (static_cast<size_t>(z) * p.H + h) * rows + row;
      float* pa = p.partial + hz * kMlaL + half * kMlaDims + 2 * c;
#pragma unroll
      for (int nt = 0; nt < kMlaDims / 8; ++nt)
        *reinterpret_cast<float2*>(pa + nt * 8) =
            make_float2(acc[nt][2 * r] - zs[r], acc[nt][2 * r + 1] - zs[r]);
      if (half == 0 && c == 0) {
        float* ml = p.partial + static_cast<size_t>(p.Z) * p.H * rows * kMlaL;
        ml[hz] = m[r];
        ml[static_cast<size_t>(p.Z) * p.H * rows + hz] = l[r];
      }
    }
  }
}

// The second pass with Z > 1: a CTA of 128 threads per (head, row), 4
// channels a thread, merges the segments' partials in order z = 0, 1, ...
__global__ void __launch_bounds__(128) mla_attention_merge_kernel(const MlaArgs p) {
  const int h = blockIdx.x, row = blockIdx.y;
  const size_t rows = static_cast<size_t>(p.B) * p.T;
  const size_t zstride = static_cast<size_t>(p.H) * rows;
  const float* ml = p.partial + static_cast<size_t>(p.Z) * zstride * kMlaL;
  const size_t hr = static_cast<size_t>(h) * rows + row;
  float mx = kMlaNegInf;
  for (int z = 0; z < p.Z; ++z) mx = fmaxf(mx, ml[z * zstride + hr]);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  float L = 0.f;
  for (int z = 0; z < p.Z; ++z) {
    const float f = expf(ml[z * zstride + hr] - mx);
    const float4 a =
        reinterpret_cast<const float4*>(p.partial + (z * zstride + hr) * kMlaL)[threadIdx.x];
    v.x = fmaf(f, a.x, v.x);
    v.y = fmaf(f, a.y, v.y);
    v.z = fmaf(f, a.z, v.z);
    v.w = fmaf(f, a.w, v.w);
    L = fmaf(f, ml[(p.Z + z) * zstride + hr], L);
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
  __nv_bfloat16* o = p.out + static_cast<size_t>(h) * p.out_sh +
                     static_cast<size_t>(row) * p.out_sr + 4 * threadIdx.x;
  reinterpret_cast<__nv_bfloat162*>(o)[0] = __floats2bfloat162_rn(v.x * inv, v.y * inv);
  reinterpret_cast<__nv_bfloat162*>(o)[1] = __floats2bfloat162_rn(v.z * inv, v.w * inv);
}

}  // namespace
}  // namespace f4b

// K15, bf16. rows = B * T query rows (row b * T + t at position starts[b] + t);
// partial: f32 scratch of Z * H * rows * (L + 2) floats when Z > 1. Raises
// cudaErrorInvalidValue on a shape the kernel is not built for: H a multiple
// of 64, S of 32, seg of 32 with Z = ceil(S / seg).
extern "C" int f4b_mla_attention_bf16(const void* q_lat, const void* q_pe, const void* packed,
                                      const void* scale, const void* zp, const void* kpe,
                                      const void* lengths, const void* starts, void* out,
                                      void* partial, int B, int T, int H, int S, int ql_sh,
                                      int ql_sr, int qp_sr, int qp_sh, int out_sh, int out_sr,
                                      int seg, int Z, float scale_sm, void* stream) {
  using namespace f4b;
  if (H % kMlaHeads != 0 || S % kMlaBlock != 0 || seg % kMlaBlock != 0 || seg <= 0 || Z < 1 ||
      (S + seg - 1) / seg != Z || B * T > 65535 || Z > 65535 || (Z > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const MlaArgs p{static_cast<const __nv_bfloat16*>(q_lat), static_cast<const __nv_bfloat16*>(q_pe),
                  static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
                  static_cast<const float*>(zp), static_cast<const __nv_bfloat16*>(kpe),
                  static_cast<const int32_t*>(lengths), static_cast<const int32_t*>(starts),
                  static_cast<__nv_bfloat16*>(out), static_cast<float*>(partial),
                  B, T, H, S, ql_sh, ql_sr, qp_sr, qp_sh, out_sh, out_sr, seg, Z, scale_sm};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the dynamic shared memory each device allows the kernel, raised once
  constexpr int kDevices = 64;
  static bool raised[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(mla_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) raised[dev] = true;
  }
  const dim3 grid(H / kMlaHeads, B * T, Z);
  mla_attention_kernel<<<grid, kMlaThreads, kSmemBytes, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || Z == 1) return static_cast<int>(err);
  mla_attention_merge_kernel<<<dim3(H, B * T), 128, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
