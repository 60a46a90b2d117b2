// K3 and K3': flash attention straight over the pair-packed INT4 KV cache,
// for decode (one query per row) and chunked prefill (T queries per row), on
// the contiguous cache (K3) or on a page pool through a page table (K3').
//
// Replaces the TPU kernel fused4bit_tpu/ops/decode_attention.py:_attn_kernel,
// which the JAX package runs under two call sites: _attn_call (contiguous)
// and _paged_attn_call (paged). Here too one kernel body serves both: it is
// templated on an addressing policy that says where a unit of 32 positions
// lies, so the online softmax, the masks and the walk are one piece of code,
// and K3' on a pool whose pages hold a contiguous cache's bytes gives K3's
// result bit for bit.
//
// Layouts, unchanged from the JAX package. Contiguous: packed [B, Hkv, S/2, D]
// u8, byte (s', d) holds position 2s' in its low nibble and position 2s'+1,
// XOR 8, in its high nibble; scales and zero points [B, Hkv, S] f32 per
// position. Paged: the same per page, packed [P, Hkv, page/2, D] and planes
// [P, Hkv, page]; logical position s of batch row b lies in physical page
// table[b, s / page] at offset s % page. The paged policy looks the page up
// once per unit of 32 positions, so a unit never straddles two pages
// (page % 32 == 0, checked by the wrapper), and it reads the packed bytes and
// the four scale planes through the table. (The TPU kernel takes the planes
// pre-gathered to a logical row per call and layer because of a Mosaic
// block-shape rule; nothing here needs that gather.)
//
// Windows. A window layer's contiguous cache is a ring of S slots (ring = 1):
// position p lies in slot p % S, and every written slot is walked. With
// window > 0 a query at q_pos sees the keys at q_pos - window < k_pos <=
// q_pos, so a chunk's early queries still see the keys before the chunk. A
// call with neither runs the kernel it ran before windows existed
// (int4_attention_mma_kernel; a windowed call int4_attention_window_kernel,
// the same body with key_visible's mask): the same code, the same bits.
//
// bf16 queries run the tensor-core body below; f32 queries keep the
// CUDA-core body (int4_attention_rows_kernel), as f32 K1 keeps its CUDA-core
// loop: an f32 tensor-core product would be TF32.
//
// The tensor-core body computes the TPU kernel's arithmetic: per tile of
// positions, raw = q . codes (bf16 q, the codes 0..15 exact in bf16, f32
// sums: mma.sync m16n8k16), scores = (raw * ks - qsum * ks * kz) / sqrt(D)
// with qsum the f32 sum of q's row, the causal mask on true positions, an
// online softmax in f32, and ps = bf16(p * vs) rounded once, feeding both the
// PV product over the raw value codes (mma.sync again) and the zero-point
// correction sum(ps * vz), which is subtracted from every channel.
//
// What bounds it on the H100: a decode step reads the packed cache once,
// D bytes per position for K and V together plus 16 bytes of scale planes
// per position and head, against ~4 * G operations per byte: bound by HBM
// bytes (3.35 TB/s), a quarter of the bytes of attention over a bf16 cache.
// What the design does about it:
//
// * Split-S over fixed segments. Each row's positions are cut into
//   segments of `seg` positions (a multiple of 64), from the rule
//   ops.decode_attention._attn_segment(S, D, Hkv, SMs): it reads neither the
//   lengths nor T nor the batch. A CTA of 4 warps takes 4 consecutive
//   segments, one per warp, for one (batch row, kv head, query tile); grid z
//   walks the row in Z = ceil(S / (4 seg)) CTAs. Each warp runs its own
//   online softmax over its segment (blocks of 64 positions, the max and the
//   rescale once per block). The CTA merges its 4 segments through shared
//   memory in segment order: M = max m_w, then sum_w exp(m_w - M) * (l_w,
//   acc_w) in order w = 0, 1, 2, 3. With Z > 1 the CTAs write f32 partials
//   (M, L, acc) and a second kernel merges them the same way in order
//   z = 0, 1, ...; no float atomics. A segment with no valid position keeps
//   m = -1e30, l = 0, acc = 0 and merges as an exact identity (its factor
//   exp(-1e30 - M) is 0, the other sides' exp(0) is 1), and a block that is
//   all masked for a row leaves that row's state as it was (alpha 1, p 0).
//   So a query row's output does not depend on T, on its query tile or on
//   the other rows: the decode row at position p equals, bit for bit, the
//   row at p of a chunked prefill over the same cache (the self-draft
//   speculative verify at T = gamma + 1 relies on it).
// * Asynchronous loads. A warp walks its segment in blocks of 64 positions
//   with two buffers: the next block's packed K and V rows (16-byte
//   cp.async, 8 per packed row at D = 128) and its four scale planes
//   (8-byte cp.async) are in flight while it computes the current one.
//   Only units of 32 positions that start below the row's end are read
//   (the others are zero-filled), so no page beyond a row's length is read.
//   The codes stay packed in shared memory, their 16-byte columns XOR-
//   swizzled by row so the fragment loads are free of bank conflicts.
// * Tensor cores on the codes. Q is operand A (16 query rows = up to 4
//   positions x G = 4 heads, t-major) of QK^T, held in registers for the
//   whole walk, with channel k of each 16-wide step permuted so a lane's
//   operand-B bytes of K are 4 consecutive bytes of one packed row: the low
//   nibbles form the tile of even positions, the high nibbles the tile of
//   odd positions (n8 each). The score fragments of those two tiles are,
//   after the softmax, exactly operand A of PV (k = 16 positions), and a
//   lane's operand B of V is one byte of each of two adjacent packed rows:
//   their low nibbles are positions 2t, 2t+1 of the step, their high
//   nibbles 2t+8, 2t+9. Nibbles become bf16 as in int4_mma.cuh (0x4300 | v
//   is 128 + v; 0x4308 folds the XOR 8; one __hsub2 of 128 leaves v).
// * Less work at decode: a CTA with at most 8 query rows (every decode,
//   G = 4) skips the softmax of the tile's upper 8 rows. p = exp(s - m) uses
//   __expf; alpha and the merge factors use expf, which gives exp(0) = 1
//   exactly, as the identities above need.
//
// PERF.md gives its times against SDPA over bf16 K/V and against the byte
// bound (scripts/attention_sweep.py, chip_smoke.py): short rows are bound by
// latency (one block per warp), long ones by issuing the per-block work at
// 8 warps per SM (~210 registers a thread).
#include "common.cuh"

namespace f4b {
namespace {

constexpr int kAttnWarps = 4;
constexpr int kAttnThreads = kAttnWarps * 32;
constexpr int kSTile = 32;   // cache positions per unit: one page lookup, one lane each (f32 body)
constexpr int kMaxRows = 16; // query rows per CTA
constexpr int kRowsPerAttnWarp = kMaxRows / kAttnWarps;
constexpr float kNegInf = -1e30f;

// Where the unit of positions [s0, s0 + 32) of (batch row b, kv head kv)
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

// ---------------------------------------------------------------------------
// The tensor-core body (bf16 queries).

constexpr int kBlockPos = 64;                 // positions per block of a warp's walk
constexpr int kBlockRows = kBlockPos / 2;     // packed rows per block
constexpr int kUnitRows = kSTile / 2;         // packed rows per unit of 32 positions

template <int D>
struct AttnSmem {
  static constexpr int kCols = D / 16;                       // 16-byte columns of a packed row
  static constexpr int kCodeBytes = kBlockRows * D;          // K or V codes of a block
  static constexpr int kPlaneFloats = 4 * kBlockPos;         // ks, kz, vs, vz of a block
  static constexpr int kBufBytes = 2 * kCodeBytes + kPlaneFloats * 4;
  static constexpr int kWarpBytes = 2 * kBufBytes;           // two buffers
  static constexpr int kFrag = kMaxRows * D;                 // a warp's acc, fragment order
  // the CTA merge reuses the buffers: acc[4][kFrag], m[4][16], l[4][16],
  // factors f[4][16], L[16]
  static constexpr int kMergeBytes = (kAttnWarps * (kFrag + 3 * kMaxRows) + kMaxRows) * 4;
  static constexpr int kBytes = kAttnWarps * kWarpBytes > kMergeBytes ? kAttnWarps * kWarpBytes
                                                                       : kMergeBytes;
};

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// bf16 pair (v0, v1) - 128 each, exact for the 128 + nibble values below.
__device__ __forceinline__ uint32_t minus128(uint32_t v) {
  return bf2_bits(__hsub2(bits_bf2(v), bits_bf2(0x43004300u)));
}

// Bytes 0 and 2 of r (low byte of each 16-bit half) as two bf16 code pairs:
// lo = their low nibbles, hi = their high nibbles XOR 8 (the odd positions'
// codes), each as 128 + code.
__device__ __forceinline__ void code_pairs(uint32_t r, uint32_t& lo, uint32_t& hi) {
  lo = minus128((r & 0x000F000Fu) | 0x43004300u);
  hi = minus128(((r >> 4) & 0x000F000Fu) ^ 0x43084308u);
}

__device__ __forceinline__ void attn_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void attn_cp16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void attn_cp8(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void attn_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void attn_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of byte `byte` of packed row `row` in a block's codes: the
// 16-byte columns XOR-swizzled by the row.
template <int D>
__device__ __forceinline__ int code_off(int row, int byte) {
  constexpr int kCols = D / 16;
  return row * D + ((((byte >> 4) ^ row) & (kCols - 1)) << 4) + (byte & 15);
}

struct AttnArgs {
  const __nv_bfloat16* q;   // [B, Hkv*G, Tq, D]
  const uint8_t* kp;        // codes, laid out as the Cache says
  const float* ks;
  const float* kz;
  const uint8_t* vp;
  const float* vs;
  const float* vz;
  const int32_t* lengths;   // [B]
  const int32_t* starts;    // [B] position of each row's first query
  __nv_bfloat16* out;       // [B, Hkv*G, Tq, D]
  float* partial;           // [B*Hkv, nqt, Z, 16*D + 32] f32 when Z > 1: acc [16][D], m, l
  int Hkv, G, Tq, S, QT, seg;
  int window;               // > 0: a query sees only the last `window` positions
  int ring;                 // 1: the contiguous cache is a ring of S slots
};

// Whether the key in `slot` is visible to the query at position `qpos`: the
// slot exists and is written (slot < S, slot < length), and the position it
// holds is at or before the query and, where a window is set, inside it. A
// slot holds position `slot`, or on a ring of S slots the newest position
// p < length with p % S == slot. Without a window or a ring this is the
// causal mask `slot < length && slot <= qpos` alone (length <= S there).
__device__ __forceinline__ bool key_visible(int slot, int length, int qpos, int S, int window,
                                            int ring) {
  if (slot >= length || slot >= S) return false;
  int pos = slot;
  if (ring) {
    const int last = length - 1;
    pos = last - (last - slot) % S;
  }
  return pos <= qpos && (window == 0 || pos > qpos - window);
}

// The end of the positions a query tile reads: min(length, its last query
// position + 1, S).
__device__ __forceinline__ int causal_end(const AttnArgs& p, int b, int t0) {
  const int nq = min(p.QT, p.Tq - t0);
  return min(min(p.lengths[b], p.starts[b] + t0 + nq), p.S);
}

// The end of the slots a query tile reads: causal_end, or on a ring every
// written slot, min(length, S). The same in both kernels of a launch.
__device__ __forceinline__ int tile_end(const AttnArgs& p, int b, int t0) {
  return p.ring ? min(p.lengths[b], p.S) : causal_end(p, b, t0);
}

// Output element i (fragment order: i = (j * 4 + e) * 32 + lane) of a 16-row
// tile: its row and channel. Lane (g, t) holds, for n8 tile j of the PV
// product, rows g and g + 8 (e >> 1) at channels (D/8) * (2t + (e & 1)) + j.
template <int D>
__device__ __forceinline__ void frag_place(int i, int& row, int& ch) {
  const int lane = i & 31, je = i >> 5, j = je >> 2, e = je & 3;
  row = (lane >> 2) + 8 * (e >> 1);
  ch = (D / 8) * (2 * (lane & 3) + (e & 1)) + j;
}

template <int D>
__device__ __forceinline__ void store_row(const AttnArgs& p, int b, int kv, int t0, int row,
                                          int ch, float v) {
  const int h = kv * p.G + row % p.G;
  const int t = t0 + row / p.G;
  p.out[((static_cast<size_t>(b) * p.Hkv * p.G + h) * p.Tq + t) * D + ch] = __float2bfloat16(v);
}

// One CTA per (batch row * kv head, query tile, range z of 4 segments). The
// body of two kernels: kWindow false, the causal mask alone (calls without
// a window or a ring, compiled as before the window existed); true,
// key_visible's window and ring.
template <int D, typename Cache, bool kWindow>
__device__ __forceinline__ void attention_mma_body(const AttnArgs& p, const Cache& cache) {
  using Sm = AttnSmem<D>;
  constexpr int KS = D / 16;   // k steps of QK^T
  constexpr int NJ = D / 8;    // n8 tiles (channels) of PV
  extern __shared__ __align__(16) unsigned char smem[];

  const int bk = blockIdx.x;
  const int b = bk / p.Hkv;
  const int kv = bk - b * p.Hkv;
  const int t0 = blockIdx.y * p.QT;
  const int rows = min(p.QT, p.Tq - t0) * p.G;
  const int length = p.lengths[b];
  const int qstart = p.starts[b];
  const int s_end = kWindow ? tile_end(p, b, t0) : causal_end(p, b, t0);
  const int cta_pos = kAttnWarps * p.seg;
  if (gridDim.z > 1 && static_cast<int>(blockIdx.z) * cta_pos >= s_end) return;  // uniform
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const float inv_sqrt_d = 1.f / sqrtf(static_cast<float>(D));
  const bool two = rows > 8;  // rows gr + 8 hold queries (CTA-uniform; never at decode)

  // The warp's segment and its blocks of 64 positions.
  const int seg_lo = (static_cast<int>(blockIdx.z) * kAttnWarps + warp) * p.seg;
  const int seg_hi = min(seg_lo + p.seg, s_end);
  const int nblk = seg_hi > seg_lo ? (seg_hi - seg_lo + kBlockPos - 1) / kBlockPos : 0;
  unsigned char* wbuf = smem + warp * Sm::kWarpBytes;

  // Issue block i's loads into buffer i & 1: K and V codes of the units that
  // start below s_end, and the four planes of the same positions. With a
  // window, also no slot at or past S: a ring's S need not be a multiple of
  // a unit, and its last unit would read past the row's slots (past the
  // cache, in the last row); those slots are zero-filled and masked.
  auto issue = [&](int i) {
    unsigned char* buf = wbuf + (i & 1) * Sm::kBufBytes;
    const int bs = seg_lo + i * kBlockPos;
    const bool in0 = bs < s_end, in1 = bs + kSTile < s_end;
    const TileAddr at0 = in0 ? cache.tile(b, kv, p.Hkv, bs) : TileAddr{0, 0};
    const TileAddr at1 = in1 ? cache.tile(b, kv, p.Hkv, bs + kSTile) : TileAddr{0, 0};
    constexpr int kRowsPerRound = 32 / Sm::kCols;  // packed rows per round of 32 pieces
#pragma unroll
    for (int k = 0; k < kBlockRows / kRowsPerRound; ++k) {
      const int row = lane / Sm::kCols + k * kRowsPerRound, col = lane % Sm::kCols;
      const bool u1 = k * kRowsPerRound >= kUnitRows;  // the round's unit, fixed per k
      const bool in = (u1 ? in1 : in0) && (!kWindow || bs + 2 * row < p.S);
      const size_t g = ((u1 ? at1.packed_row : at0.packed_row) + (row - (u1 ? kUnitRows : 0))) * D +
                       col * 16;
      const int off = code_off<D>(row, col * 16);
      attn_cp16(buf + off, in ? p.kp + g : p.kp, in);
      attn_cp16(buf + Sm::kCodeBytes + off, in ? p.vp + g : p.vp, in);
    }
    // the four planes, 8 bytes (2 positions) per lane each: positions 2 lane, + 1
    float* pl = reinterpret_cast<float*>(buf + 2 * Sm::kCodeBytes);
    const bool u1 = 2 * lane >= kSTile;
    const bool in = (u1 ? in1 : in0) && (!kWindow || bs + 2 * lane < p.S);
    const size_t at = (u1 ? at1.plane : at0.plane) + (2 * lane - (u1 ? kSTile : 0));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* plane = k == 0 ? p.ks : k == 1 ? p.kz : k == 2 ? p.vs : p.vz;
      attn_cp8(pl + k * kBlockPos + 2 * lane, in ? plane + at : plane, in);
    }
    attn_commit();
  };

  if (nblk > 0) issue(0);  // in flight while Q is read

  // Q rows gr and gr + 8 as operand A, channels (D/4) tq .. + D/4 of each;
  // k step kk takes channels (D/4) tq + 4 kk + 0..3 (registers a0/a1: + 0, 1;
  // a2/a3: + 2, 3). qsum: the f32 sum of the row, lane partials in order,
  // then the 4 lanes of the row.
  uint32_t qa[KS][4];
  float qsum[2];
  int qpos[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = gr + 8 * e;
    uint32_t w[D / 8];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) w[i] = 0u;
    qpos[e] = -1;
    if (r < rows) {
      const int h = kv * p.G + r % p.G;
      const int t = t0 + r / p.G;
      qpos[e] = qstart + t;
      const uint4* src = reinterpret_cast<const uint4*>(
          p.q + ((static_cast<size_t>(b) * p.Hkv * p.G + h) * p.Tq + t) * D + (D / 4) * tq);
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const uint4 v = src[i];
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float2 f = __bfloat1622float2(bits_bf2(w[i]));
      s += f.x + f.y;
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    qsum[e] = s + __shfl_xor_sync(0xffffffffu, s, 2);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[kk][e] = w[2 * kk];
      qa[kk][2 + e] = w[2 * kk + 1];
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, cz[2] = {0.f, 0.f};
  float o[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < nblk; ++i) {
    if (i + 1 < nblk) {
      issue(i + 1);
      attn_wait<1>();
    } else {
      attn_wait<0>();
    }
    __syncwarp();
    const unsigned char* buf = wbuf + (i & 1) * Sm::kBufBytes;
    const float* pl = reinterpret_cast<const float*>(buf + 2 * Sm::kCodeBytes);
    const int bs = seg_lo + i * kBlockPos;

    // Scores of the block: 4 tiles of 16 positions; lane (gr, tq) gets rows
    // gr, gr + 8 at positions 16u + 4tq + 0..3 (even tile cols 2tq, 2tq+1 ->
    // + 0, + 2; odd tile -> + 1, + 3).
    float sc[4][2][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float se[4] = {0.f, 0.f, 0.f, 0.f}, so[4] = {0.f, 0.f, 0.f, 0.f};
      uint32_t kw[KS];
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            buf + code_off<D>(8 * u + gr, (D / 4) * tq + 16 * c));
        kw[4 * c] = v.x;
        kw[4 * c + 1] = v.y;
        kw[4 * c + 2] = v.z;
        kw[4 * c + 3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t lo01, hi01, lo23, hi23;
        code_pairs(__byte_perm(kw[kk], 0u, 0x4140u), lo01, hi01);
        code_pairs(__byte_perm(kw[kk], 0u, 0x4342u), lo23, hi23);
        attn_mma(se, qa[kk], lo01, lo23);
        attn_mma(so, qa[kk], hi01, hi23);
      }
      const int p0 = 16 * u + 4 * tq;
      const float4 ks4 = *reinterpret_cast<const float4*>(pl + p0);
      const float4 kz4 = *reinterpret_cast<const float4*>(pl + kBlockPos + p0);
      const float ksv[4] = {ks4.x, ks4.y, ks4.z, ks4.w};
      const float kzv[4] = {kz4.x, kz4.y, kz4.z, kz4.w};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float raw[4] = {se[2 * e], so[2 * e], se[2 * e + 1], so[2 * e + 1]};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sc[u][e][k] = kNegInf;
          if (e == 1 && !two) continue;
          const int pos = bs + p0 + k;
          const float s = (raw[k] * ksv[k] - qsum[e] * (ksv[k] * kzv[k])) * inv_sqrt_d;
          if (kWindow ? key_visible(pos, length, qpos[e], p.S, p.window, p.ring)
                      : pos < length && pos <= qpos[e])
            sc[u][e][k] = s;
        }
      }
    }

    // Online softmax, once per block: the block max of each row over its 4
    // lanes, then p, ps = bf16(p * vs) rounded once, and the lane partials of
    // l and of the zero-point correction sum(ps * vz), both in order.
    float alpha[2];
    uint32_t pa[4][4];
    alpha[1] = 1.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (e == 1 && !two) break;
      float bm = kNegInf;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k) bm = fmaxf(bm, sc[u][e][k]);
      bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
      bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
      const float m_new = fmaxf(m[e], bm);
      alpha[e] = expf(m[e] - m_new);  // exactly 1 where the block adds nothing
      m[e] = m_new;
    }
    float psum[2] = {0.f, 0.f}, csum[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p0 = 16 * u + 4 * tq;
      const float4 vs4 = *reinterpret_cast<const float4*>(pl + 2 * kBlockPos + p0);
      const float4 vz4 = *reinterpret_cast<const float4*>(pl + 3 * kBlockPos + p0);
      const float vsv[4] = {vs4.x, vs4.y, vs4.z, vs4.w};
      const float vzv[4] = {vz4.x, vz4.y, vz4.z, vz4.w};
      __nv_bfloat16 ps[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ps[e][k] = __float2bfloat16(0.f);
          if (e == 1 && !two) continue;
          const bool valid = sc[u][e][k] != kNegInf;
          const float pv = valid ? __expf(sc[u][e][k] - m[e]) : 0.f;
          psum[e] += pv;
          ps[e][k] = __float2bfloat16(pv * vsv[k]);
          if (valid) csum[e] = fmaf(__bfloat162float(ps[e][k]), vzv[k], csum[e]);
        }
      }
      // operand A of PV: k 2tq, 2tq+1 <- positions + 0, + 2; k 2tq+8, +9 <- + 1, + 3
      pa[u][0] = bf2_bits(__halves2bfloat162(ps[0][0], ps[0][2]));
      pa[u][1] = bf2_bits(__halves2bfloat162(ps[1][0], ps[1][2]));
      pa[u][2] = bf2_bits(__halves2bfloat162(ps[0][1], ps[0][3]));
      pa[u][3] = bf2_bits(__halves2bfloat162(ps[1][1], ps[1][3]));
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] = alpha[e] * l[e] + psum[e];
      cz[e] = alpha[e] * cz[e] + csum[e];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // PV: operand B of n8 tile j is byte (D/8) gr + j of packed rows
    // 16u/2 + 2tq (positions + 0, + 1) and + 2tq + 1 (positions + 2, + 3).
    const unsigned char* vbuf = buf + Sm::kCodeBytes;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t va[NJ / 4], vb[NJ / 4];
#pragma unroll
      for (int c = 0; c < NJ / 4; c += 2) {
        const int byte = (D / 8) * gr + 4 * c;
        const uint2 x = *reinterpret_cast<const uint2*>(vbuf + code_off<D>(8 * u + 2 * tq, byte));
        const uint2 y =
            *reinterpret_cast<const uint2*>(vbuf + code_off<D>(8 * u + 2 * tq + 1, byte));
        va[c] = x.x;
        va[c + 1] = x.y;
        vb[c] = y.x;
        vb[c + 1] = y.y;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint32_t q = j & 3;
        uint32_t lo, hi;
        code_pairs(__byte_perm(va[j >> 2], vb[j >> 2], q | ((4u + q) << 8)), lo, hi);
        attn_mma(o[j], pa[u], lo, hi);
      }
    }
    __syncwarp();  // buffer i & 1 is consumed before block i + 2 refills it
  }

  // The segment's row state: l and the correction summed over the row's 4
  // lanes, the correction subtracted from every channel.
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    cz[e] += __shfl_xor_sync(0xffffffffu, cz[e], 1);
    cz[e] += __shfl_xor_sync(0xffffffffu, cz[e], 2);
  }

  // Merge the CTA's 4 segments in order, through shared memory.
  __syncthreads();  // every warp is done with its buffers
  float* macc = reinterpret_cast<float*>(smem);                 // [4][16 * D] fragment order
  float* mm = macc + kAttnWarps * Sm::kFrag;                     // [4][16]
  float* ml = mm + kAttnWarps * kMaxRows;                        // [4][16]
  float* mf = ml + kAttnWarps * kMaxRows;                        // [4][16]
  float* mL = mf + kAttnWarps * kMaxRows;                        // [16]
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      macc[warp * Sm::kFrag + (j * 4 + e) * 32 + lane] = o[j][e] - cz[e >> 1];
    }
  }
  if (tq == 0) {
    mm[warp * kMaxRows + gr] = m[0];
    mm[warp * kMaxRows + gr + 8] = m[1];
    ml[warp * kMaxRows + gr] = l[0];
    ml[warp * kMaxRows + gr + 8] = l[1];
  }
  __syncthreads();
  float* part = p.partial + ((static_cast<size_t>(bk) * gridDim.y + blockIdx.y) * gridDim.z +
                             blockIdx.z) * (Sm::kFrag + 2 * kMaxRows);  // used when Z > 1
  if (threadIdx.x < kMaxRows) {
    const int r = threadIdx.x;
    float mx = mm[r];
    for (int w = 1; w < kAttnWarps; ++w) mx = fmaxf(mx, mm[w * kMaxRows + r]);
    float L = 0.f;
    for (int w = 0; w < kAttnWarps; ++w) {
      const float f = expf(mm[w * kMaxRows + r] - mx);
      mf[w * kMaxRows + r] = f;
      L = fmaf(f, ml[w * kMaxRows + r], L);
    }
    mL[r] = L;
    if (gridDim.z > 1) {
      part[Sm::kFrag + r] = mx;
      part[Sm::kFrag + kMaxRows + r] = L;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Sm::kFrag; i += kAttnThreads) {
    int row, ch;
    frag_place<D>(i, row, ch);
    if (row >= rows) continue;
    float v = mf[row] * macc[i];
    for (int w = 1; w < kAttnWarps; ++w)
      v = fmaf(mf[w * kMaxRows + row], macc[w * Sm::kFrag + i], v);
    if (gridDim.z > 1) {
      part[row * D + ch] = v;
    } else {
      const float L = mL[row];
      store_row<D>(p, b, kv, t0, row, ch, L > 0.f ? v / L : 0.f);
    }
  }
}

template <int D, typename Cache>
__global__ void __launch_bounds__(kAttnThreads) int4_attention_mma_kernel(const AttnArgs p,
                                                                         const Cache cache) {
  attention_mma_body<D, Cache, false>(p, cache);
}

template <int D, typename Cache>
__global__ void __launch_bounds__(kAttnThreads) int4_attention_window_kernel(const AttnArgs p,
                                                                            const Cache cache) {
  attention_mma_body<D, Cache, true>(p, cache);
}

// The second pass with Z > 1: one thread per output element (row, channel)
// of a (batch row * kv head, query tile) merges the CTAs' partials in order
// z = 0, 1, ... as the CTA merges its segments; the CTAs past the tile's end
// wrote nothing and are not read.
template <int D>
__global__ void __launch_bounds__(kAttnThreads) int4_attention_merge_kernel(const AttnArgs p,
                                                                           int Z) {
  using Sm = AttnSmem<D>;
  const int bk = blockIdx.x;
  const int b = bk / p.Hkv;
  const int kv = bk - b * p.Hkv;
  const int t0 = blockIdx.y * p.QT;
  const int rows = min(p.QT, p.Tq - t0) * p.G;
  const int e = blockIdx.z * kAttnThreads + threadIdx.x;
  if (e >= rows * D) return;
  const int row = e / D, ch = e - row * D;
  const int cta_pos = kAttnWarps * p.seg;
  const int nz = (tile_end(p, b, t0) + cta_pos - 1) / cta_pos;
  const size_t stride = Sm::kFrag + 2 * kMaxRows;
  const float* part = p.partial + (static_cast<size_t>(bk) * gridDim.y + blockIdx.y) * Z * stride;
  float mx = kNegInf;
#pragma unroll 8
  for (int z = 0; z < nz; ++z) mx = fmaxf(mx, part[z * stride + Sm::kFrag + row]);
  float v = 0.f, L = 0.f;
#pragma unroll 8
  for (int z = 0; z < nz; ++z) {
    const float* pz = part + z * stride;
    const float f = expf(pz[Sm::kFrag + row] - mx);
    v = fmaf(f, pz[e], v);
    L = fmaf(f, pz[Sm::kFrag + kMaxRows + row], L);
  }
  store_row<D>(p, b, kv, t0, row, ch, L > 0.f ? v / L : 0.f);
}

template <int D, typename Cache>
int launch_attention_mma(const AttnArgs& p, const Cache& cache, int B, void* stream) {
  using Sm = AttnSmem<D>;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Z = (p.S + kAttnWarps * p.seg - 1) / (kAttnWarps * p.seg);
  const dim3 grid(B * p.Hkv, (p.Tq + p.QT - 1) / p.QT, Z);
  if (Z > 65535 || grid.y > 65535 || (Z > 1 && p.partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool windowed = p.window > 0 || p.ring;
  const auto kernel = windowed ? int4_attention_window_kernel<D, Cache>
                               : int4_attention_mma_kernel<D, Cache>;
  // The dynamic shared memory each device already allows the kernel (48 KB
  // by default), raised once per device and kernel.
  constexpr int kDevices = 64;
  static bool raised[2][kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Sm::kBytes > 48 * 1024 && (dev >= kDevices || !raised[windowed][dev])) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sm::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) raised[windowed][dev] = true;
  }
  kernel<<<grid, kAttnThreads, Sm::kBytes, st>>>(p, cache);
  err = cudaGetLastError();
  if (err != cudaSuccess || Z == 1) return static_cast<int>(err);
  const dim3 merge_grid(grid.x, grid.y, (p.QT * p.G * D + kAttnThreads - 1) / kAttnThreads);
  int4_attention_merge_kernel<D><<<merge_grid, kAttnThreads, 0, st>>>(p, Z);
  return static_cast<int>(cudaGetLastError());
}

template <typename Cache>
int dispatch_attention_mma(const AttnArgs& p, const Cache& cache, int B, int D, void* stream) {
  if (p.QT * p.G > kMaxRows || p.QT < 1 || p.seg < kBlockPos || p.seg % kBlockPos != 0 ||
      p.S % 2 != 0 || p.window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return launch_attention_mma<64>(p, cache, B, stream);
  if (D == 128) return launch_attention_mma<128>(p, cache, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The CUDA-core body (f32 queries): one CTA per (batch row, kv head, query
// tile) walks the cache in tiles of 32 positions up to min(length, last
// query position + 1), unpacks K (dequantized) and V (centered codes) into
// f32 shared memory, and runs the online softmax with lane j on position
// s0 + j. Masked entries contribute exactly 0, and a row that saw no valid
// entry has l = 0 and writes 0.

template <int D, typename Cache>
__global__ void __launch_bounds__(kAttnThreads) int4_attention_rows_kernel(
    const float* __restrict__ q,      // [B, Hkv*G, Tq, D]
    const uint8_t* __restrict__ kp,   // codes, laid out as Cache says
    const float* __restrict__ ks, const float* __restrict__ kz,  // planes
    const uint8_t* __restrict__ vp,
    const float* __restrict__ vs, const float* __restrict__ vz,
    const int32_t* __restrict__ lengths,  // [B]
    const int32_t* __restrict__ starts,   // [B] position of each row's first query
    float* __restrict__ out,          // [B, Hkv*G, Tq, D]
    Cache cache, int Hkv, int G, int Tq, int S, int QT,  // S: logical positions per row
    int window, int ring) {
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
  // last query position + 1; on a ring every written slot
  const int s_end = ring ? min(length, S) : min(min(length, qstart + t0 + nq), S);
  const float sm_scale = 1.f / sqrtf(static_cast<float>(D));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < rows * D; i += kAttnThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int h = kv * G + r % G;
    const int t = t0 + r / G;
    qs[r][d] = q[((static_cast<size_t>(b) * hq + h) * Tq + t) * D + d] * sm_scale;
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
        const bool valid = key_visible(pos, length, qpos, S, window, ring);
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
        const float ps = p * sc[2][lane];
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
      float* o = out + ((static_cast<size_t>(b) * hq + h) * Tq + t) * D;
#pragma unroll
      for (int dl = 0; dl < DL; ++dl) o[lane + 32 * dl] = acc[rr][dl] * inv;
    }
  }
}

template <int D, typename Cache>
int launch_attention_rows(const void* q, const void* kp, const void* ks, const void* kz,
                     const void* vp, const void* vs, const void* vz,
                     const void* lengths, const void* starts, void* out, Cache cache,
                     int B, int Hkv, int G, int Tq, int S, int QT, int window, int ring,
                     void* stream) {
  const dim3 grid(B * Hkv, (Tq + QT - 1) / QT);
  int4_attention_rows_kernel<D, Cache>
      <<<grid, kAttnThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const uint8_t*>(kp),
          static_cast<const float*>(ks), static_cast<const float*>(kz),
          static_cast<const uint8_t*>(vp), static_cast<const float*>(vs),
          static_cast<const float*>(vz), static_cast<const int32_t*>(lengths),
          static_cast<const int32_t*>(starts), static_cast<float*>(out), cache, Hkv, G, Tq, S,
          QT, window, ring);
  return static_cast<int>(cudaGetLastError());
}

template <typename Cache>
int dispatch_attention_rows(const void* q, const void* kp, const void* ks, const void* kz,
                       const void* vp, const void* vs, const void* vz,
                       const void* lengths, const void* starts, void* out, Cache cache,
                       int B, int Hkv, int G, int Tq, int S, int D, int QT, int window,
                       int ring, void* stream) {
  if (QT * G > kMaxRows || QT < 1 || window < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch_attention_rows<64>(q, kp, ks, kz, vp, vs, vz, lengths, starts, out, cache,
                                   B, Hkv, G, Tq, S, QT, window, ring, stream);
  if (D == 128)
    return launch_attention_rows<128>(q, kp, ks, kz, vp, vs, vz, lengths, starts, out, cache,
                                    B, Hkv, G, Tq, S, QT, window, ring, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_paged_rows(const void* q, const void* kp, const void* ks, const void* kz,
                   const void* vp, const void* vs, const void* vz, const void* table,
                   const void* lengths, const void* starts, void* out, int B, int Hkv,
                   int G, int Tq, int page, int max_pages, int D, int QT, int window,
                   void* stream) {
  if (page % kSTile != 0 || page <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const PagedCache cache{static_cast<const int32_t*>(table), page, max_pages};
  return dispatch_attention_rows(q, kp, ks, kz, vp, vs, vz, lengths, starts, out, cache, B,
                               Hkv, G, Tq, page * max_pages, D, QT, window, 0, stream);
}

}  // namespace
}  // namespace f4b

namespace {

f4b::AttnArgs attn_args(const void* q, const void* kp, const void* ks, const void* kz,
                        const void* vp, const void* vs, const void* vz, const void* lengths,
                        const void* starts, void* out, void* partial, int Hkv, int G, int Tq,
                        int S, int QT, int seg, int window, int ring) {
  return f4b::AttnArgs{static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kp),
                       static_cast<const float*>(ks), static_cast<const float*>(kz),
                       static_cast<const uint8_t*>(vp), static_cast<const float*>(vs),
                       static_cast<const float*>(vz), static_cast<const int32_t*>(lengths),
                       static_cast<const int32_t*>(starts), static_cast<__nv_bfloat16*>(out),
                       static_cast<float*>(partial), Hkv, G, Tq, S, QT, seg, window, ring};
}

}  // namespace

// K3, bf16: the tensor-core body. partial: f32 scratch of
// B*Hkv * ceil(Tq/QT) * Z * (16*D + 32) floats when Z = ceil(S / (4 seg)) > 1.
// window: 0, or the positions a query sees (its own included); ring: 1 when
// the cache is a ring of S slots (a window layer's), 0 when slot = position.
extern "C" int f4b_int4_attention_bf16(const void* q, const void* kp, const void* ks,
                                       const void* kz, const void* vp, const void* vs,
                                       const void* vz, const void* lengths,
                                       const void* starts, void* out, void* partial, int B,
                                       int Hkv, int G, int Tq, int S, int D, int QT, int seg,
                                       int window, int ring, void* stream) {
  return f4b::dispatch_attention_mma(attn_args(q, kp, ks, kz, vp, vs, vz, lengths, starts, out,
                                               partial, Hkv, G, Tq, S, QT, seg, window, ring),
                                     f4b::ContiguousCache{S}, B, D, stream);
}

extern "C" int f4b_int4_attention_f32(const void* q, const void* kp, const void* ks,
                                      const void* kz, const void* vp, const void* vs,
                                      const void* vz, const void* lengths,
                                      const void* starts, void* out, int B, int Hkv,
                                      int G, int Tq, int S, int D, int QT, int window,
                                      int ring, void* stream) {
  return f4b::dispatch_attention_rows(q, kp, ks, kz, vp, vs, vz, lengths, starts, out,
                                             f4b::ContiguousCache{S}, B, Hkv, G, Tq, S, D, QT,
                                             window, ring, stream);
}

// K3', bf16: the tensor-core body on the page pool; S = page * max_pages.
// A window masks positions; the pages hold every position of the slot.
extern "C" int f4b_paged_int4_attention_bf16(const void* q, const void* kp, const void* ks,
                                             const void* kz, const void* vp, const void* vs,
                                             const void* vz, const void* table,
                                             const void* lengths, const void* starts,
                                             void* out, void* partial, int B, int Hkv, int G,
                                             int Tq, int page, int max_pages, int D, int QT,
                                             int seg, int window, void* stream) {
  if (page % f4b::kSTile != 0 || page <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const f4b::PagedCache cache{static_cast<const int32_t*>(table), page, max_pages};
  return f4b::dispatch_attention_mma(attn_args(q, kp, ks, kz, vp, vs, vz, lengths, starts, out,
                                               partial, Hkv, G, Tq, page * max_pages, QT, seg,
                                               window, 0),
                                     cache, B, D, stream);
}

extern "C" int f4b_paged_int4_attention_f32(const void* q, const void* kp, const void* ks,
                                            const void* kz, const void* vp, const void* vs,
                                            const void* vz, const void* table,
                                            const void* lengths, const void* starts,
                                            void* out, int B, int Hkv, int G, int Tq,
                                            int page, int max_pages, int D, int QT,
                                            int window, void* stream) {
  return f4b::dispatch_paged_rows(q, kp, ks, kz, vp, vs, vz, table, lengths, starts,
                                         out, B, Hkv, G, Tq, page, max_pages, D, QT, window,
                                         stream);
}
