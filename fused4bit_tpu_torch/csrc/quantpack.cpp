// Native host-side INT4 quantize + pack (offline weight conversion).
//
// The port's copy of the JAX package's packer (fused4bit_tpu/csrc/quantpack.cpp):
// dense f32 [n, k] -> per-row affine INT4 -> planar-packed bytes, OpenMP-parallel
// rows, a single min/max pass, quantize and pack fused, no intermediate nibble
// array. Loaded through ctypes by fused4bit_tpu_torch/native.py, which keeps a
// NumPy fallback for machines without a compiler.
//
// One change from the JAX copy: the codes divide by the scale. The JAX copy
// multiplies by a reciprocal (`row[c] * inv + zp`), and built with -O3 the
// compiler may contract that into an FMA; either way a value next to a
// half-code boundary can round to the other code than the quantizer's
// `round(w / scale + zp)`. Dividing, built with -ffp-contract=off, gives the
// quantizer's bytes at every width.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstddef>

extern "C" {

// Quantize a row-major [n, k] float32 matrix to planar-packed INT4.
//   packed:      [n, k/2] uint8 out — byte c = ((q[c+k/2] ^ 8) << 4) | q[c]
//   scales, zps: [n] float32 out
// The high-nibble XOR 8 is the layout of quant.core.pack_planar.
void quantize_pack_planar_f32(
    const float* __restrict__ w,
    std::int64_t n,
    std::int64_t k,
    std::uint8_t* __restrict__ packed,
    float* __restrict__ scales,
    float* __restrict__ zps) {
  const std::int64_t half = k / 2;
  const float max_q = 15.0f;

#pragma omp parallel for schedule(static)
  for (std::int64_t r = 0; r < n; ++r) {
    const float* row = w + r * k;
    float mn = row[0], mx = row[0];
    for (std::int64_t i = 1; i < k; ++i) {
      mn = std::min(mn, row[i]);
      mx = std::max(mx, row[i]);
    }
    float scale = (mx - mn) / max_q;
    if (mx == mn) {
      // constant-row guard: a zero range would divide by zero
      scale = std::max(std::fabs(mx), 1.0f) / max_q;
    }
    scale = std::max(scale, 1e-8f);
    float zp = std::nearbyint(-mn / scale);
    zp = std::min(std::max(zp, 0.0f), max_q);
    scales[r] = scale;
    zps[r] = zp;

    std::uint8_t* prow = packed + r * half;
    for (std::int64_t c = 0; c < half; ++c) {
      float qlo = std::nearbyint(row[c] / scale + zp);
      float qhi = std::nearbyint(row[c + half] / scale + zp);
      qlo = std::min(std::max(qlo, 0.0f), max_q);
      qhi = std::min(std::max(qhi, 0.0f), max_q);
      const std::uint8_t lo = static_cast<std::uint8_t>(qlo);
      const std::uint8_t hi = static_cast<std::uint8_t>(qhi) ^ 0x8u;
      prow[c] = static_cast<std::uint8_t>((hi << 4) | lo);
    }
  }
}

// Dequantize planar-packed INT4 back to float32 [n, k] (verification path).
void dequantize_planar_f32(
    const std::uint8_t* __restrict__ packed,
    std::int64_t n,
    std::int64_t k,
    const float* __restrict__ scales,
    const float* __restrict__ zps,
    float* __restrict__ out) {
  const std::int64_t half = k / 2;
#pragma omp parallel for schedule(static)
  for (std::int64_t r = 0; r < n; ++r) {
    const std::uint8_t* prow = packed + r * half;
    float* orow = out + r * k;
    const float scale = scales[r];
    const float zp = zps[r];
    for (std::int64_t c = 0; c < half; ++c) {
      const std::uint8_t b = prow[c];
      const float lo = static_cast<float>(b & 0x0F);
      const float hi = static_cast<float>((b >> 4) ^ 0x8u);
      orow[c] = (lo - zp) * scale;
      orow[c + half] = (hi - zp) * scale;
    }
  }
}

}  // extern "C"
