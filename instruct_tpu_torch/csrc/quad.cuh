// Helpers shared by the per-site kernels (site_pass.cuh, zq_sample.cu): a
// thread owns a quad of 4 consecutive loci of one individual's row, so the
// byte planes move as one 32-bit word and one Philox block serves the quad.
#pragma once
#include "philox.cuh"

namespace {

constexpr int kQuad = 4;

// Four consecutive bytes of a row; one 32-bit load when `vec` (L % 4 == 0,
// so every quad is whole and aligned).
__device__ __forceinline__ void load_bytes(const int8_t* row, int l0, int L,
                                           bool vec, int (&out)[kQuad]) {
  if (vec) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + l0);
#pragma unroll
    for (int j = 0; j < kQuad; ++j) out[j] = (int)((w >> (8 * j)) & 0xffu);
  } else {
#pragma unroll
    for (int j = 0; j < kQuad; ++j)
      out[j] = l0 + j < L ? (int)(uint8_t)row[l0 + j] : 0;
  }
}

__device__ __forceinline__ void store_bytes(int8_t* row, int l0, int L,
                                            bool vec,
                                            const int (&v)[kQuad]) {
  if (vec) {
    *reinterpret_cast<uint32_t*>(row + l0) =
        (uint32_t)v[0] | ((uint32_t)v[1] << 8) | ((uint32_t)v[2] << 16) |
        ((uint32_t)v[3] << 24);
  } else {
#pragma unroll
    for (int j = 0; j < kQuad; ++j)
      if (l0 + j < L) row[l0 + j] = (int8_t)v[j];
  }
}

// The z-draw uniforms of 4 consecutive sites starting at flat word `base`
// of the (chain, step, STREAM_Z) counter space, or the injected ones.
__device__ __forceinline__ void quad_uniforms(const float* inj,
                                              long long base, int n_live,
                                              uint32_t step, uint32_t chain,
                                              uint32_t k0, uint32_t k1,
                                              float (&u)[kQuad]) {
  if (inj != nullptr) {
#pragma unroll
    for (int j = 0; j < kQuad; ++j) u[j] = j < n_live ? inj[base + j] : 0.5f;
    return;
  }
  const int off = (int)(base & 3);
  const uint32_t blk = (uint32_t)(base >> 2);
  const Philox4 a = philox4x32_10(blk, STREAM_Z, step, chain, k0, k1);
  Philox4 b = a;
  if (off != 0) b = philox4x32_10(blk + 1u, STREAM_Z, step, chain, k0, k1);
#pragma unroll
  for (int j = 0; j < kQuad; ++j) {
    const int w = off + j;
    u[j] = u01_closed(w < 4 ? philox_word(a, w) : philox_word(b, w - 4));
  }
}

}  // namespace
