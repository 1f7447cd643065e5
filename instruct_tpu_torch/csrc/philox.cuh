// Philox4x32-10 (Salmon et al., SC'11), the counter-based generator of every
// sampling kernel of the port.  It replaces the TPU on-core PRNG of the JAX
// package (pltpu.prng_seed / prng_random_bits, seeded per block from
// instruct_tpu/kernels/fused_step.py:seed_words).
//
// Key     = the run's 64-bit seed as two words (k0 low, k1 high).
// Counter = (c0 element-block index, c1 stream id, c2 step index,
//            c3 chain key),
// so every (chain, step, kernel stream, element) has its own draw whatever
// the launch geometry.  instruct_tpu_torch/kernels/philox.py is the same
// function in plain PyTorch integer ops, bit for bit.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

struct Philox4 {
  uint32_t x, y, z, w;
};

__host__ __device__ __forceinline__ Philox4 philox4x32_10(
    uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3, uint32_t k0,
    uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint64_t p0 = (uint64_t)M0 * c0;
    const uint64_t p1 = (uint64_t)M1 * c2;
    const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c1 ^ k0;
    const uint32_t n1 = (uint32_t)p1;
    const uint32_t n2 = (uint32_t)(p0 >> 32) ^ c3 ^ k1;
    const uint32_t n3 = (uint32_t)p0;
    c0 = n0; c1 = n1; c2 = n2; c3 = n3;
    k0 += W0; k1 += W1;
  }
  return Philox4{c0, c1, c2, c3};
}

__device__ __forceinline__ uint32_t philox_word(const Philox4& r, int i) {
  return i == 0 ? r.x : (i == 1 ? r.y : (i == 2 ? r.z : r.w));
}

// U[0, 1) on a 2^-23 grid: the z draw's conversion
// (instruct_tpu/kernels/fused_step.py:310-312).
__device__ __forceinline__ float u01_closed(uint32_t bits) {
  return (float)(bits & 0x7FFFFFu) * (1.0f / 8388608.0f);
}

// U(0, 1) strictly inside the interval: every other draw
// (instruct_tpu/kernels/s_pop_pallas.py:42-43, dirichlet_pallas.py:46-47).
__device__ __forceinline__ float u01_open(uint32_t bits) {
  return ((float)(bits & 0x7FFFFFu) + 0.5f) * (1.0f / 8388608.0f);
}

// Stream ids (word c1): one per uniform plane family.  Keep in step with
// instruct_tpu_torch/kernels/philox.py.
#define STREAM_S_PROP 2u
#define STREAM_S_ACC 3u
#define STREAM_S_GEN 4u
#define STREAM_S_LOGU 5u
#define STREAM_Z 6u
#define STREAM_GENO 16u
#define STREAM_DPM_SEAT 18u
