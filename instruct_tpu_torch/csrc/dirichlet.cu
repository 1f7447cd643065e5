// Dirichlet sampler over count groups: the P and Q draws of the sweep.
//
// Replaces the TPU kernel dirichlet_rows / _kernel of
// instruct_tpu/kernels/dirichlet_pallas.py (its layout wrapper dirichlet_kla
// included).  Same function of the uniforms: Gamma(conc) per cell by
// Marsaglia-Tsang with a FIXED number of rejection rounds, Wilson-Hilferty
// fallback, Box-Muller normals, the Gamma(a+1) * U^(1/a) boost for a < 1,
// normalised within each group.
//
// What bounds it: at the sampler's shapes (P: 4 chains x 3 x 10 000 groups of
// 2 cells; Q: 4 x 1000 groups of 3) the arrays are a few hundred kilobytes,
// so neither bytes nor operations but the launch itself bounds the kernel.
// Design: one thread per group (chain, g, m), so the normalisation needs no
// traffic between threads; the J cells of a group are a loop in the thread.
// The arrays are indexed through strides, so freq [C, K, L, A] and
// q [C, N, K] are read and written in place, without the TPU version's
// [K*A, L] row transposes or its 128-lane padding.
//
// Uniform plane d of the cell in (row r = g*J + j, column m) is word
// d*R*M + r*M + m of the (chain, step, stream) Philox counter space, or
// draws[c, d, r, m] when uniforms are injected.
#include "philox.cuh"

namespace {

constexpr float kTiny = 1e-30f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kThird = 1.0f / 3.0f;

struct Draws {
  const float* inj;      // injected planes of this chain, or nullptr
  long long plane;       // R * M
  long long cell;        // r * M + m
  uint32_t k0, k1, stream, step, chain;

  __device__ __forceinline__ float operator()(int d) const {
    const long long w = (long long)d * plane + cell;
    if (inj != nullptr) return inj[w];
    const Philox4 r = philox4x32_10((uint32_t)(w >> 2), stream, step, chain,
                                    k0, k1);
    return u01_open(philox_word(r, (int)(w & 3)));
  }
};

__device__ __forceinline__ float box_muller(float u1, float u2) {
  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
}

__device__ float gamma_cell(float conc, bool valid, const Draws& u,
                            int rounds) {
  const float a0 = valid ? conc : 1.0f;
  const bool small = a0 < 1.0f;
  const float a = a0 + (small ? 1.0f : 0.0f);
  const float d = a - kThird;
  const float c = rsqrtf(9.0f * d);
  float g = 0.0f;
  bool acc = false;
  for (int r = 0; r < rounds; ++r) {
    const float z = box_muller(u(3 * r), u(3 * r + 1));
    const float v1 = 1.0f + c * z;
    const float v = v1 * v1 * v1;
    const float rhs =
        0.5f * z * z + d - d * v + d * logf(fmaxf(v, kTiny));
    const bool ok = (v > 0.0f) && (logf(u(3 * r + 2)) < rhs);
    if (ok && !acc) g = d * v;
    acc = acc || ok;
  }
  const float zf = box_muller(u(3 * rounds), u(3 * rounds + 1));
  const float w1 = 1.0f - 1.0f / (9.0f * a) + zf * rsqrtf(9.0f * a);
  const float wh = a * w1 * w1 * w1;
  if (!acc) g = fmaxf(wh, kTiny);
  if (small) {
    g = g * expf(logf(u(3 * rounds + 2)) / fmaxf(a0, 1e-6f));
  }
  return valid ? g : 0.0f;
}

__global__ void dirichlet_kernel(
    const float* __restrict__ conc, const bool* __restrict__ valid,
    const float* __restrict__ draws, float* __restrict__ out, int C, int G,
    int J, int M, long long cs_c, long long cs_g, long long cs_j,
    long long cs_m, long long vs_g, long long vs_j, long long vs_m,
    int rounds, uint32_t k0, uint32_t k1, const int* __restrict__ chain_key,
    uint32_t step, uint32_t stream) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_chain = (long long)G * M;
  if (t >= per_chain * C) return;
  const int c = (int)(t / per_chain);
  const long long rem = t - (long long)c * per_chain;
  const int g = (int)(rem / M);
  const int m = (int)(rem - (long long)g * M);

  const long long plane = (long long)G * J * M;
  const int nd = 3 * rounds + 3;
  Draws u;
  u.inj = draws == nullptr ? nullptr : draws + (long long)c * nd * plane;
  u.plane = plane;
  u.k0 = k0; u.k1 = k1; u.stream = stream; u.step = step;
  u.chain = (uint32_t)chain_key[c];

  const long long base = c * cs_c + g * cs_g + m * cs_m;
  float tot = 0.0f;
  for (int j = 0; j < J; ++j) {
    const long long off = base + j * cs_j;
    const bool ok =
        valid == nullptr ? true : valid[g * vs_g + j * vs_j + m * vs_m];
    u.cell = ((long long)g * J + j) * M + m;
    const float gj = gamma_cell(conc[off], ok, u, rounds);
    out[off] = gj;
    tot = j == 0 ? gj : tot + gj;
  }
  const float den = fmaxf(tot, kTiny);
  for (int j = 0; j < J; ++j) {
    const long long off = base + j * cs_j;
    out[off] = out[off] / den;
  }
}

}  // namespace

extern "C" int dirichlet_launch(
    const void* conc, const void* valid, const void* draws, void* out, int C,
    int G, int J, int M, long long cs_c, long long cs_g, long long cs_j,
    long long cs_m, long long vs_g, long long vs_j, long long vs_m,
    int rounds, unsigned k0, unsigned k1, const void* chain_key,
    unsigned step, unsigned stream_id, void* stream) {
  const long long total = (long long)C * G * M;
  if (total == 0) return 0;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  dirichlet_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)conc, (const bool*)valid, (const float*)draws,
      (float*)out, C, G, J, M, cs_c, cs_g, cs_j, cs_m, vs_g, vs_j, vs_m,
      rounds, k0, k1, (const int*)chain_key, step, stream_id);
  return (int)cudaGetLastError();
}
