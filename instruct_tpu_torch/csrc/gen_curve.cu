// The G-marginalized site log-likelihood curve of the gradient samplers,
// forward and backward.
//
// Replaces no Pallas kernel: it is the [N, L, G] expression of
// instruct_tpu/samplers/potential.py:119-128 (MarginalModel.log_lik, modes 2
// and 3), which XLA fuses under jax.value_and_grad and vmap over chains or
// particles, and which eager PyTorch would write to memory (8 GB a
// temporary at 4 chains of the 1000 x 10 000 panel, G = 50) and keep
// several times for autograd.  Per batch row b (a chain, an ELBO sample or
// an SMC particle), individual n and selfing generation g = 1..G:
//
//   per_gen[b, n, g] = sum over valid sites l of log(max(gf_g, 1e-30))
//   m_c  = sum_k q[b, n, k] P[b, k, l, x_c]      (x_c the copy's allele)
//   w_g  = 2^(1-g)
//   gf_g = m0^2 + m0 (1 - m0)(1 - w_g)   homozygous site
//          2 m0 m1 w_g                   heterozygous site
//
// What bounds it: operations.  JAX's form takes a logarithm a homozygous
// site and g (2 * 10^9 a forward pass at the headline shape, B = 4); the
// bytes (P, q, the panel's codes and masks, the curve) are ~40 MB.  So the
// kernel computes algebraically equal forms with fewer transcendentals:
//   * homozygous, m0 >= 1e-14 (no g clipped): gf_g = m0 (1 - u w_g), u =
//     1 - m0, so log gf_g = log m0 + log(1 - u w_g): one logf a site, a
//     log1pf for g = 2..8 and, from g = 9 on (u w_g <= 2^-8), the series of
//     log(1 - x) to x^4 (truncation below 2^-40); backward, dlog gf_g / dm0
//     = 1/m0 + w_g / (1 - u w_g), a division for g <= 8, a series beyond;
//   * heterozygous, 2 m0 m1 w_G > 1e-30 (no g clipped): log(2 m0 m1) + (1 -
//     g) log 2, one logf a site, the g part added once a row; backward
//     sum_g dper_gen[g] / m_c;
//   * any other site (a clip may bind): JAX's form and clip, g by g, with a
//     zero gradient where the clip binds.
// Design, the simplest that is right:
//   * forward: one block of 256 threads a (b, n) row; a thread takes sites
//     l = tid, tid + 256, ...; G partial sums and the rows' g-independent
//     sums in registers (G <= 64, unrolled); a warp butterfly each, then
//     the warp partials in order after one barrier.  No [B, N, L] or
//     [B, N, L, G] tensor is written.
//   * backward, pass 1 (the same rows): dm_c = sum_g dper_gen[g] dlog gf_g /
//     dm_c, written as two [B, N, L] planes, and dq[b, n, k] = sum_l dm0
//     P[k, l, x0] + dm1 P[k, l, x1] reduced in the block as the forward's
//     sums are.
//   * backward, pass 2: dP[b, k, l, a] = sum_n q[b, n, k] (dm0 [x0 = a] +
//     dm1 [x1 = a]); a thread a (b, l, strip of >= 64 individuals, at most
//     16 strips), the strip's individuals in order, then the strips' sums
//     in strip order by a second small kernel.
// Every sum runs in a fixed order and no float atomic is used, so two runs
// give bitwise the same curve and gradients.  Built with -fmad=false like
// the other sources: m_c, gf_g and 2 m0 m1 round as the plain version's do
// (kernels/gen_curve.py: JAX's form at homozygous sites, log(2 m0 m1) + (1 -
// g) log 2 at heterozygous ones, within float32 rounding of the kernel's
// forms).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 64;       // kernels/gen_curve.py:MAX_GEN
constexpr int kMaxK = 32;       // kernels/gen_curve.py:MAX_POPS
constexpr int kColThreads = 128;
// pass 2a's strips of individuals: at least kStripMin rows, at most
// kMaxStrips strips
constexpr int kStripMin = 64;
constexpr int kMaxStrips = 16;
constexpr float kEps = 1e-30f;
constexpr float kLn2 = 0.693147180559945309f;
// generation indices below kExact take log1pf / a division; from kExact
// on u w_g <= 2^-8 and the series does
constexpr int kExact = 8;
// m0 >= kHomFast: no gf_g of a homozygous site falls under the clip
// (gf_1 = m0^2 >= 1e-28, gf_g >= m0 / 2 beyond)
constexpr float kHomFast = 1e-14f;
constexpr unsigned kFull = 0xffffffffu;

struct Row {
  const float* q;        // [K] of this (b, n)
  const float* p;        // [K, L, A] of this b
  const int8_t* x0;      // [L] copy-0 codes of n
  const int8_t* x1;      // [L] copy-1 codes of n
  const bool* hom;       // [L]
  const bool* valid;     // [L]
};

__device__ __forceinline__ Row row_of(const float* q, const float* p,
                                      const int8_t* geno, const bool* hom,
                                      const bool* valid, int N, int L, int K,
                                      int A, long long row) {
  const long long b = row / N, n = row % N;
  Row r;
  r.q = q + row * K;
  r.p = p + b * (long long)K * L * A;
  r.x0 = geno + n * 2LL * L;
  r.x1 = r.x0 + L;
  r.hom = hom + n * (long long)L;
  r.valid = valid + n * (long long)L;
  return r;
}

// m_c = q_0 P[0, l, x] + q_1 P[1, l, x] + ... in pop order (the plain
// version's order: likelihood.mixture_copy_probs); q_s the row's q in
// shared memory
__device__ __forceinline__ float mixture(const Row& r, const float* q_s,
                                         int K, int L, int A, int l, int x) {
  float m = q_s[0] * __ldg(r.p + (long long)l * A + x);
  for (int k = 1; k < K; ++k)
    m = m + q_s[k] * __ldg(r.p + ((long long)k * L + l) * A + x);
  return m;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o >= 1; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
  return v;
}

// w_g = 2^(1-g) for generation g = 1..G, taken by its index g - 1: an
// exact power of two, built from its exponent bits
__device__ __forceinline__ float w_of(int gi) {
  return __int_as_float((127 - gi) << 23);
}

// Sum of a block's per-thread values v[0..n) in a fixed order: a warp
// butterfly each, then the warp partials in warp order by thread j < n.
// Every thread gets nothing back; thread j < n returns the sum of v[j].
template <int kMax>
__device__ __forceinline__ float block_sums(const float (&v)[kMax], int n,
                                            float (*part)[kMax + 3],
                                            float* extra, int n_extra) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kMax; ++j) {
    if (j < n) {
      const float x = warp_sum(v[j]);
      if (lane == 0) part[warp][j] = x;
    }
  }
  for (int j = 0; j < n_extra; ++j) {
    const float x = warp_sum(extra[j]);
    if (lane == 0) part[warp][kMax + j] = x;
  }
  __syncthreads();
  const int j = threadIdx.x < n ? threadIdx.x
                                : kMax + threadIdx.x - n;  // extras after
  if (threadIdx.x >= n + n_extra) return 0.f;
  float s = part[0][j];
  for (int w = 1; w < kWarps; ++w) s = s + part[w][j];
  return s;
}

// log(1 - x) for 0 <= x <= 2^-8 (generation indices >= kExact): its
// series to x^4, truncation below x^5 / 5 <= 2^-40
__device__ __forceinline__ float log1m_series(float x) {
  return -(x * (1.f + x * (0.5f + x * (0.33333334f + x * 0.25f))));
}

// w / (1 - x) for 0 <= x <= 2^-8, to x^3 (truncation below x^4 <= 2^-32)
__device__ __forceinline__ float w_over_1mx_series(float w, float x) {
  return w * (1.f + x * (1.f + x * (1.f + x)));
}

__global__ void __launch_bounds__(kThreads)
gen_curve_fwd_kernel(const float* __restrict__ q, const float* __restrict__ p,
                     const int8_t* __restrict__ geno,
                     const bool* __restrict__ hom,
                     const bool* __restrict__ valid, float* __restrict__ out,
                     int N, int L, int K, int A, int G) {
  __shared__ float part[kWarps][kMaxG + 3];
  __shared__ float q_s[kMaxK];
  __shared__ float tot[3];
  const long long row = blockIdx.x;
  const Row r = row_of(q, p, geno, hom, valid, N, L, K, A, row);
  if (threadIdx.x < K) q_s[threadIdx.x] = r.q[threadIdx.x];
  __syncthreads();
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  // the sites' g-independent parts: sum log m0 (fast homozygous sites),
  // sum log t and their count (fast heterozygous sites)
  float ext[3] = {0.f, 0.f, 0.f};
  const float log_eps = logf(kEps);
  const float w_min = w_of(G - 1);
  for (int l = threadIdx.x; l < L; l += kThreads) {
    if (!r.valid[l]) continue;
    const float m0 = mixture(r, q_s, K, L, A, l, r.x0[l]);
    if (r.hom[l]) {
      if (m0 >= kHomFast) {
        // gf_g = m0 (1 - u w_g), u = 1 - m0: log m0 + log(1 - u w_g),
        // no g clipped; g = 1 is 2 log m0
        const float lm = logf(m0), u = 1.f - m0;
        ext[0] = ext[0] + lm;
        acc[0] = acc[0] + lm;
#pragma unroll
        for (int g = 1; g < kMaxG; ++g) {
          if (g < G) {
            const float x = u * w_of(g);
            acc[g] = acc[g] + (g < kExact ? log1pf(-x) : log1m_series(x));
          }
        }
      } else {
        // JAX's form and clip, g by g
        const float a = m0 * m0, c = m0 * (1.f - m0);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float gf = a + c * (1.f - w_of(g));
            acc[g] = acc[g] + logf(fmaxf(gf, kEps));
          }
        }
      }
    } else {
      const float m1 = mixture(r, q_s, K, L, A, l, r.x1[l]);
      const float t = (2.f * m0) * m1;
      const float lt = logf(t);
      if (t * w_min > kEps) {
        // no g clipped: log t + (1 - g) log 2, the g part added at the end
        ext[1] = ext[1] + lt;
        ext[2] = ext[2] + 1.f;
      } else {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            // 2 m0 m1 w_g >= 1e-30: log t + (1 - g) log 2, else the clip
            const float v = t * w_of(g) >= kEps ? lt - (float)g * kLn2
                                                 : log_eps;
            acc[g] = acc[g] + v;
          }
        }
      }
    }
  }
  const float s = block_sums<kMaxG>(acc, G, part, ext, 3);
  if (threadIdx.x >= G && threadIdx.x < G + 3) tot[threadIdx.x - G] = s;
  __syncthreads();
  if (threadIdx.x < G) {
    const float g = (float)threadIdx.x;
    out[row * G + threadIdx.x] =
        (s + (tot[0] + tot[1])) - (g * kLn2) * tot[2];
  }
}

__global__ void __launch_bounds__(kThreads)
gen_curve_bwd_rows_kernel(const float* __restrict__ q,
                          const float* __restrict__ p,
                          const int8_t* __restrict__ geno,
                          const bool* __restrict__ hom,
                          const bool* __restrict__ valid,
                          const float* __restrict__ dper,
                          float* __restrict__ dm0_out,
                          float* __restrict__ dm1_out,
                          float* __restrict__ dq, int N, int L, int K, int A,
                          int G) {
  __shared__ float d_s[kMaxG];
  __shared__ float q_s[kMaxK];
  __shared__ float part[kWarps][kMaxK + 3];
  __shared__ float dsum_s;
  const long long row = blockIdx.x;
  const Row r = row_of(q, p, geno, hom, valid, N, L, K, A, row);
  if (threadIdx.x < G) d_s[threadIdx.x] = dper[row * G + threadIdx.x];
  if (threadIdx.x < K) q_s[threadIdx.x] = r.q[threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {
    float d = 0.f;
    for (int g = 0; g < G; ++g) d = d + d_s[g];
    dsum_s = d;
  }
  __syncthreads();
  const float dsum = dsum_s, w_min = w_of(G - 1);
  float acc[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) acc[k] = 0.f;
  float* dm0_row = dm0_out + row * L;
  float* dm1_row = dm1_out + row * L;
  for (int l = threadIdx.x; l < L; l += kThreads) {
    float dm0 = 0.f, dm1 = 0.f;
    if (r.valid[l]) {
      const int x0 = r.x0[l], x1 = r.x1[l];
      const float m0 = mixture(r, q_s, K, L, A, l, x0);
      if (r.hom[l]) {
        if (m0 >= kHomFast) {
          // dlog gf_g / dm0 = 1/m0 + w_g / (1 - u w_g) (g = 1: 2/m0),
          // no g clipped
          const float u = 1.f - m0;
          float sw = 0.f;
#pragma unroll
          for (int g = 1; g < kMaxG; ++g) {
            if (g < G) {
              const float w = w_of(g), x = u * w;
              sw = sw + d_s[g] * (g < kExact ? w / (1.f - x)
                                             : w_over_1mx_series(w, x));
            }
          }
          dm0 = (dsum + d_s[0]) / m0 + sw;
        } else {
          // JAX's form, g by g, zero where the clip binds
          const float a = m0 * m0, c = m0 * (1.f - m0);
#pragma unroll 1
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float w = w_of(g);
              const float gf = a + c * (1.f - w);
              if (gf > kEps) {
                const float num = (2.f * m0) * w + (1.f - w);
                dm0 = dm0 + (d_s[g] * num) / gf;
              }
            }
          }
        }
      } else {
        const float m1 = mixture(r, q_s, K, L, A, l, x1);
        const float t = (2.f * m0) * m1;
        float s = dsum;
        if (!(t * w_min > kEps)) {
          s = 0.f;
#pragma unroll 1
          for (int g = 0; g < kMaxG; ++g)
            if (g < G && t * w_of(g) > kEps) s = s + d_s[g];
        }
        // no g alive (t clipped at every g, e.g. m0 = 0): zero, not 0 / 0
        dm0 = s != 0.f ? s / m0 : 0.f;
        dm1 = s != 0.f ? s / m1 : 0.f;
      }
      // dq partials: dm0 P[k, l, x0] + dm1 P[k, l, x1]
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          const float* pk = r.p + ((long long)k * L + l) * A;
          acc[k] = acc[k] + (dm0 * __ldg(pk + x0) + dm1 * __ldg(pk + x1));
        }
      }
    }
    dm0_row[l] = dm0;
    dm1_row[l] = dm1;
  }
  const float s = block_sums<kMaxK>(acc, K, part, nullptr, 0);
  if (threadIdx.x < K) dq[row * K + threadIdx.x] = s;
}

// dP[b, k, l, a], pass 2a: a thread a (b, l, strip of individuals), the
// strip's individuals in order, one pass over them an allele; the strip's
// sums go to part[strip, b, k, l, a]
__global__ void __launch_bounds__(kColThreads)
gen_curve_bwd_cols_kernel(const float* __restrict__ q,
                          const int8_t* __restrict__ geno,
                          const float* __restrict__ dm0,
                          const float* __restrict__ dm1,
                          float* __restrict__ part, int B, int N, int L,
                          int K, int A, int strip_rows) {
  const int l = blockIdx.x * kColThreads + threadIdx.x;
  const long long b = blockIdx.y;
  const int n0 = blockIdx.z * strip_rows;
  const int n1 = min(N, n0 + strip_rows);
  if (l >= L) return;
  const float* qb = q + b * (long long)N * K;
  const float* d0 = dm0 + b * (long long)N * L + l;
  const float* d1 = dm1 + b * (long long)N * L + l;
  float* out = part + (blockIdx.z * (long long)B + b) * K * L * A;
  for (int a = 0; a < A; ++a) {
    float acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.f;
    for (int n = n0; n < n1; ++n) {
      const long long s = (long long)n * L;
      const int x0 = geno[2 * s + l], x1 = geno[2 * s + L + l];
      const float v0 = x0 == a ? __ldg(d0 + s) : 0.f;
      const float v1 = x1 == a ? __ldg(d1 + s) : 0.f;
      const float d = v0 + v1;
      if (d == 0.f) continue;
      const float* qn = qb + (long long)n * K;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) acc[k] = acc[k] + __ldg(qn + k) * d;
    }
    for (int k = 0; k < K; ++k) out[((long long)k * L + l) * A + a] = acc[k];
  }
}

// dP, pass 2b: the strips' sums in strip order
__global__ void gen_curve_bwd_strips_kernel(const float* __restrict__ part,
                                            float* __restrict__ dp,
                                            long long total, int strips) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = part[i];
  for (int j = 1; j < strips; ++j) s = s + part[j * total + i];
  dp[i] = s;
}

int check_shapes(int B, int N, int L, int K, int A, int G) {
  if (B < 1 || N < 1 || L < 1 || K < 1 || K > kMaxK || A < 1 || A > 127 ||
      G < 1 || G > kMaxG)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" int gen_curve_fwd_launch(const float* q, const float* p,
                                    const int8_t* geno, const bool* hom,
                                    const bool* valid, float* out, int B,
                                    int N, int L, int K, int A, int G,
                                    cudaStream_t stream) {
  if (int rc = check_shapes(B, N, L, K, A, G)) return rc;
  gen_curve_fwd_kernel<<<(unsigned)((long long)B * N), kThreads, 0,
                         stream>>>(q, p, geno, hom, valid, out, N, L, K, A,
                                   G);
  return (int)cudaGetLastError();
}

// Rows of a strip of pass 2a (kernels/gen_curve.py:col_strips): enough
// blocks to fill the card, each strip long enough to amortize its partials
extern "C" int gen_curve_strip_rows(int N) {
  const int strips = N / kStripMin < kMaxStrips ? N / kStripMin : kMaxStrips;
  const int s = strips < 1 ? 1 : strips;
  return (N + s - 1) / s;
}

extern "C" int gen_curve_bwd_launch(const float* q, const float* p,
                                    const int8_t* geno, const bool* hom,
                                    const bool* valid, const float* dper,
                                    float* dm0, float* dm1, float* dq,
                                    float* part, float* dp, int B, int N,
                                    int L, int K, int A, int G,
                                    cudaStream_t stream) {
  if (int rc = check_shapes(B, N, L, K, A, G)) return rc;
  gen_curve_bwd_rows_kernel<<<(unsigned)((long long)B * N), kThreads, 0,
                              stream>>>(q, p, geno, hom, valid, dper, dm0,
                                        dm1, dq, N, L, K, A, G);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const int rows = gen_curve_strip_rows(N);
  const int strips = (N + rows - 1) / rows;
  dim3 grid((L + kColThreads - 1) / kColThreads, B, strips);
  gen_curve_bwd_cols_kernel<<<grid, kColThreads, 0, stream>>>(
      q, geno, dm0, dm1, part, B, N, L, K, A, rows);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const long long total = (long long)B * K * L * A;
  gen_curve_bwd_strips_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                stream>>>(part, dp, total, strips);
  return (int)cudaGetLastError();
}
