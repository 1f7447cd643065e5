// The per-site pass of the diploid sweep: one kernel body for every entry
// point of instruct_tpu/kernels/fused_step.py:_site_pass (_site_kernel).
//
// A source that includes this file defines SITE_PACKED (1: the packed
// biallelic plane bits2; 0: the generic path, allele codes in [0, A) with
// separate valid and hom planes), SITE_SAMPLE (1: the pass draws z; 0: it
// evaluates a log-lik at the carried z) and SITE_LAUNCH (the name of its
// launch function).  The four sources are compiled side by side; each
// instantiates the body for K = 1..8 and for the log-lik families of its half:
//
//   family    sampling pass (at the FRESH z)            stored-step pass
//   none      zq_sample_pass                            -
//   mode1     zq_mode1_pass        ll[N]                panel_loglik_mode1_pass
//   gen       zq_gen_pass          ll[N, 2] (g, g')     panel_loglik_pass
//   gendiff   zq_gendiff_pass      G MH log-ratio [N]   -
//   find      zq_f_pass(pop=0)     F MH log-ratio [N]   panel_loglik_f_pass
//   fpop      zq_f_pass(pop=1)     F MH sums [N, K]     panel_loglik_f_pass
//
// A sampling pass draws per copy z ~ Cat(q_k * P[k, l, a]) by inverse CDF,
// counts each individual's copies per pop (qqnum) and -- packed path -- the
// [K, L, 2] allele-pop counts of the fresh z, and evaluates its family at
// that fresh z ("Z, then G | z" / "Z, then F | z": the old z is never read).
// A stored-step pass evaluates at the carried z planes.
//
// What bounds it: bytes and operations are of one order.  Per chain a
// sampling pass reads the site planes (N*L bytes packed, 3-4 N*L generic) and
// writes z (2 N*L); a stored-step pass reads both.  Per allele copy it does a
// few dozen float operations, a quarter of a Philox block when sampling, and
// up to one log or division per site.
// Design: the TPU grid runs in order and accumulates into resident outputs;
// here a block owns a tile of 1024 loci x a strip of 32 individuals of one
// chain and nothing is carried between blocks.
//   * Each thread owns 4 consecutive loci (one Philox block per copy and
//     row).  Packed path: their P rows stay in registers for the whole strip,
//     and the thread counts the fresh z of its loci in registers over the
//     strip's rows, so the allele-pop counts cost one atomicAdd per (pop,
//     allele, locus, strip); they are integer-valued floats far below 2^24,
//     so the atomic sum is exact whatever its order.  Generic path: P[k, l, a]
//     is read through the read-only cache at the allele code of the copy (a
//     code outside [0, A) gives w = 0), and K*A counters per locus do not fit
//     registers, so the pass returns no allele-pop counts: the step recounts
//     with the allele_counts kernel.
//   * The real-valued sums never go through a float atomic: a warp
//     butterfly, then the block's 8 warp partials in order, give one partial
//     per (individual, locus tile, column); a second small kernel adds the
//     tiles in order.  Two runs from one seed are therefore bitwise equal.
//   * The planes are indexed directly and ragged edges masked: no (8, 128)
//     padding, no copy-major double pass, no [K*A, L] transposes.
// The sources are compiled without FMA contraction, so the CDF prefixes
// (packed: cumA + q*f0 and cumB + q*d, affine in the allele bit; generic:
// cum + q_k * w_k) round exactly as in the plain PyTorch versions and both
// give the same z everywhere from the same uniforms.
#pragma once
#include "quad.cuh"

namespace {

// Launch shape; instruct_tpu_torch/tools/site_pass_variants.py times other
// values.
#ifndef SITE_THREADS
#define SITE_THREADS 256
#endif
#ifndef SITE_ROWS
#define SITE_ROWS 32
#endif
#ifndef SITE_MIN_BLOCKS
#define SITE_MIN_BLOCKS 1
#endif
constexpr int kThreads = SITE_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kQuad;   // loci per block
constexpr int kRows = SITE_ROWS;          // individuals per block
constexpr float kEps = 1e-30f;
constexpr float kLog2 = 0.6931471805599453f;
constexpr bool kPacked = SITE_PACKED != 0;
constexpr bool kSample = SITE_SAMPLE != 0;

// Log-lik families; keep in step with kernels/fused_step.py.
enum : int {
  kFamNone = 0, kFamMode1 = 1, kFamGen = 2, kFamGendiff = 3, kFamFind = 4,
  kFamFpop = 5
};

// Per-thread accumulators and output columns of a family.
template <int FAM, int K>
struct Cols {
  // columns of colv / fvals read: (current, proposed) when sampling
  static constexpr int kIn = kSample ? 2 : 1;
  static constexpr int kAcc =
      FAM == kFamNone ? 0
      : FAM == kFamGendiff ? 2                       // log sum, het count
      : FAM == kFamGen ? kIn
      : (FAM == kFamFpop && kSample) ? K : 1;
  static constexpr int kOut = FAM == kFamGendiff ? 1 : kAcc;
  static constexpr int kQq = kSample ? K : 0;
};

struct SiteArgs {
  const float* q;          // [C, N, K]; may be null where it is not read
  const float* freq;       // [C, K, L, A]
  const int8_t* bits2;     // [N, L] packed plane (or one per chain)
  const int8_t* geno;      // [N, 2L] allele codes (generic; or per chain)
  const int8_t* valid;     // [N, L] bool (generic)
  const int8_t* hom;       // [N, L] bool (generic)
  const int8_t* z_in;      // [C, N, 2L] carried z (stored-step pass)
  const float* colv;       // [C, N, kIn] per-individual columns
  const float* fvals;      // [C, K, kIn] per-pop F
  const float* u;          // [C, N, 2L] injected uniforms, or null
  int8_t* z;               // [C, N, 2L] out
  float* zcounts;          // [C, K, L, 2] out (packed sampling pass)
  float* ll_part;          // [C, N, T, kOut]
  float* qq_part;          // [C, N, T, K]
  int N, L, A, T, structure;
  long long plane_cs;      // chain stride of bits2 / geno: 0 when the chains
  //                          share the panel, N*L / N*2L when each chain has
  //                          its own (the tetraploid engine's latent genotype)
  uint32_t k0, k1, step;
  const int* chain_key;
};

__device__ __forceinline__ float slog(float x) {
  return logf(fmaxf(x, kEps));
}

template <int K>
__device__ __forceinline__ float sel(const float (&rows)[K], int z) {
  float out = rows[0];
#pragma unroll
  for (int k = 1; k < K; ++k) out = z == k ? rows[k] : out;
  return out;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// P rows of the thread's 4 loci: f0 = P[k, l, 0], d = P[k, l, 1] - f0.
template <int K>
__device__ __forceinline__ void load_freq(const float* freq, int c, int L,
                                          int l0, float (&f0)[kQuad][K],
                                          float (&d)[kQuad][K]) {
#pragma unroll
  for (int j = 0; j < kQuad; ++j) {
    const int l = l0 + j;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float a = 0.0f, b = 0.0f;
      if (l < L) {
        const float2 p = *reinterpret_cast<const float2*>(
            freq + (((long long)c * K + k) * L + l) * 2);
        a = p.x;
        b = p.y;
      }
      f0[j][k] = a;
      d[j][k] = b - a;
    }
  }
}

// P[k, l, g] of every pop at one allele copy of the generic path; a code
// outside [0, A) (never produced by make_dataset, which codes a missing copy
// as 0 on an invalid site) reads nothing and weighs 0.
template <int K>
__device__ __forceinline__ void copy_probs(const float* freq, int c, int L,
                                           int A, int l, int g,
                                           float (&w)[K]) {
  const bool ok = g >= 0 && g < A;
#pragma unroll
  for (int k = 0; k < K; ++k)
    w[k] = ok ? __ldg(freq + (((long long)c * K + k) * L + l) * A + g) : 0.0f;
}

// CDF prefixes cum[0..K-1] of one copy's z draw.  Packed path: affine in the
// allele bit, cum_j = PA[j] + PB[j] * g.  Generic path: cum += q_k * w_k.
template <int K>
__device__ __forceinline__ void cdf_prefixes(const float (&qk)[K],
                                             const float (&f0)[K],
                                             const float (&d)[K],
                                             const float (&w)[K], float gf,
                                             float (&cum)[K]) {
  if constexpr (kPacked) {
    float ca = qk[0] * f0[0], cb = qk[0] * d[0];
    cum[0] = ca + cb * gf;
#pragma unroll
    for (int k = 1; k < K; ++k) {
      ca = ca + qk[k] * f0[k];
      cb = cb + qk[k] * d[k];
      cum[k] = ca + cb * gf;
    }
  } else {
    float cc = qk[0] * w[0];
    cum[0] = cc;
#pragma unroll
    for (int k = 1; k < K; ++k) {
      cc = cc + qk[k] * w[k];
      cum[k] = cc;
    }
  }
}

template <int K>
__device__ __forceinline__ int inverse_cdf(float u01, const float (&cum)[K]) {
  const float ut = u01 * cum[K - 1];
  int z = 0;
#pragma unroll
  for (int j = 0; j < K - 1; ++j) z += ut > cum[j] ? 1 : 0;
  return z;
}

template <int K, int FAM>
__global__ void __launch_bounds__(kThreads, SITE_MIN_BLOCKS)
site_kernel(const SiteArgs a) {
  using CL = Cols<FAM, K>;
  constexpr int kNV = CL::kQq + CL::kAcc;
  constexpr bool kGenFam = FAM == kFamGen || FAM == kFamGendiff;
  constexpr bool kNeedHom = FAM >= kFamGen;
  constexpr bool kNeedCol = kGenFam || FAM == kFamFind;
  __shared__ float part[kRows][kWarps][kNV > 0 ? kNV : 1];
  const int N = a.N, L = a.L, T = a.T;
  const int tile = blockIdx.x, c = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int l0 = tile * kTile + tid * kQuad;
  const bool vec = (L % 4) == 0;
  const int n_live = min(kQuad, L - l0);       // <= 0: thread has no locus
  const bool structure = a.structure != 0;
  // the expectation way reads the Q mixture in place of P at z
  const bool mix = kGenFam && !structure;
  const bool need_q = kSample || mix;

  // packed path: the P rows of the thread's loci, and its counts of copies
  // with z = k (cs) and with z = k and allele bit 1 (ct)
  float f0[kQuad][K], d[kQuad][K];
  int cs[kQuad][K], ct[kQuad][K];
#pragma unroll
  for (int j = 0; j < kQuad; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      f0[j][k] = d[j][k] = 0.0f;
      cs[j][k] = ct[j][k] = 0;
    }
  if constexpr (kPacked) load_freq<K>(a.freq, c, L, l0, f0, d);
  float fv0[K], fv1[K];                        // per-pop F (current, proposed)
#pragma unroll
  for (int k = 0; k < K; ++k) {
    fv0[k] = fv1[k] = 0.0f;
    if constexpr (FAM == kFamFpop) {
      fv0[k] = a.fvals[((long long)c * K + k) * CL::kIn];
      if constexpr (kSample) fv1[k] = a.fvals[((long long)c * K + k) * 2 + 1];
    }
  }
  uint32_t chain = 0;
  if constexpr (kSample) chain = (uint32_t)a.chain_key[c];

  const int n_begin = blockIdx.y * kRows;
  const int n_rows = min(kRows, N - n_begin);
  for (int r = 0; r < n_rows; ++r) {
    const int n = n_begin + r;
    const long long cn = (long long)c * N + n;
    float qk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) qk[k] = need_q ? a.q[cn * K + k] : 0.0f;
    float cv0 = 0.0f, cv1 = 0.0f;
    if constexpr (kNeedCol) {
      cv0 = a.colv[cn * CL::kIn];
      if constexpr (CL::kIn == 2) cv1 = a.colv[cn * 2 + 1];
    }
    float acc[CL::kAcc > 0 ? CL::kAcc : 1], qq[K];
#pragma unroll
    for (int i = 0; i < (CL::kAcc > 0 ? CL::kAcc : 1); ++i) acc[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) qq[k] = 0.0f;

    if (n_live > 0) {
      int g0v[kQuad], g1v[kQuad], okv[kQuad], homv[kQuad];
      if constexpr (kPacked) {
        int bits[kQuad];
        load_bytes(a.bits2 + c * a.plane_cs + (long long)n * L, l0, L, vec,
                   bits);
#pragma unroll
        for (int j = 0; j < kQuad; ++j) {
          g0v[j] = bits[j] & 1;
          g1v[j] = (bits[j] >> 1) & 1;
          okv[j] = bits[j] & 4;
          homv[j] = g0v[j] == g1v[j] ? 1 : 0;
        }
      } else {
        const int8_t* grow = a.geno + c * a.plane_cs + (long long)n * 2 * L;
        load_bytes(grow, l0, L, vec, g0v);
        load_bytes(grow + L, l0, L, vec, g1v);
        load_bytes(a.valid + (long long)n * L, l0, L, vec, okv);
        if constexpr (kNeedHom) {
          load_bytes(a.hom + (long long)n * L, l0, L, vec, homv);
        } else {
#pragma unroll
          for (int j = 0; j < kQuad; ++j) homv[j] = 0;
        }
      }
      int z0v[kQuad], z1v[kQuad];
      float u0[kQuad], u1[kQuad];
      if constexpr (kSample) {
        const long long row = (long long)n * 2 * L;
        const float* inj =
            a.u == nullptr ? nullptr : a.u + (long long)c * N * 2 * L;
        quad_uniforms(inj, row + l0, n_live, a.step, chain, a.k0, a.k1, u0);
        quad_uniforms(inj, row + L + l0, n_live, a.step, chain, a.k0, a.k1,
                      u1);
      } else {
        load_bytes(a.z_in + cn * 2 * L, l0, L, vec, z0v);
        load_bytes(a.z_in + cn * 2 * L + L, l0, L, vec, z1v);
      }
#pragma unroll
      for (int j = 0; j < kQuad; ++j) {
        if (j >= n_live) {
          z0v[j] = z1v[j] = 0;
          continue;
        }
        const int g0 = g0v[j], g1 = g1v[j];
        const bool valid = okv[j] != 0, hom = homv[j] != 0;
        const float g0f = (float)g0, g1f = (float)g1;
        // per-pop probability of each copy's allele
        float w0[K], w1[K];
        if constexpr (kPacked) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            w0[k] = f0[j][k] + d[j][k] * g0f;
            w1[k] = f0[j][k] + d[j][k] * g1f;
          }
        } else {
          copy_probs<K>(a.freq, c, L, a.A, l0 + j, g0, w0);
          copy_probs<K>(a.freq, c, L, a.A, l0 + j, g1, w1);
        }
        float tot0 = 0.0f, tot1 = 0.0f;          // Q-mixture probabilities
        if (need_q) {
          float cum0[K], cum1[K];
          cdf_prefixes<K>(qk, f0[j], d[j], w0, g0f, cum0);
          cdf_prefixes<K>(qk, f0[j], d[j], w1, g1f, cum1);
          tot0 = cum0[K - 1];
          tot1 = cum1[K - 1];
          if constexpr (kSample) {
            z0v[j] = inverse_cdf<K>(u0[j], cum0);
            z1v[j] = inverse_cdf<K>(u1[j], cum1);
          }
        }
        if (!valid) continue;
        const int z0 = z0v[j], z1 = z1v[j];      // the conditioning z
        if constexpr (kSample) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int m0 = z0 == k ? 1 : 0, m1 = z1 == k ? 1 : 0;
            qq[k] += (float)(m0 + m1);
            if constexpr (kPacked) {
              cs[j][k] += m0 + m1;
              ct[j][k] += (m0 & g0) + (m1 & g1);
            }
          }
        }
        if constexpr (FAM != kFamNone) {
          const float p0 = mix ? tot0 : sel<K>(w0, z0);
          const float p1 = mix ? tot1 : sel<K>(w1, z1);
          const bool same = z0 == z1;
          if constexpr (FAM == kFamMode1) {
            // cal_lkh of the no-selfing model (log_ld_noselfing_indv)
            acc[0] = acc[0] +
                     (slog(p0) + slog(p1) + (g0 != g1 ? kLog2 : 0.0f));
          } else if constexpr (FAM == kFamGen) {
            // selfing-generation columns (log_ld_indv); colv = 2^(1-g)
            const float indep = slog(p0) + slog(p1) + (hom ? 0.0f : kLog2);
#pragma unroll
            for (int col = 0; col < CL::kIn; ++col) {
              const float wg = col == 0 ? cv0 : cv1;
              const float gf = hom ? p0 * p0 + p0 * (1.0f - p0) * (1.0f - wg)
                                   : 2.0f * p0 * p1 * wg;
              float site = slog(gf);
              if (structure && !same) site = indep;
              acc[col] = acc[col] + site;
            }
          } else if constexpr (FAM == kFamGendiff) {
            // G-update MH log-ratio (update_G): only hom sites take a log,
            // het sites add the row constant log(w_p / w_c) once per site
            if (mix || same) {
              if (hom) {
                const float q1 = 1.0f - p0;
                const float ratio = fmaxf(1.0f - q1 * cv1, kEps) /
                                    fmaxf(1.0f - q1 * cv0, kEps);
                acc[0] = acc[0] + logf(ratio);
              } else {
                acc[1] += 1.0f;
              }
            }
          } else {
            // inbreeding families: f per individual (find) or of pop z0 (fpop)
            const float fa = FAM == kFamFind ? cv0 : sel<K>(fv0, z0);
            if constexpr (kSample) {
              // MH terms over the F-dependent same-z sites: one log of a
              // quotient, the common p0 / 2 p0 p1 factors cancelled
              if (same) {
                const float fb = FAM == kFamFind ? cv1 : sel<K>(fv1, z0);
                const float num = hom ? p0 * (1.0f - fb) + fb : 1.0f - fb;
                const float den = hom ? p0 * (1.0f - fa) + fa : 1.0f - fa;
                const float dl = logf(fmaxf(num, kEps) / fmaxf(den, kEps));
                if constexpr (FAM == kFamFind) {
                  acc[0] = acc[0] + dl;
                } else {
#pragma unroll
                  for (int k = 0; k < K; ++k)
                    if (z0 == k) acc[k] = acc[k] + dl;
                }
              }
            } else {
              // cal_lkh (log_ld_F_indv / log_ld_F_pop)
              float site;
              if (same) {
                site = slog(hom ? p0 * p0 * (1.0f - fa) + p0 * fa
                                : 2.0f * p0 * p1 * (1.0f - fa));
              } else {
                site = slog(p0) + slog(p1) + (hom ? 0.0f : kLog2);
              }
              acc[0] = acc[0] + site;
            }
          }
        }
      }
      if constexpr (kSample) {
        int8_t* zrow = a.z + cn * 2 * L;
        store_bytes(zrow, l0, L, vec, z0v);
        store_bytes(zrow + L, l0, L, vec, z1v);
      }
    }

    if constexpr (kNV > 0) {
#pragma unroll
      for (int k = 0; k < CL::kQq; ++k) {
        const float s = warp_sum(qq[k]);
        if (lane == 0) part[r][warp][k] = s;
      }
#pragma unroll
      for (int i = 0; i < CL::kAcc; ++i) {
        const float s = warp_sum(acc[i]);
        if (lane == 0) part[r][warp][CL::kQq + i] = s;
      }
    }
  }
  __syncthreads();

  // one partial per (individual, locus tile, column): the warps in order
  constexpr int kCols = CL::kQq + CL::kOut;
  for (int i = tid; i < n_rows * kCols; i += kThreads) {
    const int r = i / kCols, v = i - r * kCols;
    const long long cn = (long long)c * N + n_begin + r;
    // the accumulators follow the qq columns in `part`
    float s = part[r][0][v];
    for (int w = 1; w < kWarps; ++w) s = s + part[r][w][v];
    if (v < CL::kQq) {
      a.qq_part[(cn * T + tile) * K + v] = s;
      continue;
    }
    if constexpr (FAM == kFamGendiff) {
      float t = part[r][0][CL::kQq + 1];
      for (int w = 1; w < kWarps; ++w) t = t + part[r][w][CL::kQq + 1];
      const float dh = slog(a.colv[2 * cn + 1]) - slog(a.colv[2 * cn]);
      s = s + dh * t;
    }
    a.ll_part[(cn * T + tile) * CL::kOut + (v - CL::kQq)] = s;
  }

  if constexpr (kPacked && kSample) {
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      if (j >= n_live) continue;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float* cell = a.zcounts + (((long long)c * K + k) * L + l0 + j) * 2;
        const int ones = ct[j][k], zeros = cs[j][k] - ct[j][k];
        if (zeros != 0) atomicAdd(cell, (float)zeros);
        if (ones != 0) atomicAdd(cell + 1, (float)ones);
      }
    }
  }
}

// Adds the locus tiles' partials of every (chain, individual, column) in
// order: thread i owns column i % cols of row i / cols, the ll columns first.
__global__ void site_reduce_kernel(const float* __restrict__ ll_part,
                                   const float* __restrict__ qq_part,
                                   float* __restrict__ ll,
                                   float* __restrict__ qqnum, long long CN,
                                   int T, int n_out, int n_qq) {
  const int cols = n_out + n_qq;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= CN * cols) return;
  const long long cn = i / cols;
  int v = (int)(i - cn * cols);
  const float* src = ll_part;
  float* dst = ll;
  int width = n_out;
  if (v >= n_out) {
    v -= n_out;
    src = qq_part;
    dst = qqnum;
    width = n_qq;
  }
  float s = src[cn * T * width + v];
  for (int t = 1; t < T; ++t) s = s + src[(cn * T + t) * width + v];
  dst[cn * width + v] = s;
}

inline int site_tiles(int L) { return (L + kTile - 1) / kTile; }

template <int FAM>
int launch_family(int K, const SiteArgs& a, dim3 grid, cudaStream_t s) {
#define SITE_CASE(KK)                                        \
  case KK:                                                   \
    site_kernel<KK, FAM><<<grid, kThreads, 0, s>>>(a);       \
    break;
  switch (K) {
#ifdef SITE_K_ONLY
    SITE_CASE(SITE_K_ONLY)
#else
    SITE_CASE(1) SITE_CASE(2) SITE_CASE(3) SITE_CASE(4)
    SITE_CASE(5) SITE_CASE(6) SITE_CASE(7) SITE_CASE(8)
#endif
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SITE_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// One launch function per source (SITE_LAUNCH).  `fam` is a kFam* value; the
// operand groups a family does not read may be null.  ll [C, N, n_out] and
// the scratch ll_part [C, N, T, n_out], qq_part [C, N, T, K] are sized by the
// wrapper with T = site_pass_tiles(L) and n_out as in Cols.
extern "C" int SITE_LAUNCH(
    const void* q, const void* freq, const void* bits2, const void* geno,
    const void* valid, const void* hom, const void* z_in, const void* colv,
    const void* fvals, const void* u, void* z, void* qqnum, void* zcounts,
    void* ll, void* ll_part, void* qq_part, int C, int N, int L, int K, int A,
    int fam, int structure, long long plane_cs, unsigned k0, unsigned k1,
    const void* chain_key, unsigned step, void* stream) {
  if (C == 0 || N == 0 || L == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  SiteArgs a;
  a.q = (const float*)q;
  a.freq = (const float*)freq;
  a.bits2 = (const int8_t*)bits2;
  a.geno = (const int8_t*)geno;
  a.valid = (const int8_t*)valid;
  a.hom = (const int8_t*)hom;
  a.z_in = (const int8_t*)z_in;
  a.colv = (const float*)colv;
  a.fvals = (const float*)fvals;
  a.u = (const float*)u;
  a.z = (int8_t*)z;
  a.zcounts = (float*)zcounts;
  a.ll_part = (float*)ll_part;
  a.qq_part = (float*)qq_part;
  a.N = N;
  a.L = L;
  a.A = A;
  a.T = site_tiles(L);
  a.structure = structure;
  a.plane_cs = plane_cs;
  a.k0 = k0;
  a.k1 = k1;
  a.step = step;
  a.chain_key = (const int*)chain_key;
  if (kPacked && kSample)
    cudaMemsetAsync(zcounts, 0, sizeof(float) * (size_t)C * K * L * 2, s);
  const dim3 grid(a.T, (N + kRows - 1) / kRows, C);
  int rc, n_out;
  switch (fam) {
    case kFamMode1:
      rc = launch_family<kFamMode1>(K, a, grid, s);
      n_out = 1;
      break;
    case kFamGen:
      rc = launch_family<kFamGen>(K, a, grid, s);
      n_out = kSample ? 2 : 1;
      break;
    case kFamFind:
      rc = launch_family<kFamFind>(K, a, grid, s);
      n_out = 1;
      break;
    case kFamFpop:
      rc = launch_family<kFamFpop>(K, a, grid, s);
      n_out = kSample ? K : 1;
      break;
#if SITE_SAMPLE
    case kFamNone:
      rc = launch_family<kFamNone>(K, a, grid, s);
      n_out = 0;
      break;
    case kFamGendiff:
      rc = launch_family<kFamGendiff>(K, a, grid, s);
      n_out = 1;
      break;
#endif
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  const int n_qq = kSample ? K : 0;
  const long long total = (long long)C * N * (n_out + n_qq);
  if (total == 0) return 0;
  const int threads = 128;
  site_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                       0, s>>>((const float*)ll_part, (const float*)qq_part,
                               (float*)ll, (float*)qqnum, (long long)C * N,
                               a.T, n_out, n_qq);
  return (int)cudaGetLastError();
}
