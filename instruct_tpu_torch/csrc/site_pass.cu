// The per-site pass of the diploid sweep, packed biallelic panel.
//
// Replaces the TPU kernel _site_pass / _site_kernel of
// instruct_tpu/kernels/fused_step.py for its two mode-2 entry points:
//   * zq_gendiff_pass  (sample = True, ll_kind = "gendiff"): per-copy
//     z ~ Cat(q_k * P[k, l, a]) by inverse CDF, per-individual pop counts,
//     the [K, L, A] allele-pop counts of the fresh z, and the G-update MH
//     log-ratio at that fresh z ("Z, then G | z": z_old is not read);
//   * panel_loglik_pass (sample = False, ll_kind = "gen", one column):
//     cal_lkh per individual at the carried z.
//
// What bounds it: bytes and operations are of one order here.  Per chain the
// sampling pass must read bits2 (N*L bytes) and write z (2*N*L bytes); the
// log-lik pass reads both.  Per allele copy it does a few dozen float
// operations and a quarter of a Philox block; by the operation count of
// chip_smoke.py that puts the sampling pass's bound at about twice its byte
// time, and the log-lik pass's at its byte time.
// Design: the TPU grid runs in order and accumulates into resident outputs;
// here a block owns a tile of 1024 loci x a strip of 32 individuals of one
// chain and nothing is carried between blocks.
//   * Each thread owns 4 consecutive loci (one Philox block per copy and
//     row), keeps their P rows in registers for the whole strip, and counts
//     the fresh z of its loci in registers over the strip's rows, so the
//     allele-pop counts cost one atomicAdd per (pop, allele, locus, strip).
//     They are integer-valued floats far below 2^24, so the atomic sum is
//     exact whatever its order.
//   * The real-valued log-lik sums never go through a float atomic: a warp
//     butterfly, then the block's 8 warp partials in order, give one partial
//     per (individual, locus tile); a second small kernel adds the tiles in
//     order.  Two runs from one seed are therefore bitwise equal.
//   * bits2 [N, L], z [C, N, 2L], freq [C, K, L, 2] and q [C, N, K] are
//     indexed directly and ragged edges masked: no (8, 128) padding, no
//     copy-major double pass, no [K*A, L] transposes.
// The file is compiled without FMA contraction, so the CDF prefixes
// cumA + q*f0 round exactly as in the plain PyTorch version and both give
// the same z everywhere from the same uniforms.
#include "philox.cuh"

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
constexpr int kQuad = 4;
constexpr int kTile = kThreads * kQuad;   // loci per block
constexpr int kRows = SITE_ROWS;          // individuals per block
constexpr float kEps = 1e-30f;
constexpr float kLog2 = 0.6931471805599453f;

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

// CDF prefixes of one site, affine in the allele indicator g:
// cum_j(g) = A[j] + B[j] * g.
template <int K>
__device__ __forceinline__ void prefixes(const float (&qk)[K],
                                         const float (&f0)[K],
                                         const float (&d)[K], float (&A)[K],
                                         float (&B)[K]) {
  float ca = qk[0] * f0[0], cb = qk[0] * d[0];
  A[0] = ca;
  B[0] = cb;
#pragma unroll
  for (int k = 1; k < K; ++k) {
    ca = ca + qk[k] * f0[k];
    cb = cb + qk[k] * d[k];
    A[k] = ca;
    B[k] = cb;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, SITE_MIN_BLOCKS)
site_gendiff_kernel(
    const float* __restrict__ q, const float* __restrict__ freq,
    const int8_t* __restrict__ bits2, const float* __restrict__ wg_pair,
    const float* __restrict__ u_inj, int8_t* __restrict__ z,
    float* __restrict__ zcounts, float* __restrict__ ll_part,
    float* __restrict__ qq_part, int N, int L, int T, int structure,
    uint32_t k0, uint32_t k1, const int* __restrict__ chain_key,
    uint32_t step) {
  __shared__ float part[kRows][kWarps][K + 2];
  const int tile = blockIdx.x, c = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int l0 = tile * kTile + tid * kQuad;
  const bool vec = (L % 4) == 0;
  const int n_live = min(kQuad, L - l0);       // <= 0: thread has no locus
  const uint32_t chain = (uint32_t)chain_key[c];

  float f0[kQuad][K], d[kQuad][K];
  load_freq<K>(freq, c, L, l0, f0, d);
  int cs[kQuad][K], ct[kQuad][K];              // copies with z = k; with g = 1
#pragma unroll
  for (int j = 0; j < kQuad; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) cs[j][k] = ct[j][k] = 0;

  const int n_begin = blockIdx.y * kRows;
  const int n_rows = min(kRows, N - n_begin);
  for (int r = 0; r < n_rows; ++r) {
    const int n = n_begin + r;
    const long long cn = (long long)c * N + n;
    float qk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) qk[k] = q[cn * K + k];
    const float wc = wg_pair[2 * cn], wp = wg_pair[2 * cn + 1];
    float llh = 0.0f, nt = 0.0f, qq[K];
#pragma unroll
    for (int k = 0; k < K; ++k) qq[k] = 0.0f;

    if (n_live > 0) {
      int bits[kQuad], z0v[kQuad], z1v[kQuad];
      load_bytes(bits2 + (long long)n * L, l0, L, vec, bits);
      float u0[kQuad], u1[kQuad];
      const long long row = (long long)n * 2 * L;
      const float* inj =
          u_inj == nullptr ? nullptr : u_inj + (long long)c * N * 2 * L;
      quad_uniforms(inj, row + l0, n_live, step, chain, k0, k1, u0);
      quad_uniforms(inj, row + L + l0, n_live, step, chain, k0, k1, u1);
#pragma unroll
      for (int j = 0; j < kQuad; ++j) {
        z0v[j] = z1v[j] = 0;
        if (j >= n_live) continue;
        const int b = bits[j];
        const int g0 = b & 1, g1 = (b >> 1) & 1;
        const bool valid = (b & 4) != 0;
        const float g0f = (float)g0, g1f = (float)g1;
        float A[K], B[K];
        prefixes<K>(qk, f0[j], d[j], A, B);
        const float tot0 = A[K - 1] + B[K - 1] * g0f;
        const float tot1 = A[K - 1] + B[K - 1] * g1f;
        const float ut0 = u0[j] * tot0, ut1 = u1[j] * tot1;
        int z0 = 0, z1 = 0;
#pragma unroll
        for (int jj = 0; jj < K - 1; ++jj) {
          z0 += ut0 > A[jj] + B[jj] * g0f ? 1 : 0;
          z1 += ut1 > A[jj] + B[jj] * g1f ? 1 : 0;
        }
        z0v[j] = z0;
        z1v[j] = z1;
        if (valid) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int m0 = z0 == k ? 1 : 0, m1 = z1 == k ? 1 : 0;
            qq[k] += (float)(m0 + m1);
            cs[j][k] += m0 + m1;
            ct[j][k] += (m0 & g0) + (m1 & g1);
          }
          // G-update MH log-ratio (update_G): only hom sites take a log,
          // het sites add the row constant log(w_p / w_c) once per site
          float p0;
          bool m;
          if (structure) {
            p0 = sel<K>(f0[j], z0) + sel<K>(d[j], z0) * g0f;
            m = z0 == z1;
          } else {
            p0 = tot0;
            m = true;
          }
          if (m) {
            if (g0 == g1) {
              const float q1 = 1.0f - p0;
              const float ratio = fmaxf(1.0f - q1 * wp, kEps) /
                                  fmaxf(1.0f - q1 * wc, kEps);
              llh = llh + logf(ratio);
            } else {
              nt += 1.0f;
            }
          }
        }
      }
      int8_t* zrow = z + cn * 2 * L;
      store_bytes(zrow, l0, L, vec, z0v);
      store_bytes(zrow + L, l0, L, vec, z1v);
    }

    llh = warp_sum(llh);
    nt = warp_sum(nt);
#pragma unroll
    for (int k = 0; k < K; ++k) qq[k] = warp_sum(qq[k]);
    if (lane == 0) {
      part[r][warp][0] = llh;
      part[r][warp][1] = nt;
#pragma unroll
      for (int k = 0; k < K; ++k) part[r][warp][2 + k] = qq[k];
    }
  }
  __syncthreads();

  for (int i = tid; i < n_rows * (K + 1); i += kThreads) {
    const int r = i / (K + 1), v = i - r * (K + 1);
    const long long cn = (long long)c * N + n_begin + r;
    if (v < K) {
      float s = part[r][0][2 + v];
      for (int w = 1; w < kWarps; ++w) s = s + part[r][w][2 + v];
      qq_part[(cn * T + tile) * K + v] = s;
    } else {
      float s = part[r][0][0], t = part[r][0][1];
      for (int w = 1; w < kWarps; ++w) {
        s = s + part[r][w][0];
        t = t + part[r][w][1];
      }
      const float dh = slog(wg_pair[2 * cn + 1]) - slog(wg_pair[2 * cn]);
      ll_part[cn * T + tile] = s + dh * t;
    }
  }

#pragma unroll
  for (int j = 0; j < kQuad; ++j) {
    if (j >= n_live) continue;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float* cell = zcounts + (((long long)c * K + k) * L + l0 + j) * 2;
      const int ones = ct[j][k], zeros = cs[j][k] - ct[j][k];
      if (zeros != 0) atomicAdd(cell, (float)zeros);
      if (ones != 0) atomicAdd(cell + 1, (float)ones);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads) site_loglik_kernel(
    const float* __restrict__ q, const float* __restrict__ freq,
    const int8_t* __restrict__ bits2, const int8_t* __restrict__ z,
    const float* __restrict__ wg, float* __restrict__ ll_part, int N, int L,
    int T, int structure) {
  __shared__ float part[kRows][kWarps];
  const int tile = blockIdx.x, c = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int l0 = tile * kTile + tid * kQuad;
  const bool vec = (L % 4) == 0;
  const int n_live = min(kQuad, L - l0);

  float f0[kQuad][K], d[kQuad][K];
  load_freq<K>(freq, c, L, l0, f0, d);

  const int n_begin = blockIdx.y * kRows;
  const int n_rows = min(kRows, N - n_begin);
  for (int r = 0; r < n_rows; ++r) {
    const int n = n_begin + r;
    const long long cn = (long long)c * N + n;
    float qk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) qk[k] = q[cn * K + k];
    const float w = wg[cn];
    float ll = 0.0f;
    if (n_live > 0) {
      int bits[kQuad], z0v[kQuad], z1v[kQuad];
      load_bytes(bits2 + (long long)n * L, l0, L, vec, bits);
      load_bytes(z + cn * 2 * L, l0, L, vec, z0v);
      load_bytes(z + cn * 2 * L + L, l0, L, vec, z1v);
#pragma unroll
      for (int j = 0; j < kQuad; ++j) {
        if (j >= n_live) continue;
        const int b = bits[j];
        if ((b & 4) == 0) continue;
        const int g0 = b & 1, g1 = (b >> 1) & 1;
        const bool hom = g0 == g1;
        const float g0f = (float)g0, g1f = (float)g1;
        float p0, p1;
        if (structure) {
          p0 = sel<K>(f0[j], z0v[j]) + sel<K>(d[j], z0v[j]) * g0f;
          p1 = sel<K>(f0[j], z1v[j]) + sel<K>(d[j], z1v[j]) * g1f;
        } else {
          float A[K], B[K];
          prefixes<K>(qk, f0[j], d[j], A, B);
          p0 = A[K - 1] + B[K - 1] * g0f;
          p1 = A[K - 1] + B[K - 1] * g1f;
        }
        const float gf = hom ? p0 * p0 + p0 * (1.0f - p0) * (1.0f - w)
                             : 2.0f * p0 * p1 * w;
        float site = slog(gf);
        if (structure && z0v[j] != z1v[j])
          site = slog(p0) + slog(p1) + (hom ? 0.0f : kLog2);
        ll = ll + site;
      }
    }
    ll = warp_sum(ll);
    if (lane == 0) part[r][warp] = ll;
  }
  __syncthreads();
  for (int r = tid; r < n_rows; r += kThreads) {
    float s = part[r][0];
    for (int w = 1; w < kWarps; ++w) s = s + part[r][w];
    ll_part[((long long)c * N + n_begin + r) * T + tile] = s;
  }
}

// Adds the locus tiles' partials of every (chain, individual) in order.
__global__ void site_reduce_kernel(const float* __restrict__ ll_part,
                                   const float* __restrict__ qq_part,
                                   float* __restrict__ ll,
                                   float* __restrict__ qqnum, long long CN,
                                   int T, int K) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= CN) return;
  float s = ll_part[i * T];
  for (int t = 1; t < T; ++t) s = s + ll_part[i * T + t];
  ll[i] = s;
  if (qq_part == nullptr) return;
  for (int k = 0; k < K; ++k) {
    float c = qq_part[i * T * K + k];
    for (int t = 1; t < T; ++t) c = c + qq_part[(i * T + t) * K + k];
    qqnum[i * K + k] = c;
  }
}

void launch_reduce(const float* ll_part, const float* qq_part, float* ll,
                   float* qqnum, long long CN, int T, int K,
                   cudaStream_t s) {
  const int threads = 128;
  site_reduce_kernel<<<(unsigned)((CN + threads - 1) / threads), threads, 0,
                       s>>>(ll_part, qq_part, ll, qqnum, CN, T, K);
}

}  // namespace

#define DISPATCH_K(K, CALL)                    \
  switch (K) {                                 \
    case 1: { CALL(1); break; }                \
    case 2: { CALL(2); break; }                \
    case 3: { CALL(3); break; }                \
    case 4: { CALL(4); break; }                \
    case 5: { CALL(5); break; }                \
    case 6: { CALL(6); break; }                \
    case 7: { CALL(7); break; }                \
    case 8: { CALL(8); break; }                \
    default: return (int)cudaErrorInvalidValue; \
  }

// Locus tiles per row: the wrapper sizes ll_part [C, N, T] and
// qq_part [C, N, T, K] with it.
extern "C" int site_pass_tiles(int L) { return (L + kTile - 1) / kTile; }

extern "C" int site_gendiff_launch(
    const void* q, const void* freq, const void* bits2, const void* wg_pair,
    const void* u, void* z, void* qqnum, void* zcounts, void* ll,
    void* ll_part, void* qq_part, int C, int N, int L, int K, int structure,
    unsigned k0, unsigned k1, const void* chain_key, unsigned step,
    void* stream) {
  if (C == 0 || N == 0 || L == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int T = site_pass_tiles(L);
  cudaMemsetAsync(zcounts, 0, sizeof(float) * (size_t)C * K * L * 2, s);
  const dim3 grid(T, (N + kRows - 1) / kRows, C);
#define CALL(KK)                                                           \
  site_gendiff_kernel<KK><<<grid, kThreads, 0, s>>>(                       \
      (const float*)q, (const float*)freq, (const int8_t*)bits2,           \
      (const float*)wg_pair, (const float*)u, (int8_t*)z, (float*)zcounts, \
      (float*)ll_part, (float*)qq_part, N, L, T, structure, k0, k1,        \
      (const int*)chain_key, step)
  DISPATCH_K(K, CALL)
#undef CALL
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  launch_reduce((const float*)ll_part, (const float*)qq_part, (float*)ll,
                (float*)qqnum, (long long)C * N, T, K, s);
  return (int)cudaGetLastError();
}

extern "C" int site_loglik_launch(const void* q, const void* freq,
                                  const void* bits2, const void* z,
                                  const void* wg, void* ll, void* ll_part,
                                  int C, int N, int L, int K, int structure,
                                  void* stream) {
  if (C == 0 || N == 0 || L == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int T = site_pass_tiles(L);
  const dim3 grid(T, (N + kRows - 1) / kRows, C);
#define CALL(KK)                                                          \
  site_loglik_kernel<KK><<<grid, kThreads, 0, s>>>(                       \
      (const float*)q, (const float*)freq, (const int8_t*)bits2,          \
      (const int8_t*)z, (const float*)wg, (float*)ll_part, N, L, T,       \
      structure)
  DISPATCH_K(K, CALL)
#undef CALL
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  launch_reduce((const float*)ll_part, nullptr, (float*)ll, nullptr,
                (long long)C * N, T, K, s);
  return (int)cudaGetLastError();
}
