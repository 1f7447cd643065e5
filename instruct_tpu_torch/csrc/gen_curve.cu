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
// What bounds it.  JAX's form takes a logarithm a homozygous site and g
// (2 * 10^9 a forward pass at the headline shape, B = 4, N = 1000, L =
// 10 000, G = 50); the bytes (P, q, the panel's codes and masks, the
// curve) are ~40 MB.  The first body (the simplest that is right) still did
// G - 1 terms a homozygous site with 64 accumulators a thread (operations
// bound 0.28 ms a forward pass; it took 2.4), and the backward pass wrote
// two [B, N, L] planes and read them back.  This body's work a site does
// not grow with G (bound 0.04 ms a forward pass, 0.11 a backward one, by
// operations); what holds it now is latency: shared-memory and MUFU
// chains a site, a barrier a chunk, 16-32 warps an SM.  The algebraically
// equal forms:
//   * homozygous, m0 >= 1e-14 (no g clipped): gf_g = m0 (1 - u w_g), u =
//     1 - m0, so log gf_g = log m0 + log(1 - u w_g).  Generation indices 1
//     to kExact - 1 = 7 are exact: a lane multiplies its chunk's factors
//     1 - u w_g (8 sites, each factor >= 1/2) and takes one logarithm a
//     chunk.  From index 8 on (u w_g <= 2^-8) log(1 - x) is its series to
//     x^4 (truncation below 2^-40), whose sum over the sites is -sum_j w_g^j
//     S_j / j with the power sums S_j = sum_l u_l^j: four sums a site, the
//     G - 8 entries once a row.  Backward, dlog gf_g / dm0 = 1/m0 + w_g /
//     (1 - u w_g): d_g w_g / (1 - u w_g) for indices 1..7 (a fast division,
//     2 ulp, each), and from 8 on the series of w / (1 - x) to x^3
//     (truncation below x^4 <= 2^-32) summed over g as a cubic in u whose
//     coefficients c_j = sum_{g >= 8} d_g w_g^(j+1) are computed once a row;
//   * heterozygous, 2 m0 m1 w_G > 1e-30 (no g clipped): log(2 m0 m1) + (1 -
//     g) log 2, one logarithm a site, the g part added once a row; backward
//     sum_g dper_gen[g] / m_c;
//   * any other site (a clip may bind): JAX's form and clip, g by g, with a
//     zero gradient where the clip binds.  Forward, a warp takes such sites
//     together: each g's terms summed over the warp by a butterfly and kept
//     by lane g mod 32: two registers a lane for g < 64, and for any G a
//     further pass over the chunk's clip sites for each 64 generations,
//     whose chunk sums the lane adds to its entries of the row in out
//     (zeroed first, read back at the end), so no array grows with G.
// The fast paths take __logf and __fdividef (2^-21.41 absolute on [0.5, 2],
// else 3 ulp; 2 ulp): inside the rounding budget chip_smoke.py:gen_ulps
// holds the kernel to, and 20% of the forward's time.
// Design:
//   * both passes walk chunks of kTile = 256 sites: a warp one (b, n) row,
//     a lane the sites lane, lane + 32, ... of a chunk (8).  The chunk's P
//     rows P[b, :, chunk, :] are staged in shared memory as [K][A][kTile]
//     by cp.async where K * A <= kStageCells (beyond, they are read through
//     the cache), so a block's warps, individuals of one b, read them once
//     and conflict-free; the panel's codes (copy codes, hom, valid) of the
//     block's individuals likewise, 4-byte copies where the rows are 4-byte
//     aligned (L % 4 == 0), else byte copies.  A block serves one b:
//     sharing the codes between rows of b would stage P once a row and
//     individual pair (24 bytes a site at K = 3) to save the codes (4
//     bytes a site).
//   * forward: a block of 8 rows walks every chunk, P and codes double-
//     buffered; a lane keeps its chunk's sums (log m0, log 2 m0 m1 and its
//     count, S_1..S_4, the 7 products, the clip path's two) and adds them to
//     the row's totals after the chunk (so a term passes through at most 8
//     + chunks + 5 additions, as in the first body's per-thread sums); a
//     butterfly gives every lane the totals, and lane g writes entries g,
//     g + 32, ....  The rows' q lie in shared memory after the codes (any
//     K).  64 registers, 4 blocks an SM: the 4000 rows of B = 4 in one
//     wave.  No [B, N, L] or [B, N, L, G] tensor is written.
//   * backward: a small kernel computes each row's coefficients once
//     (dsum + d[0] for 1/m0, the 7 exact ones, c_0..c_3).  A block takes a
//     tile of kBwdIndv = 16 individuals x kSegment = 4 chunks of one b and
//     walks the chunks with the next chunk's codes (and, during pass 2, P)
//     in flight by cp.async.  Pass 1, warp w the tile's individuals w and
//     w + 8: dm_c in registers, kept in the tile's shared memory; dq's
//     partial of the chunk (at K <= 8 from the P values of the site's own
//     mixtures; a lane's 8 sites, then a butterfly) to dq_part[chunk, b, n,
//     k].  Pass 2, a thread a site and both alleles (A = 2; else an (allele,
//     site) pair): the tile's individuals in order, dP's partial to
//     dp_part[tile, b, k, l, a].  80 registers, 3 blocks an SM.  A small
//     second kernel sums the partials in chunk and tile order.  Scratch:
//     the partials (~62 MB at the headline), not two [B, N, L] planes (320
//     MB).
// The launch shapes are the GEN_* macros below, chosen by
// tools/gen_curve_variants.py's timings on the H100.  Every sum runs in a
// fixed order and no float atomic is used, so two runs give bitwise the
// same curve and gradients.  Built with -fmad=false like the other
// sources: m_c, gf_g and 2 m0 m1 round as the plain version's do
// (kernels/gen_curve.py: JAX's form at homozygous sites, log(2 m0 m1) + (1 -
// g) log 2 at heterozygous ones, within float32 rounding of the kernel's
// forms).
#include <cuda_runtime.h>
#include <stdint.h>

// Launch shapes (the defaults; tools/gen_curve_variants.py builds others)
#ifndef GEN_FWD_MIN_BLOCKS
#define GEN_FWD_MIN_BLOCKS 4   // forward blocks an SM: <= 64 registers
#endif
#ifndef GEN_BWD_SEGMENT
#define GEN_BWD_SEGMENT 4      // chunks a backward block walks
#endif
#ifndef GEN_BWD_MIN_BLOCKS
#define GEN_BWD_MIN_BLOCKS 3   // backward blocks an SM: <= 80 registers
#endif
#ifndef GEN_BWD_UNROLL
#define GEN_BWD_UNROLL 2       // backward: a lane's sites unrolled 2 at a time
#endif
#ifndef GEN_FWD_UNROLL
#define GEN_FWD_UNROLL 4       // forward: a lane's sites unrolled 4 at a time
#endif
#ifndef GEN_FAST_LOG
#define GEN_FAST_LOG 1         // __logf on the fast paths (else logf)
#endif
#define GEN_STR(x) #x
#define GEN_UNROLL(n) _Pragma(GEN_STR(unroll n))

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxA = 127;
constexpr int kTile = 256;       // sites of a chunk (TILE)
constexpr int kLaneSites = kTile / 32;
constexpr int kBwdIndv = 16;     // individuals of a backward tile (BWD_INDV)
constexpr int kSegment = GEN_BWD_SEGMENT;   // (SEGMENT)
constexpr int kStageCells = 32;  // P staged when K * A <= this (STAGE_CELLS)
constexpr int kPopChunk = 8;     // dq and dP partials, 8 pops at a time
// a row's backward coefficients (COEF), by generation index g: [0] dsum +
// d[0] (the factor of 1/m0), [1..7] d[g] w_g, [8..11] c_0..c_3, [12] dsum
// = sum_g d[g]
constexpr int kCoef = 16;
constexpr int kCoefTasks = 13;
constexpr float kEps = 1e-30f;
constexpr float kLn2 = 0.693147180559945309f;
// generation indices below kExact are exact; from kExact on u w_g <= 2^-8
// and the series does
constexpr int kExact = 8;
// m0 >= kHomFast: no gf_g of a homozygous site falls under the clip
// (gf_1 = m0^2 >= 1e-28, gf_g >= m0 / 2 beyond)
constexpr float kHomFast = 1e-14f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;   // a block's shared memory on the H100

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o >= 1; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
  return v;
}

// the fast paths' logarithm: __logf errs by at most 2^-21.41 on [0.5, 2]
// and 3 ulp elsewhere, inside chip_smoke.py:gen_ulps's 8 units a term
__device__ __forceinline__ float fast_log(float x) {
#if GEN_FAST_LOG
  return __logf(x);
#else
  return logf(x);
#endif
}

// w_g = 2^(1-g) for generation g = 1..G, taken by its index g - 1: an
// exact power of two, built from its exponent bits; 0 from index 127 on
// (below the normal range: 1 - w_g is 1 and 2 m0 m1 w_g is clipped there
// whether w_g is a subnormal or 0)
__device__ __forceinline__ float w_of(int gi) {
  return gi < 127 ? __int_as_float((127 - gi) << 23) : 0.f;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage P[b, :, l0 : l0 + n, :] into ps[(k * A + a) * kTile + t] (t = l -
// l0), one 4-byte cp.async an element, consecutive threads on consecutive
// addresses of P
__device__ __forceinline__ void stage_p(float* ps, const float* pb, int K,
                                        int L, int A, int l0, int n) {
  const int per_pop = n * A;
  for (int k = 0; k < K; ++k) {
    const float* src = pb + ((long long)k * L + l0) * A;
    for (int e = threadIdx.x; e < per_pop; e += kThreads) {
      const int t = e / A, a = e - t * A;
      cp_async4(ps + (k * A + a) * kTile + t, src + e);
    }
  }
}

// The panel's codes of a chunk: plane 0 the copy-0 codes, 1 the copy-1
// codes, 2 hom, 3 valid, of individuals n0 .. n0 + ni - 1 (ni <= cap),
// into cs[(i * 4 + plane) * kTile + t].  4-byte cp.async where every row
// is 4-byte aligned (L % 4 == 0), else plain byte copies.
__device__ __forceinline__ void stage_codes(int8_t* cs, const int8_t* geno,
                                            const bool* hom, const bool* valid,
                                            int L, long long n0, int ni,
                                            int l0, int n, bool aligned) {
  const int rows = 4 * ni;
  if (aligned) {
    const int w = threadIdx.x & (kTile / 4 - 1);
    if (4 * w >= n) return;
    for (int r = threadIdx.x / (kTile / 4); r < rows; r += kThreads / (kTile / 4)) {
      const int i = r >> 2, plane = r & 3;
      const long long row = n0 + i;
      const int8_t* src =
          plane < 2 ? geno + row * 2LL * L + plane * L
                    : reinterpret_cast<const int8_t*>(plane == 2 ? hom : valid) +
                          row * (long long)L;
      cp_async4(cs + r * kTile + 4 * w, src + l0 + 4 * w);
    }
  } else {
    const int t = threadIdx.x;
    if (t >= n) return;
    for (int r = 0; r < rows; ++r) {
      const int i = r >> 2, plane = r & 3;
      const long long row = n0 + i;
      const int8_t* src =
          plane < 2 ? geno + row * 2LL * L + plane * L
                    : reinterpret_cast<const int8_t*>(plane == 2 ? hom : valid) +
                          row * (long long)L;
      cs[r * kTile + t] = src[l0 + t];
    }
  }
}

// P[b, k, l, a] at chunk site t (= l - l0): staged, or through the cache
template <bool kStage>
__device__ __forceinline__ float p_at(const float* ps, const float* pb, int L,
                                      int A, int k, int a, int t, int l) {
  if (kStage) return ps[(k * A + a) * kTile + t];
  return __ldg(pb + ((long long)k * L + l) * A + a);
}

// m_c = q_0 P[0, l, x] + q_1 P[1, l, x] + ... in pop order (the plain
// version's order: likelihood.mixture_copy_probs); q_s the row's q in
// shared memory
template <bool kStage>
__device__ __forceinline__ float mixture(const float* q_s, const float* ps,
                                         const float* pb, int K, int L, int A,
                                         int x, int t, int l) {
  float m = q_s[0] * p_at<kStage>(ps, pb, L, A, 0, x, t, l);
  for (int k = 1; k < K; ++k)
    m = m + q_s[k] * p_at<kStage>(ps, pb, L, A, k, x, t, l);
  return m;
}

template <bool kStage>
__global__ void __launch_bounds__(kThreads, GEN_FWD_MIN_BLOCKS)
gen_curve_fwd_kernel(const float* __restrict__ q, const float* __restrict__ p,
                     const int8_t* __restrict__ geno,
                     const bool* __restrict__ hom,
                     const bool* __restrict__ valid, float* __restrict__ out,
                     int N, int L, int K, int A, int G) {
  // two chunks: [K][A][kTile] of P (kStage), then [kWarps][4][kTile]
  // codes, then the rows' q [kWarps][K]
  extern __shared__ __align__(16) float stage[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = blockIdx.y;
  const int n_first = blockIdx.x * kWarps;
  const int n = n_first + warp;
  const int ni = min(kWarps, N - n_first);
  const bool live = n < N;  // warp-uniform
  const long long row = b * N + n;
  const float* pb = p + b * (long long)K * L * A;
  const bool aligned = (L & 3) == 0;
  const int chunks = (L + kTile - 1) / kTile;
  const int p_floats = kStage ? K * A * kTile : 0;
  int8_t* codes = reinterpret_cast<int8_t*>(stage + 2 * p_floats);
  constexpr int kCodeBytes = kWarps * 4 * kTile;
  float* qr = reinterpret_cast<float*>(codes + 2 * kCodeBytes) + warp * K;
  if (live) {
    for (int k = lane; k < K; k += 32) qr[k] = q[row * K + k];
    // the row's clip-path sums of generations >= 64 accumulate in out
    for (int g = 64 + lane; g < G; g += 32) out[row * G + g] = 0.f;
  }
  if (kStage) stage_p(stage, pb, K, L, A, 0, min(L, kTile));
  stage_codes(codes, geno, hom, valid, L, n_first, ni, 0, min(L, kTile),
              aligned);
  cp_async_commit();
  const float w_min = w_of(G - 1), log_eps = logf(kEps);
  // the row's totals: sum log m0 and the power sums S_1..S_4 (fast
  // homozygous sites), sum log(1 - u w_g) for g = 1..7, sum log(2 m0 m1)
  // and the count (fast heterozygous sites), the clip path's sums of
  // generations lane and lane + 32 (those of lane + 64, ... in out)
  float lm = 0.f, lt = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
  float lx[kExact], sl0 = 0.f, sl1 = 0.f;
#pragma unroll
  for (int g = 0; g < kExact; ++g) lx[g] = 0.f;
  int n_het = 0;
  for (int c = 0; c < chunks; ++c) {
    const int l0 = c * kTile, nxt = (c + 1) & 1;
    if (c + 1 < chunks) {
      const int n_next = min(L - l0 - kTile, kTile);
      if (kStage)
        stage_p(stage + nxt * p_floats, pb, K, L, A, l0 + kTile, n_next);
      stage_codes(codes + nxt * kCodeBytes, geno, hom, valid, L, n_first, ni,
                  l0 + kTile, n_next, aligned);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ps = stage + (c & 1) * p_floats;
    const int8_t* cw = codes + (c & 1) * kCodeBytes + warp * 4 * kTile;
    if (live) {
      float c_lm = 0.f, c_lt = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f, c4 = 0.f;
      float pr[kExact];
#pragma unroll
      for (int g = 0; g < kExact; ++g) pr[g] = 1.f;
      unsigned slow = 0u;  // bit j: site j takes JAX's form
      GEN_UNROLL(GEN_FWD_UNROLL)
      for (int j = 0; j < kLaneSites; ++j) {
        const int t = j * 32 + lane, l = l0 + t;
        if (l >= L || !cw[3 * kTile + t]) continue;
        const float m0 = mixture<kStage>(qr, ps, pb, K, L, A, cw[t], t, l);
        if (cw[2 * kTile + t]) {
          if (m0 >= kHomFast) {
            // log m0 + log(1 - u w_g): the exact indices as products, the
            // series' power sums
            const float u = 1.f - m0, u2 = u * u;
            c_lm = c_lm + fast_log(m0);
#pragma unroll
            for (int g = 1; g < kExact; ++g)
              pr[g] = pr[g] * __fmaf_rn(-u, w_of(g), 1.f);
            c1 = c1 + u;
            c2 = c2 + u2;
            c3 = c3 + u2 * u;
            c4 = c4 + u2 * u2;
          } else {
            slow |= 1u << j;
          }
        } else {
          const float m1 =
              mixture<kStage>(qr, ps, pb, K, L, A, cw[kTile + t], t, l);
          const float t2 = (2.f * m0) * m1;
          if (t2 * w_min > kEps) {
            // no g clipped: log t + (1 - g) log 2, the g part added at the
            // end
            c_lt = c_lt + fast_log(t2);
            ++n_het;
          } else {
            slow |= 1u << j;
          }
        }
      }
      float c_sl0 = 0.f, c_sl1 = 0.f;
      if (__any_sync(kFull, slow != 0u)) {
        // JAX's form and clip, g by g, a site at a time for the warp: each
        // g's terms summed by a butterfly, kept by lane g mod 32; a pass
        // over the chunk's clip sites for each 64 generations, the passes
        // past the first adding their chunk sums to the row's entries of
        // out
        for (int g0 = 0; g0 < G; g0 += 64) {
          const int g_end = min(G, g0 + 64);
          float p0 = 0.f, p1 = 0.f;
          for (int j = 0; j < kLaneSites; ++j) {
            const bool mine = (slow >> j) & 1u;
            if (!__any_sync(kFull, mine)) continue;
            int kind = 0;
            float a = 0.f, cc = 0.f, t2 = 0.f, lt2 = 0.f;
            if (mine) {
              const int t = j * 32 + lane, l = l0 + t;
              const float m0 =
                  mixture<kStage>(qr, ps, pb, K, L, A, cw[t], t, l);
              if (cw[2 * kTile + t]) {
                kind = 1;
                a = m0 * m0;
                cc = m0 * (1.f - m0);
              } else {
                kind = 2;
                t2 = (2.f * m0) *
                     mixture<kStage>(qr, ps, pb, K, L, A, cw[kTile + t], t, l);
                lt2 = logf(t2);
              }
            }
            for (int g = g0; g < g_end; ++g) {
              float v = 0.f;
              if (kind == 1) {
                v = logf(fmaxf(a + cc * (1.f - w_of(g)), kEps));
              } else if (kind == 2) {
                // 2 m0 m1 w_g >= 1e-30: log t + (1 - g) log 2, else the
                // clip
                v = t2 * w_of(g) >= kEps ? lt2 - (float)g * kLn2 : log_eps;
              }
              v = warp_sum(v);
              if ((g & 31) == lane) {
                if (g - g0 < 32) p0 = p0 + v;
                else p1 = p1 + v;
              }
            }
          }
          if (g0 == 0) {
            c_sl0 = p0;
            c_sl1 = p1;
          } else {
            float* o = out + row * G + g0 + lane;
            if (g0 + lane < G) o[0] = o[0] + p0;
            if (g0 + 32 + lane < G) o[32] = o[32] + p1;
          }
        }
      }
      lm = lm + c_lm;
      lt = lt + c_lt;
      s1 = s1 + c1;
      s2 = s2 + c2;
      s3 = s3 + c3;
      s4 = s4 + c4;
#pragma unroll
      for (int g = 1; g < kExact; ++g) lx[g] = lx[g] + fast_log(pr[g]);
      sl0 = sl0 + c_sl0;
      sl1 = sl1 + c_sl1;
    }
    __syncthreads();  // the buffer is staged again next chunk
  }
  if (!live) return;
  lm = warp_sum(lm);
  lt = warp_sum(lt);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2) * 0.5f;
  s3 = warp_sum(s3) * 0.33333334f;
  s4 = warp_sum(s4) * 0.25f;
#pragma unroll
  for (int g = 1; g < kExact; ++g) lx[g] = warp_sum(lx[g]);
  const float het = (float)__reduce_add_sync(kFull, n_het);
  const float base = lm + lt;
  for (int h = 0; h < (G + 31) / 32; ++h) {
    const int g = lane + 32 * h;
    if (g >= G) break;
    float f = lm;  // generation index 0: 2 log m0
    if (g >= kExact) {
      // -sum_j w^j S_j / j, the series' tail
      const float w = w_of(g);
      f = -(w * (s1 + w * (s2 + w * (s3 + w * s4))));
    } else {
#pragma unroll
      for (int e = 1; e < kExact; ++e)
        if (g == e) f = lx[e];
    }
    const float sl = h == 0 ? sl0 : (h == 1 ? sl1 : out[row * G + g]);
    out[row * G + g] = ((f + sl) + base) - ((float)g * kLn2) * het;
  }
}

// A row's backward coefficients (kCoef), a thread a row and task: dsum +
// d[0], d[g] w_g (g = 1..7), c_j = sum_{g >= 8} d[g] w_g^(j+1), dsum; each
// sum in g order
__global__ void gen_curve_bwd_coef_kernel(const float* __restrict__ dper,
                                          float* __restrict__ coef,
                                          long long rows, int G) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= rows * kCoefTasks) return;
  const long long row = e / kCoefTasks;
  const int task = (int)(e - row * kCoefTasks);
  const float* d = dper + row * G;
  float v = 0.f;
  if (task == 0 || task == 12) {
    for (int g = 0; g < G; ++g) v = v + d[g];
    if (task == 0) v = v + d[0];
  } else if (task < kExact) {
    v = task < G ? d[task] * w_of(task) : 0.f;
  } else {
    const int j = task - kExact;
    for (int g = kExact; g < G; ++g) {
      const float w = w_of(g);
      float pw = w;
      for (int i = 0; i < j; ++i) pw = pw * w;
      v = v + d[g] * pw;
    }
  }
  coef[row * kCoef + task] = v;
}

// dm0 of a homozygous site with m0 < 1e-14: JAX's form, g by g, zero where
// the clip binds
__device__ __noinline__ float hom_slow_dm0(float m0, const float* d, int G) {
  const float a = m0 * m0, c = m0 * (1.f - m0);
  float dm0 = 0.f;
  for (int g = 0; g < G; ++g) {
    const float w = w_of(g);
    const float gf = a + c * (1.f - w);
    if (gf > kEps) {
      const float num = (2.f * m0) * w + (1.f - w);
      dm0 = dm0 + (__ldg(d + g) * num) / gf;
    }
  }
  return dm0;
}

// sum of d[g] over the generations whose 2 m0 m1 w_g is not clipped
__device__ __noinline__ float het_slow_sum(float t2, const float* d, int G) {
  float s = 0.f;
  for (int g = 0; g < G; ++g)
    if (t2 * w_of(g) > kEps) s = s + __ldg(d + g);
  return s;
}

// A row's coefficients in registers (kCoef's 13)
struct RowCoef {
  float a0, e[kExact], c[4], dsum;
};

__device__ __forceinline__ RowCoef load_coef(const float* cf) {
  RowCoef r;
  r.a0 = cf[0];
#pragma unroll
  for (int g = 1; g < kExact; ++g) r.e[g] = cf[g];
#pragma unroll
  for (int j = 0; j < 4; ++j) r.c[j] = cf[kExact + j];
  r.dsum = cf[12];
  return r;
}

// dm0 of a fast homozygous site: (dsum + d[0]) / m0 + sum over indices
// 1..7 of d[g] w_g / (1 - u w_g) + the cubic of the series' tail
__device__ __forceinline__ float hom_fast_dm0(const RowCoef& r, float m0) {
  const float u = 1.f - m0;
  float ex = 0.f;
#pragma unroll
  for (int g = 1; g < kExact; ++g)
    ex = ex + __fdividef(r.e[g], __fmaf_rn(-u, w_of(g), 1.f));
  const float cub = r.c[0] + u * (r.c[1] + u * (r.c[2] + u * r.c[3]));
  return __fdividef(r.a0, m0) + (ex + cub);
}

// dm0 and dm1 of a heterozygous site: the sum of d[g] over the unclipped
// g (all of them on the fast path) over m_c
__device__ __forceinline__ void het_dm(const RowCoef& r, const float* d,
                                       int G, float w_min, float m0, float m1,
                                       float& dm0, float& dm1) {
  const float t2 = (2.f * m0) * m1;
  if (t2 * w_min > kEps) {
    dm0 = __fdividef(r.dsum, m0);
    dm1 = __fdividef(r.dsum, m1);
  } else {
    const float sd = het_slow_sum(t2, d, G);
    // no g alive (t clipped at every g, e.g. m0 = 0): zero, not 0 / 0
    dm0 = sd != 0.f ? sd / m0 : 0.f;
    dm1 = sd != 0.f ? sd / m1 : 0.f;
  }
}

// Shared memory of a backward block (bwd_smem; kernels/gen_curve.py:
// bwd_plan), in floats then bytes: a chunk of P [K][A][kTile] (staged; the
// next chunk's is staged during pass 2, which does not read P), dm0 and
// dm1 [kBwdIndv][kTile], the rows' coefficients [kBwdIndv][kCoef] and q
// [kBwdIndv][K], two chunks of codes [kBwdIndv][4][kTile]
__host__ __device__ __forceinline__ int tile_floats(int K, int A, bool stage) {
  return (stage ? K * A * kTile : 0) + 2 * kBwdIndv * kTile +
         kBwdIndv * kCoef + kBwdIndv * K;
}

__host__ __device__ __forceinline__ int bwd_smem(int K, int A, bool stage) {
  return tile_floats(K, A, stage) * 4 + 2 * kBwdIndv * 4 * kTile;
}

template <bool kStage>
__global__ void __launch_bounds__(kThreads, GEN_BWD_MIN_BLOCKS)
gen_curve_bwd_tile_kernel(const float* __restrict__ q,
                          const float* __restrict__ p,
                          const int8_t* __restrict__ geno,
                          const bool* __restrict__ hom,
                          const bool* __restrict__ valid,
                          const float* __restrict__ dper,
                          const float* __restrict__ coef,
                          float* __restrict__ dq_part,
                          float* __restrict__ dp_part, int B, int N, int L,
                          int K, int A, int G) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.y;
  const long long b = blockIdx.z;
  const int chunks = (L + kTile - 1) / kTile;
  const int c_first = blockIdx.x * kSegment;
  const int c_end = min(chunks, c_first + kSegment);
  const int n0 = tile * kBwdIndv, nt = min(kBwdIndv, N - n0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* pb = p + b * (long long)K * L * A;
  const bool aligned = (L & 3) == 0;
  const int p_floats = kStage ? K * A * kTile : 0;
  float* dm0_s = smem + p_floats;
  float* dm1_s = dm0_s + kBwdIndv * kTile;
  float* coef_s = dm1_s + kBwdIndv * kTile;
  float* q_s = coef_s + kBwdIndv * kCoef;
  int8_t* codes = reinterpret_cast<int8_t*>(smem + tile_floats(K, A, kStage));
  constexpr int kCodeBytes = kBwdIndv * 4 * kTile;
  const long long row0 = b * N + n0;
  {
    const int l0 = c_first * kTile, n = min(kTile, L - l0);
    if (kStage) stage_p(smem, pb, K, L, A, l0, n);
    stage_codes(codes, geno, hom, valid, L, n0, nt, l0, n, aligned);
  }
  for (int e = tid; e < nt * kCoef; e += kThreads)
    cp_async4(coef_s + e, coef + row0 * kCoef + e);
  for (int e = tid; e < nt * K; e += kThreads)
    cp_async4(q_s + e, q + row0 * K + e);
  cp_async_commit();
  const float w_min = w_of(G - 1);
  for (int c = c_first; c < c_end; ++c) {
    const int l0 = c * kTile, n_sites = min(kTile, L - l0);
    const int buf = (c - c_first) & 1;
    if (c + 1 < c_end)
      stage_codes(codes + (buf ^ 1) * kCodeBytes, geno, hom, valid, L, n0, nt,
                  l0 + kTile, min(kTile, L - l0 - kTile), aligned);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's codes and P
    __syncthreads();
    const float* ps = smem;
    const int8_t* cb = codes + buf * kCodeBytes;
    // pass 1: dm_c of the warp's individuals, dq's partial of the chunk
    for (int i = warp; i < nt; i += kWarps) {
      const long long n = n0 + i;
      const RowCoef rc = load_coef(coef_s + i * kCoef);
      const float* qi = q_s + i * K;
      const float* d = dper + (b * N + n) * G;
      const int8_t* cw = cb + i * 4 * kTile;
      if (K <= kPopChunk) {
        // the site's P values kept from its mixtures for dq
        float acc[kPopChunk];
#pragma unroll
        for (int k = 0; k < kPopChunk; ++k) acc[k] = 0.f;
        GEN_UNROLL(GEN_BWD_UNROLL)
        for (int j = 0; j < kLaneSites; ++j) {
          const int t = j * 32 + lane, l = l0 + t;
          float dm0 = 0.f, dm1 = 0.f;
          if (t < n_sites && cw[3 * kTile + t]) {
            const int x0 = cw[t];
            float pk0[kPopChunk];
            float m0 = 0.f;
#pragma unroll
            for (int k = 0; k < kPopChunk; ++k) {
              if (k < K) {
                pk0[k] = p_at<kStage>(ps, pb, L, A, k, x0, t, l);
                m0 = k == 0 ? qi[0] * pk0[0] : m0 + qi[k] * pk0[k];
              }
            }
            if (cw[2 * kTile + t]) {
              dm0 = m0 >= kHomFast ? hom_fast_dm0(rc, m0)
                                   : hom_slow_dm0(m0, d, G);
#pragma unroll
              for (int k = 0; k < kPopChunk; ++k)
                if (k < K) acc[k] = acc[k] + dm0 * pk0[k];
            } else {
              const int x1 = cw[kTile + t];
              float pk1[kPopChunk];
              float m1 = 0.f;
#pragma unroll
              for (int k = 0; k < kPopChunk; ++k) {
                if (k < K) {
                  pk1[k] = p_at<kStage>(ps, pb, L, A, k, x1, t, l);
                  m1 = k == 0 ? qi[0] * pk1[0] : m1 + qi[k] * pk1[k];
                }
              }
              het_dm(rc, d, G, w_min, m0, m1, dm0, dm1);
#pragma unroll
              for (int k = 0; k < kPopChunk; ++k)
                if (k < K)
                  acc[k] = acc[k] + (dm0 * pk0[k] + dm1 * pk1[k]);
            }
          }
          dm0_s[i * kTile + t] = dm0;
          dm1_s[i * kTile + t] = dm1;
        }
#pragma unroll
        for (int k = 0; k < kPopChunk; ++k) {
          if (k < K) {
            const float sum = warp_sum(acc[k]);
            if (lane == k)
              dq_part[(((long long)c * B + b) * N + n) * K + k] = sum;
          }
        }
        continue;
      }
      // K > 8: dm_c first, then dq by chunks of 8 pops, the lane's sites
      // read back from its own shared memory
#pragma unroll
      for (int j = 0; j < kLaneSites; ++j) {
        const int t = j * 32 + lane, l = l0 + t;
        float dm0 = 0.f, dm1 = 0.f;
        if (t < n_sites && cw[3 * kTile + t]) {
          const float m0 = mixture<kStage>(qi, ps, pb, K, L, A, cw[t], t, l);
          if (cw[2 * kTile + t]) {
            dm0 = m0 >= kHomFast ? hom_fast_dm0(rc, m0)
                                 : hom_slow_dm0(m0, d, G);
          } else {
            const float m1 =
                mixture<kStage>(qi, ps, pb, K, L, A, cw[kTile + t], t, l);
            het_dm(rc, d, G, w_min, m0, m1, dm0, dm1);
          }
        }
        dm0_s[i * kTile + t] = dm0;
        dm1_s[i * kTile + t] = dm1;
      }
      for (int k0 = 0; k0 < K; k0 += kPopChunk) {
        float acc[kPopChunk];
#pragma unroll
        for (int kk = 0; kk < kPopChunk; ++kk) acc[kk] = 0.f;
#pragma unroll
        for (int j = 0; j < kLaneSites; ++j) {
          const int t = j * 32 + lane, l = l0 + t;
          if (t >= n_sites || !cw[3 * kTile + t]) continue;
          const float dm0 = dm0_s[i * kTile + t], dm1 = dm1_s[i * kTile + t];
          const int x0 = cw[t], x1 = cw[kTile + t];
#pragma unroll
          for (int kk = 0; kk < kPopChunk; ++kk) {
            const int k = k0 + kk;
            if (k < K)
              acc[kk] = acc[kk] +
                        (dm0 * p_at<kStage>(ps, pb, L, A, k, x0, t, l) +
                         dm1 * p_at<kStage>(ps, pb, L, A, k, x1, t, l));
          }
        }
#pragma unroll
        for (int kk = 0; kk < kPopChunk; ++kk) {
          const int k = k0 + kk;
          if (k < K) {
            const float sum = warp_sum(acc[kk]);
            if (lane == kk)
              dq_part[(((long long)c * B + b) * N + n) * K + k] = sum;
          }
        }
      }
    }
    __syncthreads();
    // the next chunk's P, in flight during pass 2
    if (kStage && c + 1 < c_end)
      stage_p(smem, pb, K, L, A, l0 + kTile, min(kTile, L - l0 - kTile));
    cp_async_commit();
    // pass 2: dP's partial of the tile, the tile's individuals in order: a
    // thread a site and both alleles (A = 2), else an (allele, site)
    if (A == 2) {
      const int t = tid;
      for (int k0 = 0; k0 < K && t < n_sites; k0 += kPopChunk) {
        float a0[kPopChunk], a1[kPopChunk];
#pragma unroll
        for (int kk = 0; kk < kPopChunk; ++kk) a0[kk] = a1[kk] = 0.f;
#pragma unroll 4
        for (int i = 0; i < nt; ++i) {
          const int o = i * kTile + t;
          const int8_t* cw = cb + i * 4 * kTile;
          const int x0 = cw[t], x1 = cw[kTile + t];
          const float dm0 = dm0_s[o], dm1 = dm1_s[o];
          const float d0 = (x0 == 0 ? dm0 : 0.f) + (x1 == 0 ? dm1 : 0.f);
          const float d1 = (x0 == 1 ? dm0 : 0.f) + (x1 == 1 ? dm1 : 0.f);
          const float* qi = q_s + i * K;
#pragma unroll
          for (int kk = 0; kk < kPopChunk; ++kk) {
            if (k0 + kk < K) {
              if (d0 != 0.f) a0[kk] = a0[kk] + qi[k0 + kk] * d0;
              if (d1 != 0.f) a1[kk] = a1[kk] + qi[k0 + kk] * d1;
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < kPopChunk; ++kk) {
          const int k = k0 + kk;
          if (k < K)
            *reinterpret_cast<float2*>(
                dp_part + ((((long long)tile * B + b) * K + k) * L + l0 + t) *
                              2) = make_float2(a0[kk], a1[kk]);
        }
      }
    } else {
      for (int e = tid; e < n_sites * A; e += kThreads) {
        const int t = e / A, a = e - t * A;
        for (int k0 = 0; k0 < K; k0 += kPopChunk) {
          float acc[kPopChunk];
#pragma unroll
          for (int kk = 0; kk < kPopChunk; ++kk) acc[kk] = 0.f;
#pragma unroll 4
          for (int i = 0; i < nt; ++i) {
            const int o = i * kTile + t;
            const int8_t* cw = cb + i * 4 * kTile;
            const float v0 = cw[t] == a ? dm0_s[o] : 0.f;
            const float v1 = cw[kTile + t] == a ? dm1_s[o] : 0.f;
            const float d = v0 + v1;
            if (d == 0.f) continue;
            const float* qi = q_s + i * K;
#pragma unroll
            for (int kk = 0; kk < kPopChunk; ++kk)
              if (k0 + kk < K) acc[kk] = acc[kk] + qi[k0 + kk] * d;
          }
#pragma unroll
          for (int kk = 0; kk < kPopChunk; ++kk) {
            const int k = k0 + kk;
            if (k < K)
              dp_part[((((long long)tile * B + b) * K + k) * L + l0 + t) * A +
                      a] = acc[kk];
          }
        }
      }
    }
    __syncthreads();  // dm and the buffer are written again next chunk
  }
}

// The partials in chunk (dq) and tile (dP) order
__global__ void gen_curve_bwd_sum_kernel(const float* __restrict__ dq_part,
                                         const float* __restrict__ dp_part,
                                         float* __restrict__ dq,
                                         float* __restrict__ dp,
                                         long long n_dq, int chunks,
                                         long long n_dp, int tiles) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n_dq) {
    float s = dq_part[i];
    for (int c = 1; c < chunks; ++c) s = s + dq_part[c * n_dq + i];
    dq[i] = s;
  } else if (i < n_dq + n_dp) {
    const long long j = i - n_dq;
    float s = dp_part[j];
    for (int t = 1; t < tiles; ++t) s = s + dp_part[t * n_dp + j];
    dp[j] = s;
  }
}

bool staged(int K, int A) { return K * A <= kStageCells; }

int fwd_smem(int K, int A) {
  return 2 * ((staged(K, A) ? K * A * kTile * (int)sizeof(float) : 0) +
              kWarps * 4 * kTile) +
         kWarps * K * (int)sizeof(float);
}

// Any K and G whose blocks fit shared memory (K <= 2592:
// kernels/gen_curve.py:MAX_POPS, the backward tile's q rows)
int check_shapes(int B, int N, int L, int K, int A, int G) {
  if (B < 1 || B > 65535 || N < 1 || L < 1 || K < 1 || A < 1 || A > kMaxA ||
      G < 1 || fwd_smem(K, A) > kMaxSmem ||
      bwd_smem(K, A, staged(K, A)) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Opt a kernel in to its dynamic shared memory beyond the default (for the
// current device, so at every launch: a cheap call)
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" int gen_curve_fwd_launch(const float* q, const float* p,
                                    const int8_t* geno, const bool* hom,
                                    const bool* valid, float* out, int B,
                                    int N, int L, int K, int A, int G,
                                    cudaStream_t stream) {
  if (int rc = check_shapes(B, N, L, K, A, G)) return rc;
  const dim3 grid((unsigned)((N + kWarps - 1) / kWarps), (unsigned)B);
  const int smem = fwd_smem(K, A);
  if (staged(K, A)) {
    if (cudaError_t e = allow_smem(gen_curve_fwd_kernel<true>, smem))
      return (int)e;
    gen_curve_fwd_kernel<true><<<grid, kThreads, smem, stream>>>(
        q, p, geno, hom, valid, out, N, L, K, A, G);
  } else {
    if (cudaError_t e = allow_smem(gen_curve_fwd_kernel<false>, smem))
      return (int)e;
    gen_curve_fwd_kernel<false><<<grid, kThreads, smem, stream>>>(
        q, p, geno, hom, valid, out, N, L, K, A, G);
  }
  return (int)cudaGetLastError();
}

// The backward pass's plan (kernels/gen_curve.py:bwd_plan): out = (tile
// individuals, tiles, chunks, chunks a block, staged, dynamic shared-memory
// bytes)
extern "C" int gen_curve_bwd_plan(int N, int L, int K, int A, int* out) {
  out[0] = kBwdIndv;
  out[1] = (N + kBwdIndv - 1) / kBwdIndv;
  out[2] = (L + kTile - 1) / kTile;
  out[3] = kSegment;
  out[4] = staged(K, A) ? 1 : 0;
  out[5] = bwd_smem(K, A, staged(K, A));
  return 0;
}

extern "C" int gen_curve_bwd_launch(const float* q, const float* p,
                                    const int8_t* geno, const bool* hom,
                                    const bool* valid, const float* dper,
                                    float* coef, float* dq_part,
                                    float* dp_part, float* dq, float* dp,
                                    int B, int N, int L, int K, int A, int G,
                                    cudaStream_t stream) {
  if (int rc = check_shapes(B, N, L, K, A, G)) return rc;
  const long long rows = (long long)B * N;
  gen_curve_bwd_coef_kernel<<<(unsigned)((rows * kCoefTasks + 255) / 256),
                              256, 0, stream>>>(dper, coef, rows, G);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const int tiles = (N + kBwdIndv - 1) / kBwdIndv;
  const int chunks = (L + kTile - 1) / kTile;
  const dim3 grid((unsigned)((chunks + kSegment - 1) / kSegment),
                  (unsigned)tiles, (unsigned)B);
  const bool stage = staged(K, A);
  const int smem = bwd_smem(K, A, stage);
  if (stage) {
    if (cudaError_t e = allow_smem(gen_curve_bwd_tile_kernel<true>, smem))
      return (int)e;
    gen_curve_bwd_tile_kernel<true><<<grid, kThreads, smem, stream>>>(
        q, p, geno, hom, valid, dper, coef, dq_part, dp_part, B, N, L, K, A,
        G);
  } else {
    if (cudaError_t e = allow_smem(gen_curve_bwd_tile_kernel<false>, smem))
      return (int)e;
    gen_curve_bwd_tile_kernel<false><<<grid, kThreads, smem, stream>>>(
        q, p, geno, hom, valid, dper, coef, dq_part, dp_part, B, N, L, K, A,
        G);
  }
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const long long n_dq = rows * K;
  const long long n_dp = (long long)B * K * L * A;
  gen_curve_bwd_sum_kernel<<<(unsigned)((n_dq + n_dp + 255) / 256), 256, 0,
                             stream>>>(dq_part, dp_part, dq, dp, n_dq, chunks,
                                       n_dp, tiles);
  return (int)cudaGetLastError();
}

// Registers and occupancy of a launch at (K, A): which = 0 the forward, 1
// the backward tile, 2 the backward sum, 3 the backward coefficients; out =
// (registers a thread, local bytes a thread, static shared bytes, dynamic
// shared bytes, blocks an SM)
extern "C" int gen_curve_kernel_info(int which, int K, int A, int* out) {
  const bool stage = staged(K, A);
  const void* fn;
  int smem = 0;
  cudaError_t e = cudaSuccess;
  if (which == 0) {
    smem = fwd_smem(K, A);
    if (stage) {
      e = allow_smem(gen_curve_fwd_kernel<true>, smem);
      fn = (const void*)gen_curve_fwd_kernel<true>;
    } else {
      e = allow_smem(gen_curve_fwd_kernel<false>, smem);
      fn = (const void*)gen_curve_fwd_kernel<false>;
    }
  } else if (which == 1) {
    smem = bwd_smem(K, A, stage);
    if (stage) {
      e = allow_smem(gen_curve_bwd_tile_kernel<true>, smem);
      fn = (const void*)gen_curve_bwd_tile_kernel<true>;
    } else {
      e = allow_smem(gen_curve_bwd_tile_kernel<false>, smem);
      fn = (const void*)gen_curve_bwd_tile_kernel<false>;
    }
  } else if (which == 2) {
    fn = (const void*)gen_curve_bwd_sum_kernel;
  } else {
    fn = (const void*)gen_curve_bwd_coef_kernel;
  }
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  if ((e = cudaFuncGetAttributes(&fa, fn))) return (int)e;
  int blocks = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                         kThreads, smem)))
    return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = smem;
  out[4] = blocks;
  return 0;
}
