// The per-site pass of the diploid sweep: one kernel body for every entry
// point of instruct_tpu/kernels/fused_step.py:_site_pass (_site_kernel).
//
// A source that includes this file defines SITE_PACKED (1: the packed
// biallelic plane bits2; 0: the generic path, allele codes in [0, A) with
// separate valid and hom planes), SITE_SAMPLE (1: the pass draws z; 0: it
// evaluates a log-lik at the carried z) and SITE_LAUNCH (the name of its
// launch function).  The four sources are compiled side by side; each
// instantiates the body for K = 1..8 and once for 8 < K <= 32 (K at run
// time; K*A <= 64, the JAX step's gate), for the log-lik families of its
// half:
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
// counts each individual's copies per pop (qqnum) and the [K, L, A]
// allele-pop counts of the fresh z, and evaluates its family at
// that fresh z ("Z, then G | z" / "Z, then F | z": the old z is never read).
// A stored-step pass evaluates at the carried z planes.
//
// What bounds it: bytes and operations are of one order.  Per chain a
// sampling pass reads the site planes (N*L bytes packed, 3-4 N*L generic) and
// writes z (2 N*L); a stored-step pass reads both.  Per allele copy it does a
// few dozen float operations, a quarter of a Philox block when sampling, and
// up to one log or division per site.  The first version of this kernel ran
// at 7x that bound with every part of its work ablated but the loads and the
// CDF arithmetic: it was exposed load latency (each block walked its rows
// one dependent load after another) and three launches per call.
// Design: the TPU grid runs in order and accumulates into resident outputs;
// here a block owns a tile of 512 loci x a strip of ~16 rows of one chain
// (site_pass_strips: at most 64 strips), so the headline call is some 5000
// short blocks, many waves with a small tail (one wave of ~110-row strips
// ran slower on an H100: tools/site_pass_variants.py).  One launch per call:
//   * Each thread owns 4 consecutive loci (one Philox block per copy and
//     row).  The rows are staged into shared memory 8 (generic: 4) at a
//     time with cp.async, two stages deep: each thread copies its own site
//     words of the next stage (bits2, or geno / valid / hom; the carried z
//     of a stored-step pass) and a few threads the rows' q and per-
//     individual columns, while the block computes the current stage.
//   * Packed path, K <= 8: the P rows of the thread's loci stay in
//     registers for the whole strip, and the thread counts the fresh z of
//     its loci in registers over the strip's rows (copies with z = k and, in
//     the high half-word, those with allele bit 1).  The strip's counts go
//     to a partial row; the last block of a (chain, tile) to finish -- a
//     ticket counter it resets for the next call -- adds the S strips in
//     order and stores zcounts.  No memset, no atomics on the counts.
//   * Generic path, and any path with 8 < K <= 32 (the "wide" body, K fixed
//     at run time): P[k, l, a] is read through the read-only cache at the
//     allele code of the copy (a code outside [0, A) gives w = 0), and the
//     K*A <= 64 allele-pop counters of each of the thread's loci live in a
//     shared-memory table of 16-bit cells that only the thread touches
//     (K*A x 4 loci x 128 threads x 2 bytes: at most 64 KB, sized per call);
//     the strip's nonzero cells are added to a u32 [C, K*A, L] total with
//     integer atomics (exact in any order: the result is the same bits
//     every run), and the last block of the (chain, tile) converts its
//     loci's totals to zcounts and leaves them zero for the next call.  (A
//     partial row per strip added by the last block, as above, was slower
//     at K*A = 24: that block reads S times the cells.)  The wide body keeps
//     no per-pop array in registers: each thread keeps the CDF prefixes of
//     the site in hand in its own shared-memory column (2 x K floats) and
//     counts those below u * total after the last, so z is the plain
//     version's; q comes from the staged row, the per-pop F from the
//     read-only cache, and the per-row copies per pop from four words of
//     4-bit fields (a thread adds at most 8 copies a row).  It runs at ~15x
//     its operation bound on an H100 (18.4 ms at 40 chains x K = 10 on the
//     headline panel; two passes over P, the second recomputing the
//     prefixes, took 24.8): the per-copy CDF over K waits on its P loads.
//   * Per row, the integer sums (copies per pop, four bits a pop in one
//     word, and the het-site count of gendiff) take one redux.sync each;
//     the float sums a warp butterfly; the block's 4 warp partials are added
//     in order once a stage, giving one partial per (individual, locus tile,
//     column); the last block of a (chain, strip) adds the T tiles in order
//     and stores ll and qqnum.  No float atomic: two runs from one seed are
//     bitwise equal, whatever S is.
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
#define SITE_THREADS 128
#endif
#ifndef SITE_STAGE_ROWS
#define SITE_STAGE_ROWS (SITE_PACKED ? 8 : 4)
#endif
constexpr int kThreads = SITE_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kQuad;   // loci per block
constexpr int kStage = SITE_STAGE_ROWS;   // rows staged at a time
constexpr int kStripRows = 16;            // rows a strip is given ...
constexpr int kMaxStrips = 64;            // ... up to this many strips
constexpr int kMaxStripRows = 32767;      // half-word counts per strip
constexpr int kMaxWide = 32;              // the wide body: 8 < K <= 32 ...
constexpr int kMaxCells = 64;             // ... and K*A <= 64 counters
constexpr float kEps = 1e-30f;
constexpr float kLog2 = 0.6931471805599453f;
constexpr bool kPacked = SITE_PACKED != 0;
constexpr bool kSample = SITE_SAMPLE != 0;

// Blocks per SM the launch bounds ask for (registers: 65536 / (128 x this)
// a thread): K pops of P rows and counts for 4 loci live in registers, and
// fewer registers spill (tools/site_pass_variants.py times other values).
// The wide body (K = 0 here) keeps no per-pop array but fpop's sums.
__host__ __device__ constexpr int min_blocks(int K) {
#ifdef SITE_MIN_BLOCKS
  return SITE_MIN_BLOCKS + 0 * K;
#else
  return K == 0 ? 2 : K <= 2 ? 6 : 3;
#endif
}

// Log-lik families; keep in step with kernels/fused_step.py.
enum : int {
  kFamNone = 0, kFamMode1 = 1, kFamGen = 2, kFamGendiff = 3, kFamFind = 4,
  kFamFpop = 5
};

// Per-thread accumulators and output columns of a family at K pops (K = 0:
// the wide body, whose capacities are those of kMaxWide pops and whose
// counts at the run's K come from the functions below).
template <int FAM, int K>
struct Cols {
  static constexpr int kK = K == 0 ? kMaxWide : K;
  // columns of colv / fvals read: (current, proposed) when sampling
  static constexpr int kIn = kSample ? 2 : 1;
  static constexpr int kAcc =
      FAM == kFamNone ? 0
      : FAM == kFamGendiff ? 2                       // log sum, het count
      : FAM == kFamGen ? kIn
      : (FAM == kFamFpop && kSample) ? kK : 1;
  static constexpr int kQq = kSample ? kK : 0;
  // the same at the run's n_pops
  __device__ static int acc(int nk) {
    return (FAM == kFamFpop && kSample) ? nk : kAcc;
  }
  __device__ static int out(int nk) {
    return FAM == kFamGendiff ? 1 : acc(nk);
  }
  __device__ static int qq(int nk) { return kSample ? nk : 0; }
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
  float* qqnum;            // [C, N, K] out (sampling pass)
  float* zcounts;          // [C, K, L, A] out (sampling pass)
  float* ll;               // [C, N, n_out] out
  float* part;             // [C, N, T, qq + acc] scratch: tile partials
  void* cnt_part;          // scratch of the counts (sampling pass): packed,
  //                          K <= 8: the strips' u32 [C, S, K, L], z = k in
  //                          the low and allele bit 1 in the high half-word;
  //                          else the total u32 [C, K*A, L], cell k*A + a,
  //                          zero between calls
  int* tickets;            // [C*S + C*T] zero between calls: blocks done per
  //                          (chain, strip), then per (chain, tile)
  int N, L, K, A, T, S, strip_rows, structure;
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

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

template <int K>
__device__ __forceinline__ int inverse_cdf(float u01, const float (&cum)[K]) {
  const float ut = u01 * cum[K - 1];
  int z = 0;
#pragma unroll
  for (int j = 0; j < K - 1; ++j) z += ut > cum[j] ? 1 : 0;
  return z;
}

// The wide body's CDF prefixes of both copies of one site, pop by pop in
// the order of the K <= 8 bodies (and of the plain versions):
//   packed   cum_k = A_k + B_k g, A_k, B_k the prefix sums of q f0, q d
//   generic  cum_k = sum_{j <= k} q_j P[j, l, g]  (0 for a code outside A)
// `visit(k, cum0, cum1)` sees each prefix; `prow` points at P[c, 0, l, 0]
// with pop stride `ps`.
template <class Visit>
__device__ __forceinline__ void wide_prefixes(const float* q, int nk,
                                              const float* prow, long long ps,
                                              int A, int g0, int g1,
                                              Visit visit) {
  if constexpr (kPacked) {
    float ca = 0.0f, cb = 0.0f;
#pragma unroll 4
    for (int k = 0; k < nk; ++k) {
      const float2 p = __ldg(reinterpret_cast<const float2*>(prow + k * ps));
      const float f0 = p.x, d = p.y - p.x;
      if (k == 0) {
        ca = q[0] * f0;
        cb = q[0] * d;
      } else {
        ca = ca + q[k] * f0;
        cb = cb + q[k] * d;
      }
      const float ce = ca + cb;
      visit(k, g0 ? ce : ca, g1 ? ce : ca);
    }
  } else {
    const bool ok0 = g0 >= 0 && g0 < A, ok1 = g1 >= 0 && g1 < A;
    float c0 = 0.0f, c1 = 0.0f;
#pragma unroll 4
    for (int k = 0; k < nk; ++k) {
      const float w0 = ok0 ? __ldg(prow + k * ps + g0) : 0.0f;
      const float w1 = ok1 ? __ldg(prow + k * ps + g1) : 0.0f;
      if (k == 0) {
        c0 = q[0] * w0;
        c1 = q[0] * w1;
      } else {
        c0 = c0 + q[k] * w0;
        c1 = c1 + q[k] * w1;
      }
      visit(k, c0, c1);
    }
  }
}

// P of a copy's allele in its pop z (< nk; else pop 0, as sel does), read
// as the K <= 8 bodies compute it: packed f0 + d g, generic P[z, l, g].
__device__ __forceinline__ float wide_at_z(const float* prow, long long ps,
                                           int A, int nk, int z, int g) {
  const float* p = prow + (z < nk ? z : 0) * ps;
  if constexpr (kPacked) {
    const float a0 = __ldg(p);
    return g ? a0 + (__ldg(p + 1) - a0) : a0;
  } else {
    return g >= 0 && g < A ? __ldg(p + g) : 0.0f;
  }
}

__device__ __forceinline__ int byte_of(uint32_t w, int j) {
  return (int)((w >> (8 * j)) & 0xffu);
}

// Site words staged per thread and row: packed bits2 (or geno copy 0, geno
// copy 1, valid, hom), then the carried z copies of a stored-step pass.
template <int FAM>
struct Words {
  static constexpr bool kNeedHom = FAM >= kFamGen;
  static constexpr int kPanel = kPacked ? 1 : (kNeedHom ? 4 : 3);
  static constexpr int kCount = kPanel + (kSample ? 0 : 2);
};

// Dynamic shared memory of a launch: the count table (16-bit cells
// [K*A][kQuad][kThreads]) where the counts are not kept in registers.
__host__ __device__ constexpr bool table_counts(int K) {
  return kSample && (!kPacked || K == 0);
}

template <int K, int FAM>
__global__ void __launch_bounds__(kThreads, min_blocks(K))
site_kernel(const SiteArgs a) {
  using CL = Cols<FAM, K>;
  using WD = Words<FAM>;
  constexpr bool kWide = K == 0;                  // 8 < K <= 32 at run time
  constexpr int KR = kWide ? 1 : K;               // per-pop register arrays
  constexpr int kNVCap = CL::kQq + CL::kAcc;
  constexpr int kNW = WD::kCount;
  constexpr bool kGenFam = FAM == kFamGen || FAM == kFamGendiff;
  constexpr bool kNeedCol = kGenFam || FAM == kFamFind;
  constexpr bool kHetInt = FAM == kFamGendiff;    // acc[1] is a count
  constexpr int kRowCols = CL::kK + 2;            // q[K], colv[kIn]
  constexpr int kQqWordsCap = (CL::kQq + 1) / 2;  // two pops a redux
  constexpr int kQqW = kWide ? kMaxWide / 8 : 1;  // 8 pops a word
  constexpr bool kRegCnt = kPacked && kSample && !kWide;
  constexpr bool kTable = table_counts(K);
  __shared__ uint32_t stage[2][kNW][kStage][kThreads];
  __shared__ float rowc[2][kStage][kRowCols];
  __shared__ float part[2][kStage][kWarps][kNVCap > 0 ? kNVCap : 1];
  __shared__ int last;
  // dynamic: the count table, 16-bit [K*A][kQuad][kThreads], then (wide
  // sampling pass) the CDF prefixes of the site in hand, f32 [2][K][kThreads]
  extern __shared__ uint16_t cnt_tab[];
  const int N = a.N, L = a.L, T = a.T, A = a.A;
  const int nk = kWide ? a.K : K;
  const int n_qq = CL::qq(nk), n_acc = CL::acc(nk), n_out = CL::out(nk);
  const int n_nv = n_qq + n_acc;
  const int n_cells = nk * A;
  const int tile = blockIdx.x, strip = blockIdx.y, c = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int l0 = tile * kTile + tid * kQuad;
  const bool vec = (L % 4) == 0;
  const int n_live = min(kQuad, L - l0);       // <= 0: thread has no locus
  const bool structure = a.structure != 0;
  // the expectation way reads the Q mixture in place of P at z
  const bool mix = kGenFam && !structure;
  const bool need_q = kSample || mix;
  const int n_begin = strip * a.strip_rows;
  const int n_end = min(N, n_begin + a.strip_rows);
  const int n_rows = max(0, n_end - n_begin);
  const int n_stages = (n_rows + kStage - 1) / kStage;
  const long long pop_stride = (long long)L * A;  // of P [C, K, L, A]
  float* cum_s = reinterpret_cast<float*>(
      cnt_tab + (kTable ? n_cells * kQuad * kThreads : 0));

  // packed path, K <= 8: the P rows of the thread's loci, and its counts of
  // copies with z = k (low half-word) and with z = k and allele bit 1 (high)
  float f0[kQuad][KR], d[kQuad][KR];
  uint32_t cnt[kQuad][KR];
#pragma unroll
  for (int j = 0; j < kQuad; ++j)
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      f0[j][k] = d[j][k] = 0.0f;
      cnt[j][k] = 0u;
    }
  if constexpr (kPacked && !kWide) load_freq<K>(a.freq, c, L, l0, f0, d);
  if constexpr (kTable) {
    // the thread's own cells of the count table
    for (int i = 0; i < n_cells * kQuad; ++i) cnt_tab[i * kThreads + tid] = 0;
  }
  float fv0[KR], fv1[KR];                      // per-pop F (current, proposed)
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    fv0[k] = fv1[k] = 0.0f;
    if constexpr (FAM == kFamFpop && !kWide) {
      fv0[k] = a.fvals[((long long)c * K + k) * CL::kIn];
      if constexpr (kSample) fv1[k] = a.fvals[((long long)c * K + k) * 2 + 1];
    }
  }
  uint32_t chain = 0;
  if constexpr (kSample) chain = (uint32_t)a.chain_key[c];

  // Issue the copies of stage `s` into buffer `buf` (one commit group).
  auto stage_rows = [&](int buf, int s) {
    for (int rr = 0; rr < kStage; ++rr) {
      const int n = n_begin + s * kStage + rr;
      if (n >= n_end) break;
      if (n_live <= 0) break;
      const int8_t* src[kNW];
      const long long cn = (long long)c * N + n;
      if constexpr (kPacked) {
        src[0] = a.bits2 + c * a.plane_cs + (long long)n * L;
      } else {
        const int8_t* grow = a.geno + c * a.plane_cs + (long long)n * 2 * L;
        src[0] = grow;
        src[1] = grow + L;
        src[2] = a.valid + (long long)n * L;
        if constexpr (WD::kNeedHom) src[3] = a.hom + (long long)n * L;
      }
      if constexpr (!kSample) {
        src[WD::kPanel] = a.z_in + cn * 2 * L;
        src[WD::kPanel + 1] = a.z_in + cn * 2 * L + L;
      }
#pragma unroll
      for (int w = 0; w < kNW; ++w) {
        if (vec) {
          cp_async4(&stage[buf][w][rr][tid], src[w] + l0);
        } else {
          int b[kQuad];
          load_bytes(src[w], l0, L, false, b);
          stage[buf][w][rr][tid] = (uint32_t)b[0] | ((uint32_t)b[1] << 8) |
                                   ((uint32_t)b[2] << 16) |
                                   ((uint32_t)b[3] << 24);
        }
      }
    }
    const int row_cols = nk + 2;
    for (int i = tid; i < kStage * row_cols; i += kThreads) {
      const int rr = i / row_cols, col = i - rr * row_cols;
      const int n = n_begin + s * kStage + rr;
      if (n >= n_end) continue;
      const long long cn = (long long)c * N + n;
      if (col < nk) {
        if (need_q) cp_async4(&rowc[buf][rr][col], a.q + cn * nk + col);
      } else if (kNeedCol && col - nk < CL::kIn) {
        cp_async4(&rowc[buf][rr][col], a.colv + cn * CL::kIn + (col - nk));
      }
    }
    cp_async_commit();
  };

  // One partial per (row, column) of stage `s`: the warps in order.
  auto write_partials = [&](int buf, int s) {
    if constexpr (kNVCap > 0) {
      for (int i = tid; i < kStage * n_nv; i += kThreads) {
        const int rr = i / n_nv, v = i - rr * n_nv;
        const int n = n_begin + s * kStage + rr;
        if (n >= n_end) continue;
        float t = part[buf][rr][0][v];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) t = t + part[buf][rr][w][v];
        a.part[(((long long)c * N + n) * T + tile) * n_nv + v] = t;
      }
    }
  };

  if (n_stages > 0) stage_rows(0, 0);
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < n_stages) stage_rows(buf ^ 1, s + 1);
    if (s > 0) write_partials(buf ^ 1, s - 1);
    const int rows = min(kStage, n_rows - s * kStage);
    for (int rr = 0; rr < rows; ++rr) {
      const int n = n_begin + s * kStage + rr;
      const long long cn = (long long)c * N + n;
      const float* qrow = rowc[buf][rr];       // q[nk], then colv
      float qk[KR];
#pragma unroll
      for (int k = 0; k < KR; ++k) qk[k] = need_q ? qrow[k] : 0.0f;
      float cv0 = 0.0f, cv1 = 0.0f;
      if constexpr (kNeedCol) {
        cv0 = qrow[nk];
        if constexpr (CL::kIn == 2) cv1 = qrow[nk + 1];
      }
      float acc[CL::kAcc > 0 ? CL::kAcc : 1];
#pragma unroll
      for (int i = 0; i < (CL::kAcc > 0 ? CL::kAcc : 1); ++i) acc[i] = 0.0f;
      // copies per pop of the row's sites, 4 bits a pop (8 pops a word)
      uint32_t qqw[kQqW];
#pragma unroll
      for (int i = 0; i < kQqW; ++i) qqw[i] = 0u;
      uint32_t het = 0;     // gendiff: het sites counted once each

      if (n_live > 0) {
        int g0v[kQuad], g1v[kQuad], okv[kQuad], homv[kQuad];
        if constexpr (kPacked) {
          const uint32_t w = stage[buf][0][rr][tid];
#pragma unroll
          for (int j = 0; j < kQuad; ++j) {
            const int bits = byte_of(w, j);
            g0v[j] = bits & 1;
            g1v[j] = (bits >> 1) & 1;
            okv[j] = bits & 4;
            homv[j] = g0v[j] == g1v[j] ? 1 : 0;
          }
        } else {
          const uint32_t w0 = stage[buf][0][rr][tid];
          const uint32_t w1 = stage[buf][1][rr][tid];
          const uint32_t wv = stage[buf][2][rr][tid];
          uint32_t wh = 0;
          if constexpr (WD::kNeedHom) wh = stage[buf][3][rr][tid];
#pragma unroll
          for (int j = 0; j < kQuad; ++j) {
            g0v[j] = byte_of(w0, j);
            g1v[j] = byte_of(w1, j);
            okv[j] = byte_of(wv, j);
            homv[j] = byte_of(wh, j);
          }
        }
        int z0v[kQuad], z1v[kQuad];
        float u0[kQuad], u1[kQuad];
        if constexpr (kSample) {
          const long long row = (long long)n * 2 * L;
          const float* inj =
              a.u == nullptr ? nullptr : a.u + (long long)c * N * 2 * L;
          quad_uniforms(inj, row + l0, n_live, a.step, chain, a.k0, a.k1,
                        u0);
          quad_uniforms(inj, row + L + l0, n_live, a.step, chain, a.k0,
                        a.k1, u1);
        } else {
          const uint32_t wz0 = stage[buf][WD::kPanel][rr][tid];
          const uint32_t wz1 = stage[buf][WD::kPanel + 1][rr][tid];
#pragma unroll
          for (int j = 0; j < kQuad; ++j) {
            z0v[j] = byte_of(wz0, j);
            z1v[j] = byte_of(wz1, j);
          }
        }
#pragma unroll
        for (int j = 0; j < kQuad; ++j) {
          if (j >= n_live) {
            z0v[j] = z1v[j] = 0;
            continue;
          }
          const int g0 = g0v[j], g1 = g1v[j];
          const bool valid = okv[j] != 0, hom = homv[j] != 0;
          // the wide body's P row of the site: P[c, 0, l, 0]
          const float* prow =
              a.freq + ((long long)c * nk * L + (l0 + j)) * A;
          // generic path: per-pop probability of each copy's allele
          float w0[KR], w1[KR];
          if constexpr (!kPacked && !kWide) {
            copy_probs<K>(a.freq, c, L, A, l0 + j, g0, w0);
            copy_probs<K>(a.freq, c, L, A, l0 + j, g1, w1);
          }
          float tot0 = 0.0f, tot1 = 0.0f;        // Q-mixture probabilities
          if (need_q) {
            if constexpr (kWide) {
              // the prefixes, kept in the thread's shared-memory column
              // when sampling; then the count of those below u * total
              wide_prefixes(qrow, nk, prow, pop_stride, A, g0, g1,
                            [&](int k, float c0, float c1) {
                              if constexpr (kSample) {
                                cum_s[k * kThreads + tid] = c0;
                                cum_s[(nk + k) * kThreads + tid] = c1;
                              }
                              tot0 = c0;
                              tot1 = c1;
                            });
              if constexpr (kSample) {
                const float ut0 = u0[j] * tot0, ut1 = u1[j] * tot1;
                int zz0 = 0, zz1 = 0;
#pragma unroll 4
                for (int k = 0; k < nk - 1; ++k) {
                  zz0 += ut0 > cum_s[k * kThreads + tid] ? 1 : 0;
                  zz1 += ut1 > cum_s[(nk + k) * kThreads + tid] ? 1 : 0;
                }
                z0v[j] = zz0;
                z1v[j] = zz1;
              }
            } else {
              // CDF prefixes.  Packed: cum_k = A_k + B_k * g with A_k, B_k
              // the prefix sums of q*f0, q*d; the allele bit g is 0 or 1,
              // so A_k + B_k * g is A_k (A_k >= 0) or A_k + B_k exactly, and
              // both copies share the two prefix rows.
              float cum0[KR], cum1[KR];
              if constexpr (kPacked) {
                float ca = qk[0] * f0[j][0], cb = qk[0] * d[j][0];
                float ce = ca + cb;
                cum0[0] = g0 ? ce : ca;
                cum1[0] = g1 ? ce : ca;
#pragma unroll
                for (int k = 1; k < K; ++k) {
                  ca = ca + qk[k] * f0[j][k];
                  cb = cb + qk[k] * d[j][k];
                  ce = ca + cb;
                  cum0[k] = g0 ? ce : ca;
                  cum1[k] = g1 ? ce : ca;
                }
              } else {
                float c0 = qk[0] * w0[0], c1 = qk[0] * w1[0];
                cum0[0] = c0;
                cum1[0] = c1;
#pragma unroll
                for (int k = 1; k < K; ++k) {
                  c0 = c0 + qk[k] * w0[k];
                  c1 = c1 + qk[k] * w1[k];
                  cum0[k] = c0;
                  cum1[k] = c1;
                }
              }
              tot0 = cum0[K - 1];
              tot1 = cum1[K - 1];
              if constexpr (kSample) {
                z0v[j] = inverse_cdf<K>(u0[j], cum0);
                z1v[j] = inverse_cdf<K>(u1[j], cum1);
              }
            }
          }
          if (!valid) continue;
          const int z0 = z0v[j], z1 = z1v[j];      // the conditioning z
          if constexpr (kSample) {
            if constexpr (kWide) {
#pragma unroll
              for (int i = 0; i < kQqW; ++i)
                qqw[i] += ((z0 >> 3) == i ? 1u << (4 * (z0 & 7)) : 0u) +
                          ((z1 >> 3) == i ? 1u << (4 * (z1 & 7)) : 0u);
            } else {
              qqw[0] += (1u << (4 * z0)) + (1u << (4 * z1));
            }
            if constexpr (kRegCnt) {
              // a copy adds 1 to its pop's count and, with allele bit 1, 1
              // to the high half-word
              const uint32_t v0 = 1u + ((uint32_t)g0 << 16);
              const uint32_t v1 = 1u + ((uint32_t)g1 << 16);
#pragma unroll
              for (int k = 0; k < K; ++k)
                cnt[j][k] += (z0 == k ? v0 : 0u) + (z1 == k ? v1 : 0u);
            }
            if constexpr (kTable) {
              // one cell per (pop, allele); a code outside [0, A) counts
              // nowhere, as in allele_counts
              if (g0 >= 0 && g0 < A)
                cnt_tab[((z0 * A + g0) * kQuad + j) * kThreads + tid] += 1;
              if (g1 >= 0 && g1 < A)
                cnt_tab[((z1 * A + g1) * kQuad + j) * kThreads + tid] += 1;
            }
          }
          if constexpr (FAM != kFamNone) {
            // P of each copy's allele in its pop z: f0 + d * g (packed; g is
            // 0 or 1, so f0 or f0 + d exactly)
            float p0, p1;
            if (mix) {
              p0 = tot0;
              p1 = tot1;
            } else if constexpr (kWide) {
              p0 = wide_at_z(prow, pop_stride, A, nk, z0, g0);
              p1 = wide_at_z(prow, pop_stride, A, nk, z1, g1);
            } else if constexpr (kPacked) {
              const float a0 = sel<K>(f0[j], z0), a1 = sel<K>(f0[j], z1);
              p0 = g0 ? a0 + sel<K>(d[j], z0) : a0;
              p1 = g1 ? a1 + sel<K>(d[j], z1) : a1;
            } else {
              p0 = sel<K>(w0, z0);
              p1 = sel<K>(w1, z1);
            }
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
                  het += 1u;
                }
              }
            } else {
              // inbreeding families: f per individual (find) or of pop z0
              // (the wide body reads the pop's F through the read-only
              // cache; a z outside [0, K) reads pop 0, as sel does)
              const float* fz = nullptr;
              if constexpr (FAM == kFamFpop && kWide)
                fz = a.fvals + ((long long)c * nk + (z0 < nk ? z0 : 0)) *
                                   CL::kIn;
              float fa;
              if constexpr (FAM == kFamFind) {
                fa = cv0;
              } else if constexpr (kWide) {
                fa = __ldg(fz);
              } else {
                fa = sel<K>(fv0, z0);
              }
              if constexpr (kSample) {
                // MH terms over the F-dependent same-z sites: one log of a
                // quotient, the common p0 / 2 p0 p1 factors cancelled
                if (same) {
                  float fb;
                  if constexpr (FAM == kFamFind) {
                    fb = cv1;
                  } else if constexpr (kWide) {
                    fb = __ldg(fz + 1);
                  } else {
                    fb = sel<K>(fv1, z0);
                  }
                  const float num = hom ? p0 * (1.0f - fb) + fb : 1.0f - fb;
                  const float den = hom ? p0 * (1.0f - fa) + fa : 1.0f - fa;
                  const float dl = logf(fmaxf(num, kEps) / fmaxf(den, kEps));
                  if constexpr (FAM == kFamFind) {
                    acc[0] = acc[0] + dl;
                  } else {
#pragma unroll
                    for (int k = 0; k < CL::kAcc; ++k)
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

      // the row's warp partials: integer sums by redux, float sums by a
      // butterfly
      if constexpr (kNVCap > 0) {
        const int n_qq_words = (n_qq + 1) / 2;
#pragma unroll
        for (int w = 0; w < kQqWordsCap; ++w) {
          if (w >= n_qq_words) break;
          const uint32_t word = qqw[w >> 2];
          const int sh = 8 * (w & 3);
          const uint32_t pair = ((word >> sh) & 0xfu) |
                                (((word >> (sh + 4)) & 0xfu) << 16);
          const uint32_t s2 = __reduce_add_sync(0xffffffffu, pair);
          if (lane == 0) {
            part[buf][rr][warp][2 * w] = (float)(s2 & 0xffffu);
            if (2 * w + 1 < n_qq)
              part[buf][rr][warp][2 * w + 1] = (float)(s2 >> 16);
          }
        }
#pragma unroll
        for (int i = 0; i < CL::kAcc; ++i) {
          if (i >= n_acc) break;
          float s2;
          if (kHetInt && i == 1) {
            s2 = (float)__reduce_add_sync(0xffffffffu, het);
          } else {
            s2 = warp_sum(acc[i]);
          }
          if (lane == 0) part[buf][rr][warp][n_qq + i] = s2;
        }
      }
    }
  }
  __syncthreads();
  if (n_stages > 0) write_partials((n_stages - 1) & 1, n_stages - 1);

  // The strip's counts of the tile's loci, then the last block of the
  // (chain, tile) adds the strips in order.
  if constexpr (kRegCnt) {
    if (n_live > 0) {
      uint32_t* cnt_part = static_cast<uint32_t*>(a.cnt_part);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint32_t* dst = cnt_part + (((long long)c * a.S + strip) * K + k) * L;
#pragma unroll
        for (int j = 0; j < kQuad; ++j)
          if (j < n_live) dst[l0 + j] = cnt[j][k];
      }
    }
  }
  if constexpr (kTable) {
    if (n_live > 0) {
      uint32_t* total = static_cast<uint32_t*>(a.cnt_part);
      for (int cell = 0; cell < n_cells; ++cell) {
        uint32_t* dst = total + ((long long)c * n_cells + cell) * L + l0;
#pragma unroll
        for (int j = 0; j < kQuad; ++j) {
          const uint32_t v = cnt_tab[(cell * kQuad + j) * kThreads + tid];
          if (j < n_live && v != 0u) atomicAdd(dst + j, v);
        }
      }
    }
  }
  __threadfence();
  __syncthreads();
  int* tick_rows = a.tickets + c * a.S + strip;
  int* tick_cnt = a.tickets + a.S * gridDim.z + c * T + tile;
  if (tid == 0) {
    int flags = atomicAdd(tick_rows, 1) == T - 1 ? 1 : 0;
    if (kSample) flags |= atomicAdd(tick_cnt, 1) == a.S - 1 ? 2 : 0;
    last = flags;
  }
  __syncthreads();
  if (last == 0) return;
  __threadfence();

  if (last & 1) {
    // ll and qqnum of the strip's rows: the tiles' partials in order
    const int n_cols = n_qq + n_out;
    for (int i = tid; i < n_rows * n_cols; i += kThreads) {
      const int r = i / n_cols, v = i - r * n_cols;
      const long long cn = (long long)c * N + n_begin + r;
      const float* src = a.part + cn * T * n_nv;
      float s = __ldcg(src + v);
      for (int t = 1; t < T; ++t) s = s + __ldcg(src + t * n_nv + v);
      if (v < n_qq) {
        a.qqnum[cn * nk + v] = s;
        continue;
      }
      if constexpr (FAM == kFamGendiff) {
        float h = __ldcg(src + n_qq + 1);
        for (int t = 1; t < T; ++t) h = h + __ldcg(src + t * n_nv + n_qq + 1);
        const float dh = slog(a.colv[2 * cn + 1]) - slog(a.colv[2 * cn]);
        s = s + dh * h;
      }
      a.ll[cn * n_out + (v - n_qq)] = s;
    }
    if (tid == 0) *tick_rows = 0;
  }
  if constexpr (kRegCnt) {
    if ((last & 2) && n_live > 0) {
      const uint32_t* cnt_part = static_cast<const uint32_t*>(a.cnt_part);
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int j = 0; j < kQuad; ++j) {
          if (j >= n_live) continue;
          uint32_t zk = 0, ones = 0;
          for (int st = 0; st < a.S; ++st) {
            const uint32_t p = __ldcg(cnt_part +
                                 (((long long)c * a.S + st) * K + k) * L +
                                 l0 + j);
            zk += p & 0xffffu;
            ones += p >> 16;
          }
          float2 out;
          out.x = (float)(zk - ones);
          out.y = (float)ones;
          *reinterpret_cast<float2*>(
              a.zcounts + (((long long)c * K + k) * L + l0 + j) * 2) = out;
        }
      }
    }
  }
  if constexpr (kTable) {
    if ((last & 2) && n_live > 0) {
      uint32_t* total = static_cast<uint32_t*>(a.cnt_part);
      for (int cell = 0; cell < n_cells; ++cell) {
        const int k = cell / A, al = cell - k * A;
        uint32_t* src = total + ((long long)c * n_cells + cell) * L + l0;
#pragma unroll
        for (int j = 0; j < kQuad; ++j) {
          if (j >= n_live) continue;
          a.zcounts[(((long long)c * nk + k) * L + l0 + j) * A + al] =
              (float)__ldcg(src + j);
          src[j] = 0u;
        }
      }
    }
  }
  if constexpr (kSample) {
    if ((last & 2) && tid == 0) *tick_cnt = 0;
  }
}

inline int site_tiles(int L) { return (L + kTile - 1) / kTile; }

// Launch one instantiation; the count table, where the counts are not kept
// in registers, is the launch's dynamic shared memory.
template <int K, int FAM>
int launch_one(const SiteArgs& a, dim3 grid, cudaStream_t s) {
  size_t dyn =
      table_counts(K) ? (size_t)a.K * a.A * kQuad * kThreads * 2 : 0;
  if (K == 0 && kSample) dyn += (size_t)2 * a.K * kThreads * sizeof(float);
  // dynamic bytes opted in so far, per device: the attribute is set on the
  // current device (beyond the 64th, it is set at every launch)
  static size_t opted[64] = {};
  int dev = 0;
  const cudaError_t g = cudaGetDevice(&dev);
  if (g != cudaSuccess) return (int)g;
  size_t* seen = dev < 64 ? &opted[dev] : nullptr;
  if (seen == nullptr || dyn > *seen) {
    const cudaError_t e = cudaFuncSetAttribute(
        site_kernel<K, FAM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (e != cudaSuccess) return (int)e;
    if (seen != nullptr) *seen = dyn;
  }
  site_kernel<K, FAM><<<grid, kThreads, dyn, s>>>(a);
  return (int)cudaGetLastError();
}

template <int FAM>
int launch_family(int K, const SiteArgs& a, dim3 grid, cudaStream_t s) {
  // a count table holds at most kMaxCells cells a locus
  if (a.K * a.A > kMaxCells && table_counts(K > 8 ? 0 : K))
    return (int)cudaErrorInvalidValue;
#define SITE_CASE(KK) \
  case KK:            \
    return launch_one<KK, FAM>(a, grid, s);
  switch (K) {
#ifdef SITE_K_ONLY
    SITE_CASE(SITE_K_ONLY)
#else
    SITE_CASE(1) SITE_CASE(2) SITE_CASE(3) SITE_CASE(4)
    SITE_CASE(5) SITE_CASE(6) SITE_CASE(7) SITE_CASE(8)
#endif
    default:
      break;
  }
#undef SITE_CASE
  if (K > 8 && K <= kMaxWide && K * a.A <= kMaxCells)
    return launch_one<0, FAM>(a, grid, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One launch function per source (SITE_LAUNCH).  `fam` is a kFam* value; the
// operand groups a family does not read may be null.  ll [C, N, n_out], the
// scratch part [C, N, T, qq + acc columns], cnt_part (packed, K <= 8:
// u32 [C, S, K, L]; else u32 [C, K*A, L], zero before the first call) and
// tickets [C*S + C*T] (zero before the first call; every call leaves them
// and the counts' total zero) are sized by the wrapper with
// T = site_pass_tiles(L) and S = site_pass_strips(...).
extern "C" int SITE_LAUNCH(
    const void* q, const void* freq, const void* bits2, const void* geno,
    const void* valid, const void* hom, const void* z_in, const void* colv,
    const void* fvals, const void* u, void* z, void* qqnum, void* zcounts,
    void* ll, void* part, void* cnt_part, void* tickets, int C, int N, int L,
    int K, int A, int fam, int structure, int S, long long plane_cs,
    unsigned k0, unsigned k1, const void* chain_key, unsigned step,
    void* stream) {
  if (C == 0 || N == 0 || L == 0) return 0;
  if (S < 1 || (N + S - 1) / S > kMaxStripRows) return (int)cudaErrorInvalidValue;
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
  a.qqnum = (float*)qqnum;
  a.zcounts = (float*)zcounts;
  a.ll = (float*)ll;
  a.part = (float*)part;
  a.cnt_part = cnt_part;
  a.tickets = (int*)tickets;
  a.N = N;
  a.L = L;
  a.K = K;
  a.A = A;
  a.T = site_tiles(L);
  a.S = S;
  a.strip_rows = (N + S - 1) / S;
  a.structure = structure;
  a.plane_cs = plane_cs;
  a.k0 = k0;
  a.k1 = k1;
  a.step = step;
  a.chain_key = (const int*)chain_key;
  const dim3 grid(a.T, S, C);
  switch (fam) {
    case kFamMode1:
      return launch_family<kFamMode1>(K, a, grid, s);
    case kFamGen:
      return launch_family<kFamGen>(K, a, grid, s);
    case kFamFind:
      return launch_family<kFamFind>(K, a, grid, s);
    case kFamFpop:
      return launch_family<kFamFpop>(K, a, grid, s);
#if SITE_SAMPLE
    case kFamNone:
      return launch_family<kFamNone>(K, a, grid, s);
    case kFamGendiff:
      return launch_family<kFamGendiff>(K, a, grid, s);
#endif
    default:
      return (int)cudaErrorInvalidValue;
  }
}
