// The per-site pass of the diploid sweep: one kernel body for every entry
// point of instruct_tpu/kernels/fused_step.py:_site_pass (_site_kernel).
//
// A source that includes this file defines SITE_PACKED (1: the packed
// biallelic plane bits2; 0: the generic path, allele codes in [0, A) with
// separate valid and hom planes), SITE_SAMPLE (1: the pass draws z; 0: it
// evaluates a log-lik at the carried z) and SITE_LAUNCH (the name of its
// launch function).  The four sources are compiled side by side; each
// instantiates the body for K = 1..8 and for 8 < K <= 32 in two pop buckets
// (K at run time; K*A <= 64, the JAX step's gate), for the log-lik families
// of its half:
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
//   * Generic path, K <= 8: P[k, l, a] is read through the read-only cache
//     at the allele code of the copy (a code outside [0, A) gives w = 0),
//     and the K*A <= 64 allele-pop counters of each of the thread's loci
//     live in a shared-memory table of 16-bit cells that only the thread
//     touches (K*A x 4 loci x 128 threads x 2 bytes: at most 64 KB, sized
//     per call); the strip's nonzero cells are added to a u32 [C, K*A, L]
//     total with integer atomics (exact in any order: the result is the
//     same bits every run), and the last block of the (chain, tile)
//     converts its loci's totals to zcounts and leaves them zero for the
//     next call.  (A partial row per strip added by the last block, as
//     above, was slower at K*A = 24: that block reads S times the cells.)
//   * 8 < K <= 32 (the "wide" body, both paths): one instantiation per pop
//     bucket (K <= 16, K <= 32), the run's K at run time.  The block copies
//     the P rows of its tile into shared memory once (cp.async of
//     consecutive loci, with the first stage of rows) and reuses them over
//     its strip: packed (f0, d) pairs, generic all A alleles, each thread's
//     4 loci in its own column of every pop plane (no bank conflict,
//     whatever the pop or allele a site reads).  A stored-step pass that
//     reads P only at z, generic or at K > 16, reads it through the
//     read-only cache instead.  Each row's q sits in registers (zero past
//     K), each site's prefixes in two register arrays of the bucket's
//     width (one (A_k, B_k) pair per packed site for both copies), filled
//     and then counted below u * total in unrolled runs of 2 (16 bucket)
//     or 4 pops that stop at the first run past K.  A padded pop adds
//     q * P = 0 * 0 = +0, so its prefix equals the total and counts
//     nowhere (u * total never exceeds it; z is clamped to K - 1 for an
//     injected u >= 1, where the plain version's count stops).  The
//     strip's allele-pop counts go to byte fields in shared memory
//     (packed: a 16-bit cell per pop and locus, copies with z = k in the
//     low byte, those with allele bit 1 in the high one; generic: a byte
//     per cell; at most 127 rows a strip), then to the u32 total by
//     integer atomics as above; the per-row copies per pop to 4-bit fields
//     of 64-bit words.  The wrapper's launch plan
//     (kernels/fused_step.py:site_plan) gives strips of up to 64 rows.  At
//     40 chains x K = 10 on the headline panel it runs at ~6.8x its
//     operation bound on an H100 (8.5 ms), the CDF over K ~40% of it and
//     issue-bound: the 4 sites' prefixes side by side, recomputed in a
//     second pass instead of kept, take longer (tools/site_pass_variants.py).
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
// The wide body of pop bucket KB: rows staged at a time (4 where the per-
// row sums are many -- the 32 bucket, the per-pop F sums of fpop -- so
// that their static shared memory leaves room for another block), and
// pops a run of its unrolled prefix loops (K is padded to a multiple of
// it); tools/site_pass_variants.py times other values.
__host__ __device__ constexpr int wide_stage(int KB, bool fpop) {
#ifdef SITE_WIDE_STAGE_ROWS
  return SITE_WIDE_STAGE_ROWS + 0 * KB * fpop;
#else
  return KB <= 16 && !fpop ? kStage : 4;
#endif
}
__host__ __device__ constexpr int wide_run(int KB) {
#ifdef SITE_WIDE_RUN
  return SITE_WIDE_RUN + 0 * KB;
#else
  return KB <= 16 ? 2 : 4;
#endif
}
constexpr int kStripRows = 16;            // rows a strip is given ...
constexpr int kMaxStrips = 64;            // ... up to this many strips
constexpr int kMaxStripRows = 32767;      // half-word counts per strip
constexpr int kNarrow = 8;                // K above: the wide body ...
constexpr int kMaxWide = 32;              // ... up to K = 32 ...
constexpr int kMaxCells = 64;             // ... and K*A <= 64 counters
constexpr int kWideStripRows = 127;       // byte counts per strip (wide)
constexpr float kEps = 1e-30f;
constexpr float kLog2 = 0.6931471805599453f;
constexpr bool kPacked = SITE_PACKED != 0;
constexpr bool kSample = SITE_SAMPLE != 0;

// Blocks per SM the launch bounds ask for (registers: 65536 / (128 x this)
// a thread): K pops of P rows and counts for 4 loci live in registers, and
// fewer registers spill (tools/site_pass_variants.py times other values).
// The wide buckets (K = 16, 32 here) keep q and a site's two prefix rows.
__host__ __device__ constexpr int min_blocks(int K) {
#ifdef SITE_MIN_BLOCKS
  return SITE_MIN_BLOCKS + 0 * K;
#else
  return K > kNarrow ? (K <= 16 ? 3 : 2) : K <= 2 ? 6 : 3;
#endif
}

// The pop bucket of the wide body that runs K pops (8 < K <= 32).
__host__ __device__ constexpr int wide_bucket(int K) {
  return K <= 16 ? 16 : 32;
}

// Log-lik families; keep in step with kernels/fused_step.py.
enum : int {
  kFamNone = 0, kFamMode1 = 1, kFamGen = 2, kFamGendiff = 3, kFamFind = 4,
  kFamFpop = 5
};

// Per-thread accumulators and output columns of a family at K pops (K > 8:
// a wide bucket, whose capacities are those of K pops and whose counts at
// the run's K come from the functions below).
template <int FAM, int K>
struct Cols {
  static constexpr int kK = K;
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

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

// The wide body's dynamic shared memory.  A pop plane is [kQuad][kThreads]:
// column j * kThreads + tid is locus l0 + j of thread tid.  First P of the
// block's tile for K rounded up to a run of pops (the pops past K zero):
// packed (f0, d) float2 [Kr][plane], generic float [Kr][A][plane]; then, in a
// sampling pass, the strip's allele-pop counts: packed u16 [K][plane]
// (copies with z = k in the low byte, those with allele bit 1 in the high
// byte), generic u8 [K*A][plane].
constexpr int kPlane = kQuad * kThreads;
__host__ __device__ constexpr int pops_run(int nk, int KB) {
  return (nk + wide_run(KB) - 1) / wide_run(KB) * wide_run(KB);
}
__host__ __device__ constexpr size_t wide_p_bytes(int nk, int A, int KB) {
  return (size_t)pops_run(nk, KB) * kPlane * (kPacked ? 8 : 4 * A);
}
__host__ __device__ constexpr size_t wide_cnt_bytes(int nk, int A) {
  return kSample ? (size_t)nk * kPlane * (kPacked ? 2 : A) : 0;
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

// Whether a sampling pass adds its counts to the u32 total (the generic
// path, and the wide body on both paths); K <= 8 generic keeps the strip's
// counts in a table of 16-bit cells [K*A][kQuad][kThreads] in the dynamic
// shared memory.
__host__ __device__ constexpr bool total_counts(int K) {
  return kSample && (!kPacked || K > kNarrow);
}

// Dynamic shared memory of a launch of the body for K (a bucket when
// K > 8) at the run's nk pops and A alleles, in family `fam` (the wide
// body stages no P in a stored-step pass that reads P only at z -- the
// structure way, or a family that is not the G pass's -- on the generic
// path or at K > 16).
__host__ __device__ constexpr size_t dyn_bytes(int K, int nk, int A, int fam,
                                               bool structure) {
  return K > kNarrow
             ? (kSample || (kPacked && K <= 16) ||
                        (fam == kFamGen && !structure)
                    ? wide_p_bytes(nk, A, K)
                    : 0) + wide_cnt_bytes(nk, A)
         : total_counts(K) ? (size_t)nk * A * kPlane * 2
                           : 0;
}

template <int K, int FAM>
__global__ void __launch_bounds__(kThreads, min_blocks(K))
site_kernel(const SiteArgs a) {
  using CL = Cols<FAM, K>;
  using WD = Words<FAM>;
  constexpr bool kWide = K > kNarrow;             // a bucket, K at run time
  constexpr int KR = kWide ? 1 : K;               // K <= 8 register arrays
  constexpr int KW = kWide ? K : 1;               // wide register arrays
  constexpr int kSt =                             // rows staged at once
      kWide ? wide_stage(K, FAM == kFamFpop && kSample) : kStage;
  constexpr int kRun = wide_run(K);               // pops a prefix run
  constexpr int kNVCap = CL::kQq + CL::kAcc;
  constexpr int kNW = WD::kCount;
  constexpr bool kGenFam = FAM == kFamGen || FAM == kFamGendiff;
  constexpr bool kNeedCol = kGenFam || FAM == kFamFind;
  constexpr bool kHetInt = FAM == kFamGendiff;    // acc[1] is a count
  constexpr int kRowCols = CL::kK + 2;            // q[K], colv[kIn]
  constexpr int kQqWordsCap = (CL::kQq + 1) / 2;  // two pops a redux
  constexpr int kQ64 = kWide ? K / 16 : 1;        // wide: 16 pops a word
  constexpr bool kRegCnt = kPacked && kSample && !kWide;
  constexpr bool kTotal = total_counts(K);
  constexpr bool kTable = kTotal && !kWide;
  __shared__ uint32_t stage[2][kNW][kSt][kThreads];
  __shared__ float rowc[2][kSt][kRowCols];
  __shared__ float part[2][kSt][kWarps][kNVCap > 0 ? kNVCap : 1];
  __shared__ int last;
  // dynamic (dyn_bytes): K <= 8 generic, the count table; wide, P of the
  // tile and the strip's byte counts (wide_p_bytes)
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  uint16_t* cnt_tab = reinterpret_cast<uint16_t*>(dyn_smem);
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
  // the wide body stages P but in a stored-step pass that reads P only at
  // z, generic or at K > 16: that reads it through the read-only cache
  const bool stage_p = kWide && (kSample || mix || (kPacked && K <= 16));
  const int n_begin = strip * a.strip_rows;
  const int n_end = min(N, n_begin + a.strip_rows);
  const int n_rows = max(0, n_end - n_begin);
  const int n_stages = (n_rows + kSt - 1) / kSt;
  // the wide body's planes: P as (f0, d) pairs or per allele, the counts
  const int nkr = pops_run(nk, K);
  float2* wp2 = reinterpret_cast<float2*>(dyn_smem);
  float* wpa = reinterpret_cast<float*>(dyn_smem);
  unsigned char* wcnt = dyn_smem + (kWide ? wide_p_bytes(nk, A, K) : 0);
  uint16_t* wcnt2 = reinterpret_cast<uint16_t*>(wcnt);

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
  if constexpr (kWide && kSample) {
    // the thread's own byte counts
    if constexpr (kPacked) {
      for (int i = 0; i < nk * kQuad; ++i) wcnt2[i * kThreads + tid] = 0;
    } else {
      for (int i = 0; i < n_cells * kQuad; ++i) wcnt[i * kThreads + tid] = 0;
    }
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
    for (int rr = 0; rr < kSt; ++rr) {
      const int n = n_begin + s * kSt + rr;
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
    for (int i = tid; i < kSt * row_cols; i += kThreads) {
      const int rr = i / row_cols, col = i - rr * row_cols;
      const int n = n_begin + s * kSt + rr;
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
      for (int i = tid; i < kSt * n_nv; i += kThreads) {
        const int rr = i / n_nv, v = i - rr * n_nv;
        const int n = n_begin + s * kSt + rr;
        if (n >= n_end) continue;
        float t = part[buf][rr][0][v];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) t = t + part[buf][rr][w][v];
        a.part[(((long long)c * N + n) * T + tile) * n_nv + v] = t;
      }
    }
  };

  if constexpr (kWide) {
    // P of the block's tile into the pop planes, in the first stage's
    // commit group: the tile's loci of a pop are contiguous in P, so the
    // threads copy consecutive loci (packed: (P0, P1), made (f0, d) below);
    // each thread zeroes its own columns of the pops past nk
    if (n_stages > 0 && stage_p) {
      const int tl0 = tile * kTile, n_tl = min(kTile, L - tl0);
      const float* pc = a.freq + ((long long)c * nk * L + tl0) * A;
      for (int k = 0; k < nk; ++k) {
        const float* src = pc + (long long)k * L * A;
        for (int li = tid; li < n_tl; li += kThreads) {
          const int col = (li & (kQuad - 1)) * kThreads + li / kQuad;
          if constexpr (kPacked) {
            cp_async8(&wp2[k * kPlane + col], src + 2 * li);
          } else {
            for (int al = 0; al < A; ++al)
              cp_async4(&wpa[(k * A + al) * kPlane + col], src + li * A + al);
          }
        }
      }
      for (int k = nk; k < nkr; ++k) {
#pragma unroll
        for (int j = 0; j < kQuad; ++j) {
          const int col = j * kThreads + tid;
          if constexpr (kPacked) {
            wp2[k * kPlane + col] = make_float2(0.0f, 0.0f);
          } else {
            for (int al = 0; al < A; ++al)
              wpa[(k * A + al) * kPlane + col] = 0.0f;
          }
        }
      }
    }
  }
  if (n_stages > 0) stage_rows(0, 0);
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    cp_async_wait_all();
    __syncthreads();
    if constexpr (kWide && kPacked) {
      // d = P1 - P0, as load_freq and the plain version compute it; each
      // thread rewrites its own columns, which only it reads
      if (s == 0 && n_live > 0 && stage_p) {
        for (int k = 0; k < nk; ++k) {
#pragma unroll
          for (int j = 0; j < kQuad; ++j) {
            float2* pp = &wp2[k * kPlane + j * kThreads + tid];
            const float2 v = *pp;
            *pp = make_float2(v.x, v.y - v.x);
          }
        }
      }
    }
    if (s + 1 < n_stages) stage_rows(buf ^ 1, s + 1);
    if (s > 0) write_partials(buf ^ 1, s - 1);
    const int rows = min(kSt, n_rows - s * kSt);
    for (int rr = 0; rr < rows; ++rr) {
      const int n = n_begin + s * kSt + rr;
      const long long cn = (long long)c * N + n;
      const float* qrow = rowc[buf][rr];       // q[nk], then colv
      float qk[KR];
#pragma unroll
      for (int k = 0; k < KR; ++k) qk[k] = need_q ? qrow[k] : 0.0f;
      // the wide body's q, zero past nk (a padded pop weighs 0)
      float qw[KW];
#pragma unroll
      for (int k = 0; k < KW; ++k) qw[k] = 0.0f;
      if constexpr (kWide) {
        if (need_q) {
#pragma unroll
          for (int kc = 0; kc < KW; kc += 4) {
            if (kc >= nk) break;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              qw[kc + i] = kc + i < nk ? qrow[kc + i] : 0.0f;
          }
        }
      }
      float cv0 = 0.0f, cv1 = 0.0f;
      if constexpr (kNeedCol) {
        cv0 = qrow[nk];
        if constexpr (CL::kIn == 2) cv1 = qrow[nk + 1];
      }
      float acc[CL::kAcc > 0 ? CL::kAcc : 1];
#pragma unroll
      for (int i = 0; i < (CL::kAcc > 0 ? CL::kAcc : 1); ++i) acc[i] = 0.0f;
      // copies per pop of the row's sites, 4 bits a pop (8 pops a word;
      // the wide body, 16 pops a 64-bit word)
      uint32_t qqw = 0u;
      uint64_t q64[kQ64];
#pragma unroll
      for (int i = 0; i < kQ64; ++i) q64[i] = 0u;
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
          // the wide body: the site's column of a pop plane, and the
          // allele codes that name a cell (generic; else the site reads
          // nothing and weighs 0: z = 0, p = 0)
          const int col = j * kThreads + tid;
          const bool in0 = kPacked || (g0 >= 0 && g0 < A);
          const bool in1 = kPacked || (g1 >= 0 && g1 < A);
          // generic path: per-pop probability of each copy's allele
          float w0[KR], w1[KR];
          if constexpr (!kPacked && !kWide) {
            copy_probs<K>(a.freq, c, L, A, l0 + j, g0, w0);
            copy_probs<K>(a.freq, c, L, A, l0 + j, g1, w1);
          }
          float tot0 = 0.0f, tot1 = 0.0f;        // Q-mixture probabilities
          if (need_q) {
            if constexpr (kWide) {
              // the prefixes of both copies in runs of kRun pops up to nk
              // rounded to kRun (a padded pop adds +0), as the K <= 8
              // bodies sum them; then the count of those below u * total
              float cum0[KW], cum1[KW];
              if constexpr (kPacked) {
                float ca = 0.0f, cb = 0.0f;
#pragma unroll
                for (int kc = 0; kc < KW; kc += kRun) {
                  if (kc >= nk) break;
#pragma unroll
                  for (int i = 0; i < kRun; ++i) {
                    const int k = kc + i;
                    const float2 p = wp2[k * kPlane + col];
                    if (k == 0) {
                      ca = qw[0] * p.x;
                      cb = qw[0] * p.y;
                    } else {
                      ca = ca + qw[k] * p.x;
                      cb = cb + qw[k] * p.y;
                    }
                    const float ce = ca + cb;
                    cum0[k] = g0 ? ce : ca;
                    cum1[k] = g1 ? ce : ca;
                  }
                }
                const float ce = ca + cb;
                tot0 = g0 ? ce : ca;
                tot1 = g1 ? ce : ca;
              } else {
                const float* pl0 = wpa + (in0 ? g0 : 0) * kPlane + col;
                const float* pl1 = wpa + (in1 ? g1 : 0) * kPlane + col;
                const int ps = A * kPlane;           // a pop's planes
                float c0 = 0.0f, c1 = 0.0f;
#pragma unroll
                for (int kc = 0; kc < KW; kc += kRun) {
                  if (kc >= nk) break;
#pragma unroll
                  for (int i = 0; i < kRun; ++i) {
                    const int k = kc + i;
                    const float v0 = pl0[k * ps], v1 = pl1[k * ps];
                    if (k == 0) {
                      c0 = qw[0] * v0;
                      c1 = qw[0] * v1;
                    } else {
                      c0 = c0 + qw[k] * v0;
                      c1 = c1 + qw[k] * v1;
                    }
                    cum0[k] = c0;
                    cum1[k] = c1;
                  }
                }
                tot0 = in0 ? c0 : 0.0f;
                tot1 = in1 ? c1 : 0.0f;
              }
              if constexpr (kSample) {
                const float ut0 = u0[j] * tot0, ut1 = u1[j] * tot1;
                int zz0 = 0, zz1 = 0;
#pragma unroll
                for (int kc = 0; kc < KW; kc += kRun) {
                  if (kc >= nk) break;
#pragma unroll
                  for (int i = 0; i < kRun; ++i) {
                    zz0 += ut0 > cum0[kc + i] ? 1 : 0;
                    zz1 += ut1 > cum1[kc + i] ? 1 : 0;
                  }
                }
                z0v[j] = in0 ? min(zz0, nk - 1) : 0;
                z1v[j] = in1 ? min(zz1, nk - 1) : 0;
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
              const uint64_t b0 = 1ull << (4 * (z0 & 15));
              const uint64_t b1 = 1ull << (4 * (z1 & 15));
              if constexpr (kQ64 == 1) {
                q64[0] += b0 + b1;
              } else {
                q64[0] += (z0 < 16 ? b0 : 0ull) + (z1 < 16 ? b1 : 0ull);
                q64[1] += (z0 < 16 ? 0ull : b0) + (z1 < 16 ? 0ull : b1);
              }
            } else {
              qqw += (1u << (4 * z0)) + (1u << (4 * z1));
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
            if constexpr (kWide) {
              // the byte counts (z < nk here): packed, 1 to the pop's low
              // byte and the allele bit to its high byte; generic, 1 to the
              // (pop, allele) cell of a code in [0, A)
              if constexpr (kPacked) {
                const int v0 = 1 + (g0 << 8), v1 = 1 + (g1 << 8);
                if (z0 == z1) {
                  wcnt2[z0 * kPlane + col] += (uint16_t)(v0 + v1);
                } else {
                  wcnt2[z0 * kPlane + col] += (uint16_t)v0;
                  wcnt2[z1 * kPlane + col] += (uint16_t)v1;
                }
              } else {
                if (in0) wcnt[(z0 * A + g0) * kPlane + col] += 1;
                if (in1) wcnt[(z1 * A + g1) * kPlane + col] += 1;
              }
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
              // from the staged P (a carried z outside [0, nk) reads pop
              // 0, as sel does)
              const int y0 = z0 < nk ? z0 : 0, y1 = z1 < nk ? z1 : 0;
              const float* pl =
                  a.freq + ((long long)c * nk * L + l0 + j) * A;
              const long long ps = (long long)L * A;   // P's pop stride
              if (kPacked && stage_p) {
                const float2 v0 = wp2[y0 * kPlane + col];
                const float2 v1 = wp2[y1 * kPlane + col];
                p0 = g0 ? v0.x + v0.y : v0.x;
                p1 = g1 ? v1.x + v1.y : v1.x;
              } else if (kPacked) {
                const float2 v0 = __ldg(reinterpret_cast<const float2*>(
                    pl + y0 * ps));
                const float2 v1 = __ldg(reinterpret_cast<const float2*>(
                    pl + y1 * ps));
                p0 = g0 ? v0.x + (v0.y - v0.x) : v0.x;
                p1 = g1 ? v1.x + (v1.y - v1.x) : v1.x;
              } else if (stage_p) {
                p0 = in0 ? wpa[(y0 * A + g0) * kPlane + col] : 0.0f;
                p1 = in1 ? wpa[(y1 * A + g1) * kPlane + col] : 0.0f;
              } else {
                p0 = in0 ? __ldg(pl + y0 * ps + g0) : 0.0f;
                p1 = in1 ? __ldg(pl + y1 * ps + g1) : 0.0f;
              }
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
                    for (int k = 0; k < CL::kAcc; ++k) {
                      if (kWide && k >= nk) break;
                      if (z0 == k) acc[k] = acc[k] + dl;
                    }
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
          uint32_t word = qqw;
          if constexpr (kWide)
            word = (uint32_t)(q64[w >> 3] >> (32 * ((w >> 2) & 1)));
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
  if constexpr (kWide && kSample) {
    // the strip's byte counts into the total (cell k * A + a)
    if (n_live > 0) {
      uint32_t* total = static_cast<uint32_t*>(a.cnt_part) +
                        (long long)c * n_cells * L + l0;
      if constexpr (kPacked) {
        for (int k = 0; k < nk; ++k) {
#pragma unroll
          for (int j = 0; j < kQuad; ++j) {
            const uint32_t v = wcnt2[k * kPlane + j * kThreads + tid];
            const uint32_t ones = v >> 8, zeros = (v & 0xffu) - ones;
            if (j < n_live && zeros != 0u)
              atomicAdd(total + (long long)(2 * k) * L + j, zeros);
            if (j < n_live && ones != 0u)
              atomicAdd(total + (long long)(2 * k + 1) * L + j, ones);
          }
        }
      } else {
        for (int cell = 0; cell < n_cells; ++cell) {
#pragma unroll
          for (int j = 0; j < kQuad; ++j) {
            const uint32_t v = wcnt[cell * kPlane + j * kThreads + tid];
            if (j < n_live && v != 0u)
              atomicAdd(total + (long long)cell * L + j, v);
          }
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
  if constexpr (kTotal) {
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

// Launch one instantiation with its dynamic shared memory (dyn_bytes).
template <int K, int FAM>
int launch_one(const SiteArgs& a, dim3 grid, cudaStream_t s) {
  const size_t dyn = dyn_bytes(K, a.K, a.A, FAM, a.structure != 0);
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

// Whether the site pass runs K pops of A alleles: K <= 8 (generic sampling:
// its count table holds at most kMaxCells cells a locus), or the wide body
// for 8 < K <= 32 with K*A <= kMaxCells.
inline bool runs(int K, int A) {
  if (K < 1 || K > kMaxWide) return false;
  if (K > kNarrow || total_counts(K)) return K * A <= kMaxCells;
  return true;
}

template <int FAM>
int launch_family(int K, const SiteArgs& a, dim3 grid, cudaStream_t s) {
  if (!runs(K, a.A)) return (int)cudaErrorInvalidValue;
#ifdef SITE_K_ONLY
  // one body only (tools/site_pass_variants.py): K itself, or its bucket
  constexpr int kOnly = SITE_K_ONLY;
  if constexpr (kOnly <= kNarrow) {
    if (K == kOnly) return launch_one<kOnly, FAM>(a, grid, s);
  } else {
    if (K > kNarrow && wide_bucket(K) == wide_bucket(kOnly))
      return launch_one<wide_bucket(kOnly), FAM>(a, grid, s);
  }
  return (int)cudaErrorInvalidValue;
#else
#define SITE_CASE(KK) \
  case KK:            \
    return launch_one<KK, FAM>(a, grid, s);
  switch (K) {
    SITE_CASE(1) SITE_CASE(2) SITE_CASE(3) SITE_CASE(4)
    SITE_CASE(5) SITE_CASE(6) SITE_CASE(7) SITE_CASE(8)
    default:
      break;
  }
#undef SITE_CASE
  return K <= 16 ? launch_one<16, FAM>(a, grid, s)
                 : launch_one<32, FAM>(a, grid, s);
#endif
}

}  // namespace

// One launch function per source (SITE_LAUNCH).  `fam` is a kFam* value; the
// operand groups a family does not read may be null.  ll [C, N, n_out], the
// scratch part [C, N, T, qq + acc columns], cnt_part (packed, K <= 8:
// u32 [C, S, K, L]; else u32 [C, K*A, L], zero before the first call) and
// tickets [C*S + C*T] (zero before the first call; every call leaves them
// and the counts' total zero) are sized by the wrapper with
// T = site_pass_tiles(L) and S = site_pass_strips(N) (K <= 8) or the wide
// body's launch plan (kernels/fused_step.py:site_plan; at most
// kWideStripRows rows a strip).
extern "C" int SITE_LAUNCH(
    const void* q, const void* freq, const void* bits2, const void* geno,
    const void* valid, const void* hom, const void* z_in, const void* colv,
    const void* fvals, const void* u, void* z, void* qqnum, void* zcounts,
    void* ll, void* part, void* cnt_part, void* tickets, int C, int N, int L,
    int K, int A, int fam, int structure, int S, long long plane_cs,
    unsigned k0, unsigned k1, const void* chain_key, unsigned step,
    void* stream) {
  if (C == 0 || N == 0 || L == 0) return 0;
  const int max_rows = K > kNarrow ? kWideStripRows : kMaxStripRows;
  if (S < 1 || (N + S - 1) / S > max_rows) return (int)cudaErrorInvalidValue;
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

// Dynamic shared-memory bytes of this source's launch at K pops of A
// alleles in family `fam` (0 where it does not run them): the wrapper's
// launch plan computes the same (kernels/fused_step.py:site_plan).
#define SITE_CAT2(x, y) x##y
#define SITE_CAT(x, y) SITE_CAT2(x, y)
extern "C" int SITE_CAT(SITE_LAUNCH, _dyn_smem)(int K, int A, int fam,
                                                int structure) {
  if (!runs(K, A)) return 0;
  return (int)dyn_bytes(K > kNarrow ? wide_bucket(K) : K, K, A, fam,
                        structure != 0);
}
