// The three site passes of the tetraploid engine (instruct_tpu_torch/tetra/
// engine.py), one launch function each:
//
//   geno_choice_launch  the latent-genotype Gibbs move: per site, the weight
//                       of each candidate ordering and a Gumbel-argmax over
//                       them -> the chosen candidate i8[C, N, L].  Replaces
//                       geno_choice_pass / _geno_kernel of
//                       instruct_tpu/kernels/tetra_geno_pallas.py.
//   s_delta_launch      the per-pop MH log-ratio of the S update, the sum
//                       over same-z valid sites with z0 = k of
//                       tab_prop - tab_cur at (z0, l, class(geno)) -> f32[C, K].
//                       Replaces s_delta_pass / _s_delta_kernel.
//   site_ll_launch      the per-individual log-lik (cal_lkd): same-z sites
//                       read the class table, mixed-z sites add the per-slot
//                       log frequencies to the ordering multiplicity
//                       -> f32[C, N].  Replaces site_ll_pass / _site_ll_kernel.
//
// Layouts (chains leading): table, tab_cur, tab_prop f32[C, K, L, G]
// (G-minor: the classes one site reads lie in one row of G floats);
// z, geno i8[C, N, 4L] and dist i8[N, 4L] copy-major (slot m of locus l at
// column m * L + l); lookup i32[L, V] (packed code -> class, per locus) or
// the class map: cls_of u8[L] (the class of each locus) with the class rows
// i32[n_cls, V] that lookup repeats; log_mult f32[L, G]; freq, freq2
// f32[C, K, L, A]; the candidate planes sel u8, cls i16, mult u8
// [n_cand, N, L] and nc u8[N, L] are data-only.
//
// What bounds them: per site a handful of bytes of planes against a few to a
// few dozen float operations (logs included) -- bytes and operations are of
// one order; the table and frequency reads are gathers (a chain's table is
// 6 MB at L = 5000, G = 100, K = 3: the two of s_delta at 4 chains, 48 MB,
// do not stay in the 50 MB L2 beside the streaming planes).
// Design: the TPU kernels run K-way and V-way select chains, because a TPU
// has no fast gather; here every lookup is one indexed load.
//   * geno_choice: its first body took a block per (row, chain): every
//     chain re-read the data-only candidate planes (sel, cls, mult: 4 bytes
//     per candidate and site, 120 MB for allo at 500 x 5000, beyond L2), a
//     mixed-z site took 5 logs per candidate (log mult and 4 slot logs)
//     where it has at most 4 distinct mixtures per system, and a warp ran
//     its candidate loop to the largest count among its 32 sites.  Now a
//     block owns 8 rows x 32 loci and hands its sites to its threads in
//     the order of their candidate counts; the block reads its sites'
//     planes once into shared memory, and a thread walks the C chains of
//     its site.  Per chain and mixed-z site it
//     forms the Q-mixture of each distinct allele that a candidate routes to
//     a system, m_j = sum_k q_k freq[k, l, d_j] (in the order of k), and its
//     log once; a candidate's weight is then logf(mult), from a block table
//     of logf(i), plus its 4 slots' logs in slot order -- the plain
//     version's values and order, so bitwise its weight.  Gumbel noise:
//     u01_open of Philox words of the (chain, step, STREAM_GENO) counter
//     space, word cand of the site's bps = ceil(n_cand / 4) blocks (counter
//     site * bps + cand / 4); only the blocks of the site's valid
//     candidates are drawn.  The first maximum of w + gumbel wins (strict
//     >), in candidate order.
//   * s_delta, site_ll: their first bodies took a block per (row, chain)
//     whose threads walked the row's loci with stride 256, one byte load a
//     plane behind each test: about five dependent round trips a locus
//     (valid, z, the genotype, the class lookup, the table), latency and
//     not bytes.  Now a block owns one chain x a tile of 32 loci x a strip
//     of rows (the plan kernels/tetra_geno.py:sums_plan); a lane takes 4
//     loci of a row, and loads its 9 words (4 z planes, 4 genotype planes,
//     valid) for the next row before it works on the current one.  The
//     same-z and valid tests run on whole words (a byte-wise zero test, no
//     carry across bytes).  The class of a genotype comes from the
//     per-class lookup rows staged in shared memory where the caller gives
//     the class map (the engine does), else from the per-locus rows.  The
//     block stages what its sites read from tables -- s_delta the tile's
//     tab_prop - tab_cur (the same difference of the same floats as at a
//     site), site_ll the tile's class table, log multiplicities and the
//     slog of its frequencies -- where it fits the plan's share of shared
//     memory, and gathers it from device memory otherwise.  Sums run in a
//     fixed order, no float atomics, so two runs are bitwise equal:
//     s_delta adds a thread's sites into the thread's own column of a
//     per-pop table in shared memory, the block's columns in warp and
//     lane order, the blocks' partials of a chain in block order by the
//     last block of the chain behind a ticket; site_ll adds a lane's 4
//     loci in order, the 8 lanes of a row by a butterfly, the tiles'
//     partials of a row in tile order by the last tile block of the strip.
//     A mixed-z site_ll term is log mult + its 4 slot logs in slot order,
//     the same floats as the first body's.  One launch a call; the
//     scratch (partials, tickets) is the wrapper's, kept per shape, and
//     every call leaves the tickets zero.
// The source is compiled without FMA contraction, so the mixtures and the
// weights round as in the plain PyTorch versions (kernels/tetra_geno.py).
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPops = 127;  // z is int8
constexpr int kMaxCand = 12;
constexpr float kEps = 1e-30f;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float slog(float x) { return logf(fmaxf(x, kEps)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float pick4(const float (&v)[4], int j) {
  return j == 0 ? v[0] : (j == 1 ? v[1] : (j == 2 ? v[2] : v[3]));
}

// ---------------------------------------------------------------------------
// geno_choice
// ---------------------------------------------------------------------------

struct GenoArgs {
  const float* table;      // [C, K, L, G] log class frequencies
  const int8_t* z;         // [C, N, 4L]
  const int8_t* dist;      // [N, 4L] distinct alleles, copy-major
  const uint8_t* nc;       // [N, L] valid candidates per site
  const float* q;          // [C, N, K]
  const float* freq;       // [C, K, L, A] system 1 (slots 0-1; all if auto)
  const float* freq2;      // [C, K, L, A] system 2 (slots 2-3, allo)
  const uint8_t* sel;      // [n_cand, N, L] packed 2-bit slot selectors
  const int16_t* cls;      // [n_cand, N, L] class of each candidate
  const uint8_t* mult;     // [n_cand, N, L] ordering multiplicity
  const float* gumbel;     // [C, n_cand, N, L] injected noise, or null
  int8_t* choice;          // [C, N, L] out
  int C, N, L, K, A, G, n_cand, bps;
  uint32_t k0, k1, step;
  const int* chain_key;
};

// A block owns 8 rows x 32 loci.  Its sites are handed to its threads in
// the order of their candidate counts (a counting sort in shared memory), so
// a warp's candidate loop runs about as long as its sites need and not to
// the block's largest count; which thread takes a site changes nothing in
// the site's result.  The block reads its sites' candidate planes once,
// coalesced, into shared memory (one packed word a candidate); a thread
// walks the C chains of its site.  A
// candidate's mixed-z weight log mult + sum_m log mix_sys(m)[sel_m] takes
// its log multiplicity from a block table of logf(i) and its slots' logs
// from the <= 4 per system computed once per site and chain (only for the
// alleles some candidate routes to that system): the same logs of the same
// values, added in slot order -- bitwise the plain version's weight.  kAuto:
// one system (every slot reads freq).  The candidate loop is not unrolled,
// so the body keeps few registers and many warps an SM.
#ifndef GENO_MIN_BLOCKS
#define GENO_MIN_BLOCKS 4
#endif
template <bool kAuto>
__global__ void __launch_bounds__(kThreads, GENO_MIN_BLOCKS)
    geno_choice_kernel(const GenoArgs a) {
  __shared__ float log_int[256];       // logf(i): a u8 multiplicity's log
  __shared__ uint32_t cand_s[kMaxCand][kThreads];  // sel | mult | cls
  __shared__ int bucket[kMaxCand + 2];             // sites by count, starts
  __shared__ uint8_t order[kThreads];              // sites in count order
  const int tid = threadIdx.x;
  log_int[tid] = logf((float)tid);
  if (tid < kMaxCand + 2) bucket[tid] = 0;
  const int N = a.N, L = a.L, K = a.K, G = a.G;
  const long long NL = (long long)N * L, LA = (long long)L * a.A;
  // the block's site `tid`: stage its planes and count it
  {
    const int l = blockIdx.x * 32 + (tid & 31);
    const int n = blockIdx.y * kWarps + (tid >> 5);
    const long long site = (long long)n * L + l;
    const int nc = l < L && n < N ? min((int)a.nc[site], a.n_cand) : 0;
    for (int cc = 0; cc < nc; ++cc) {
      const long long cs = (long long)cc * NL + site;
      cand_s[cc][tid] = a.sel[cs] | ((uint32_t)a.mult[cs] << 8) |
                        ((uint32_t)(uint16_t)a.cls[cs] << 16);
    }
    __syncthreads();
    const int rank = atomicAdd(&bucket[nc + 1], 1);
    __syncthreads();
    if (tid == 0)
      for (int b = 1; b <= kMaxCand + 1; ++b) bucket[b] += bucket[b - 1];
    __syncthreads();
    order[bucket[nc] + rank] = (uint8_t)tid;
    __syncthreads();
  }
  const int me = order[tid];           // the site this thread draws
  const int l = blockIdx.x * 32 + (me & 31);
  const int n = blockIdx.y * kWarps + (me >> 5);
  if (l >= L || n >= N) return;
  const long long site = (long long)n * L + l;
  const int nc = min((int)a.nc[site], a.n_cand);
  uint32_t used1 = 0u, used2 = 0u;     // alleles routed to each system
  for (int cc = 0; cc < nc; ++cc) {
    const uint32_t sel8 = cand_s[cc][me];
    used1 |= (1u << (sel8 & 3)) | (1u << ((sel8 >> 2) & 3));
    used2 |= (1u << ((sel8 >> 4) & 3)) | (1u << ((sel8 >> 6) & 3));
  }
  if (kAuto) used1 |= used2;
  uint32_t dist4 = 0u;                 // the site's distinct alleles, 8 bits
#pragma unroll
  for (int j = 0; j < 4; ++j)
    dist4 |= (uint32_t)(uint8_t)a.dist[(long long)n * 4 * L + j * L + l]
             << (8 * j);

  for (int c = 0; c < a.C; ++c) {
    const long long row = (long long)c * N + n;
    const int8_t* zrow = a.z + row * 4 * L;
    const int z0 = zrow[l], z1 = zrow[L + l], z2 = zrow[2 * L + l],
              z3 = zrow[3 * L + l];
    const bool same = z0 == z1 && z1 == z2 && z2 == z3;
    const float* trow = a.table + (((long long)c * K + z0) * L + l) * G;
    // the mixtures of the used alleles, every (allele, system) of a pop k
    // loaded together; each sum still runs over k in order
    float m1[4] = {0.0f, 0.0f, 0.0f, 0.0f}, m2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (!same) {
      const float* qrow = a.q + row * K;
      const float* f1 = a.freq + (long long)c * K * LA + (long long)l * a.A;
      const float* f2 = a.freq2 + (long long)c * K * LA + (long long)l * a.A;
      for (int k = 0; k < K; ++k) {
        const float qk = __ldg(qrow + k);
        const long long ko = (long long)k * LA;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = (dist4 >> (8 * j)) & 0xffu;
          if ((used1 >> j) & 1u) {
            const float t = qk * __ldg(f1 + ko + d);
            m1[j] = k == 0 ? t : m1[j] + t;
          }
          if (!kAuto && ((used2 >> j) & 1u)) {
            const float t = qk * __ldg(f2 + ko + d);
            m2[j] = k == 0 ? t : m2[j] + t;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((used1 >> j) & 1u) m1[j] = slog(m1[j]);
        if (!kAuto && ((used2 >> j) & 1u)) m2[j] = slog(m2[j]);
      }
    }
    const uint32_t chain = (uint32_t)a.chain_key[c];
    float best = kNeg;
    int choice = 0;
    Philox4 r = {0u, 0u, 0u, 0u};
    // a same-z site's next table weight is loaded a candidate ahead
    float next = same && nc > 0 ? __ldg(trow + (int)(cand_s[0][me] >> 16))
                                : 0.0f;
#pragma unroll 1
    for (int cc = 0; cc < nc; ++cc) {
      const uint32_t v = cand_s[cc][me];
      float w;
      if (same) {
        w = next;
        if (cc + 1 < nc) next = __ldg(trow + (int)(cand_s[cc + 1][me] >> 16));
      } else {
        w = log_int[(v >> 8) & 0xffu];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int j = (v >> (2 * m)) & 3;
          w = w + ((kAuto || m < 2) ? pick4(m1, j) : pick4(m2, j));
        }
      }
      float g;
      if (a.gumbel != nullptr) {
        g = a.gumbel[((long long)c * a.n_cand + cc) * NL + site];
      } else {
        if ((cc & 3) == 0)
          r = philox4x32_10((uint32_t)(site * a.bps + (cc >> 2)),
                            STREAM_GENO, a.step, chain, a.k0, a.k1);
        g = -logf(-logf(u01_open(philox_word(r, cc & 3))));
      }
      const float x = w + g;
      if (x > best) {
        best = x;
        choice = cc;
      }
    }
    a.choice[row * L + l] = (int8_t)choice;
  }
}

// ---------------------------------------------------------------------------
// s_delta and site_ll: the tile skeleton
// ---------------------------------------------------------------------------

// Loci a block (kernels/tetra_geno.py:SUM_TILE; a power of two, 8 to
// 128: tools/tetra_sums_variants.py also builds 16 and 64).
#ifndef SUMS_TILE
#define SUMS_TILE 32
#endif
constexpr int kSumTile = SUMS_TILE;
constexpr int kRowLanes = kSumTile / 4;          // lanes a row (4 loci each)
constexpr int kStepRows = kThreads / kRowLanes;  // rows a block step
// Blocks an SM holds by registers (65536 / (256 * n)): 4, 64 registers, as
// many as the bodies take unspilled (tools/tetra_sums_variants.py: 3 let
// site_ll take 70 and ran 9-18% slower at the auto panel).
#ifndef SUMS_MIN_BLOCKS
#define SUMS_MIN_BLOCKS 4
#endif

struct SumArgs {
  const float* tab;        // K6: tab_cur; K7: table   [C, K, L, G]
  const float* tab_prop;   // K6: tab_prop             [C, K, L, G]
  const int* lut;          // [L, V] per locus, or [n_cls, V] with cls_of
  const uint8_t* cls_of;   // [L] the class row of each locus, or null
  const float* log_mult;   // K7: [L, G]
  const float* freq;       // K7: [C, K, L, A]
  const float* freq2;      // K7: [C, K, L, A]
  const int8_t* z;         // [C, N, 4L]
  const int8_t* geno;      // [C, N, 4L]
  const int8_t* valid;     // [N, L] bool
  float* part;             // K6: [C, B, K] block partials; K7: [C, T, N]
  int* tickets;            // K6: [C]; K7: [C, S] -- zero between calls
  float* out;              // K6: delta [C, K]; K7: ll [C, N]
  int N, L, K, A, G, V, n_max, n_cls;
  int strips, rows, tiles;
  int lut_smem;            // the class rows staged in shared memory
};

// The 4 bytes of a plane row at loci l0..l0+3 as one word (bytes past L are
// 0): one 32-bit load when `vec` (L % 4 == 0: every slot's row starts on a
// word, m * L), else byte loads.
__device__ __forceinline__ uint32_t quad_word(const int8_t* row, int l0,
                                              int L, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(row + l0));
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (l0 + j < L) w |= (uint32_t)(uint8_t)__ldg(row + l0 + j) << (8 * j);
  return w;
}

__device__ __forceinline__ int sbyte(uint32_t w, int j) {
  return (int)(int8_t)(uint8_t)(w >> (8 * j));
}

// 0x80 in each byte of x that is zero (no carry crosses a byte).
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

// A lane's 4 loci of one row: the z and genotype words of the 4 slots and
// the valid word; all zero off the panel (no valid site).
struct SiteWords {
  uint32_t z[4], g[4], v;

  __device__ __forceinline__ void load(const SumArgs& a, int c, int n,
                                       int l0, bool live, bool vec) {
    if (!live) {
#pragma unroll
      for (int m = 0; m < 4; ++m) z[m] = g[m] = 0u;
      v = 0u;
      return;
    }
    const int L = a.L;
    const long long row = ((long long)c * a.N + n) * 4 * L;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      z[m] = quad_word(a.z + row + (long long)m * L, l0, L, vec);
      g[m] = quad_word(a.geno + row + (long long)m * L, l0, L, vec);
    }
    v = quad_word(a.valid + (long long)n * L, l0, L, vec);
  }

  // 0x80 in the bytes of valid sites / of sites whose 4 copies share a pop
  __device__ __forceinline__ uint32_t valid_bytes() const {
    return ~zero_bytes(v) & 0x80808080u;
  }
  __device__ __forceinline__ uint32_t same_bytes() const {
    return zero_bytes((z[0] ^ z[1]) | (z[0] ^ z[2]) | (z[0] ^ z[3]));
  }
  // the base-n_max packed genotype of locus j of the word
  __device__ __forceinline__ int packed(int j, int nm) const {
    return ((sbyte(g[0], j) * nm + sbyte(g[1], j)) * nm + sbyte(g[2], j)) *
               nm + sbyte(g[3], j);
  }
};

// The lookup rows of a lane's 4 loci (ll0.. of the tile, l0.. of the
// panel), as offsets: of the staged class rows, or of a row in device
// memory (the class's row with the class map, else the locus's own).
__device__ __forceinline__ void lookup_rows(const SumArgs& a,
                                            const uint8_t* s_cls, int ll0,
                                            int l0, int (&row)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    row[j] = (a.cls_of != nullptr ? (int)s_cls[ll0 + j] : l0 + j) * a.V;
}

// The class of a packed genotype on lookup row offset `row`.
__device__ __forceinline__ int class_at(const SumArgs& a,
                                        const int16_t* s_lut, int row,
                                        int packed) {
  if (a.lut_smem) return s_lut[row + packed];
  return __ldg(a.lut + (long long)row + packed);
}

// Block-wide staging of one run of n floats: dst[e] = src[e], slog(src[e])
// or src[e] - sub[e]; 16-byte loads where the sources allow (dst is
// 16-byte aligned), four of them in flight a thread.
enum class Run { kCopy, kLog, kDiff };

template <Run kRun>
__device__ __forceinline__ float run_op(float x, float y) {
  return kRun == Run::kCopy ? x : (kRun == Run::kLog ? slog(x) : x - y);
}

template <Run kRun>
__device__ __forceinline__ void stage_run(float* dst, const float* src,
                                          const float* sub, int n) {
  const int tid = threadIdx.x;
  int e0 = 0;
  const uintptr_t al = reinterpret_cast<uintptr_t>(src) |
                       (kRun == Run::kDiff ? reinterpret_cast<uintptr_t>(sub)
                                           : 0);
  if ((al & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const float4* u4 = reinterpret_cast<const float4*>(sub);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int n4 = n >> 2;
#pragma unroll 4
    for (int e = tid; e < n4; e += kThreads) {
      const float4 x = __ldg(s4 + e);
      const float4 y = kRun == Run::kDiff ? __ldg(u4 + e) : x;
      d4[e] = make_float4(run_op<kRun>(x.x, y.x), run_op<kRun>(x.y, y.y),
                          run_op<kRun>(x.z, y.z), run_op<kRun>(x.w, y.w));
    }
    e0 = n4 << 2;
  }
#pragma unroll 4
  for (int e = e0 + tid; e < n; e += kThreads)
    dst[e] = run_op<kRun>(__ldg(src + e),
                          kRun == Run::kDiff ? __ldg(sub + e) : 0.0f);
}

// The block's class map: the tile's class rows of the loci and, where the
// plan stages them, the class lookup rows as int16.
__device__ __forceinline__ void stage_classes(const SumArgs& a,
                                              int16_t* s_lut, uint8_t* s_cls,
                                              int lt0, int lt) {
  const int tid = threadIdx.x;
  if (a.cls_of != nullptr && tid < kSumTile)
    s_cls[tid] = tid < lt ? a.cls_of[lt0 + tid] : (uint8_t)0;
  if (a.lut_smem)
    for (int i = tid; i < a.n_cls * a.V; i += kThreads)
      s_lut[i] = (int16_t)__ldg(a.lut + i);
}

// Bytes of a block's dynamic shared memory: the per-pop thread columns
// (s_delta), the staged tables (stage), the class rows (lut_smem) and the
// tile's class map.
__host__ __device__ inline size_t s_delta_smem(int K, int G, int V, int n_cls,
                                               int stage, int lut_smem) {
  return (size_t)4 * K * kThreads +
         (stage ? (size_t)4 * K * kSumTile * G : 0) +
         (lut_smem ? (size_t)2 * n_cls * V : 0) + kSumTile;
}

__host__ __device__ inline size_t site_ll_smem(int K, int A, int G, int V,
                                               int n_cls, int autopoly,
                                               int stage, int lut_smem) {
  return (stage ? (size_t)4 * ((autopoly ? 1 : 2) * K * kSumTile * A +
                               (size_t)(K + 1) * kSumTile * G)
                : 0) +
         (lut_smem ? (size_t)2 * n_cls * V : 0) + kSumTile;
}

// The last block of a group (its ticket counts the group's blocks) returns
// true, once every other block's partials are visible; it resets the
// ticket for the next call.
__device__ __forceinline__ bool last_of(int* ticket, int blocks) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == blocks - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// ---------------------------------------------------------------------------
// s_delta
// ---------------------------------------------------------------------------

// Grid (strips, tiles, C).  kStage: the tile's tab_prop - tab_cur in shared
// memory, [K][kSumTile][G]; else both tables gathered at each site.
template <bool kStage>
__global__ void __launch_bounds__(kThreads, SUMS_MIN_BLOCKS)
    s_delta_kernel(const SumArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int strip = blockIdx.x, tile = blockIdx.y, c = blockIdx.z;
  const int K = a.K, L = a.L, G = a.G, tid = threadIdx.x;
  float* acc = reinterpret_cast<float*>(smem);       // [K][kThreads]
  float* diff = acc + K * kThreads;
  int16_t* s_lut =
      reinterpret_cast<int16_t*>(diff + (kStage ? K * kSumTile * G : 0));
  uint8_t* s_cls =
      reinterpret_cast<uint8_t*>(s_lut + (a.lut_smem ? a.n_cls * a.V : 0));
  const int lt0 = tile * kSumTile, lt = min(kSumTile, L - lt0);
  const int lane = tid & 31, warp = tid >> 5;
  const int ll0 = (lane & (kRowLanes - 1)) * 4, l0 = lt0 + ll0;
  const bool vec = (L & 3) == 0, on = l0 < L;
  const int n_end = min(a.N, (strip + 1) * a.rows);
  const int nm = a.n_max;
  int n = strip * a.rows + warp * (32 / kRowLanes) + lane / kRowLanes;
  SiteWords cur, nxt;
  // the first row's words are in flight while the block stages
  cur.load(a, c, n, l0, on && n < n_end, vec);
  for (int i = tid; i < K * kThreads; i += kThreads) acc[i] = 0.0f;
  stage_classes(a, s_lut, s_cls, lt0, lt);
  if (kStage) {
    // a pop's cells of the tile are one run of lt * G floats
    for (int k = 0; k < K; ++k) {
      const long long base = (((long long)c * K + k) * L + lt0) * G;
      stage_run<Run::kDiff>(diff + k * kSumTile * G, a.tab_prop + base,
                            a.tab + base, lt * G);
    }
  }
  __syncthreads();
  int row[4];
  lookup_rows(a, s_cls, ll0, l0, row);
  for (; n < n_end; n += kStepRows) {
    if (n + kStepRows < n_end) nxt.load(a, c, n + kStepRows, l0, on, vec);
    const uint32_t m = cur.same_bytes() & cur.valid_bytes();
    if (m != 0u) {
      // the word's sites first, then every table read, then the sums
      int zz[4];
      long long off[4];
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        zz[j] = sbyte(cur.z[0], j);
        ok[j] = ((m >> (8 * j + 7)) & 1u) && (unsigned)zz[j] < (unsigned)K;
        off[j] = 0;
        if (ok[j]) {
          const int cls = class_at(a, s_lut, row[j], cur.packed(j, nm));
          off[j] = kStage
                       ? (long long)(zz[j] * kSumTile + ll0 + j) * G + cls
                       : (((long long)c * K + zz[j]) * L + l0 + j) * G + cls;
        }
      }
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[j] = !ok[j] ? 0.0f
               : kStage ? diff[off[j]]
                        : __ldg(a.tab_prop + off[j]) - __ldg(a.tab + off[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ok[j]) acc[zz[j] * kThreads + tid] += d[j];
    }
    cur = nxt;
  }
  __syncthreads();

  // the block's partial of pop k: its thread columns in warp, lane order
  const int B = a.strips * a.tiles, b = tile * a.strips + strip;
  for (int k = warp; k < K; k += kWarps) {
    float s = acc[k * kThreads + lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = s + acc[k * kThreads + w * 32 + lane];
    s = warp_sum(s);
    if (lane == 0) a.part[((long long)c * B + b) * K + k] = s;
  }
  if (!last_of(a.tickets + c, B)) return;
  // delta[c, k]: the chain's block partials, lane-strided in block order,
  // then a butterfly
  for (int k = warp; k < K; k += kWarps) {
    float s = 0.0f;
    for (int bb = lane; bb < B; bb += 32)
      s = s + __ldcg(a.part + ((long long)c * B + bb) * K + k);
    s = warp_sum(s);
    if (lane == 0) a.out[(long long)c * K + k] = s;
  }
}

// ---------------------------------------------------------------------------
// site_ll
// ---------------------------------------------------------------------------

// slog of slot m's frequency of allele g in pop z at tile locus ll: from the
// block's staged logs, [S][K][kSumTile][A] (system 2: slots 2-3 of allo).
template <bool kAuto>
__device__ __forceinline__ float slot_log(const SumArgs& a, const float* logs,
                                          int m, int z, int ll, int g) {
  const int sys = (kAuto || m < 2) ? 0 : 1;
  return logs[((sys * a.K + z) * kSumTile + ll) * a.A + g];
}

// Grid (strips, tiles, C).  kStage: the tile's class table, log
// multiplicities and slog(freq) (and slog(freq2), allo) in shared memory;
// else gathered and taken at each site.
template <bool kAuto, bool kStage>
__global__ void __launch_bounds__(kThreads, SUMS_MIN_BLOCKS)
    site_ll_kernel(const SumArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int strip = blockIdx.x, tile = blockIdx.y, c = blockIdx.z;
  const int K = a.K, L = a.L, A = a.A, G = a.G, N = a.N, tid = threadIdx.x;
  constexpr int S = kAuto ? 1 : 2;
  float* logs = reinterpret_cast<float*>(smem);      // [S][K][kSumTile][A]
  float* tab_s = logs + (kStage ? S * K * kSumTile * A : 0);  // [K][T][G]
  float* lm_s = tab_s + (kStage ? K * kSumTile * G : 0);      // [T][G]
  int16_t* s_lut =
      reinterpret_cast<int16_t*>(lm_s + (kStage ? kSumTile * G : 0));
  uint8_t* s_cls =
      reinterpret_cast<uint8_t*>(s_lut + (a.lut_smem ? a.n_cls * a.V : 0));
  const int lt0 = tile * kSumTile, lt = min(kSumTile, L - lt0);
  const int lane = tid & 31, warp = tid >> 5;
  const int ll0 = (lane & (kRowLanes - 1)) * 4, l0 = lt0 + ll0;
  const bool vec = (L & 3) == 0, on = l0 < L;
  const int n0 = strip * a.rows, n_end = min(N, n0 + a.rows);
  const int nm = a.n_max;
  const int first = warp * (32 / kRowLanes) + lane / kRowLanes;
  const int steps = (n_end - n0 + kStepRows - 1) / kStepRows;  // uniform
  const float* f1 = a.freq + (long long)c * K * L * A;
  const float* f2 = a.freq2 + (long long)c * K * L * A;
  SiteWords cur, nxt;
  // the first row's words are in flight while the block stages
  cur.load(a, c, n0 + first, l0, on && n0 + first < n_end, vec);
  stage_classes(a, s_lut, s_cls, lt0, lt);
  if (kStage) {
    // the slot logs: a pop's frequencies of the tile are one run of lt * A
    for (int s = 0; s < S; ++s)
      for (int k = 0; k < K; ++k)
        stage_run<Run::kLog>(logs + (s * K + k) * kSumTile * A,
                             (s == 0 ? f1 : f2) + ((long long)k * L + lt0) * A,
                             nullptr, lt * A);
  }
  if (kStage) {
    // the class table and the log multiplicities: runs of lt * G
    for (int k = 0; k < K; ++k)
      stage_run<Run::kCopy>(tab_s + k * kSumTile * G,
                            a.tab + (((long long)c * K + k) * L + lt0) * G,
                            nullptr, lt * G);
    stage_run<Run::kCopy>(lm_s, a.log_mult + (long long)lt0 * G, nullptr,
                          lt * G);
  }
  __syncthreads();
  int row[4];
  lookup_rows(a, s_cls, ll0, l0, row);
  for (int i = 0; i < steps; ++i) {
    const int n = n0 + first + i * kStepRows;
    if (i + 1 < steps)
      nxt.load(a, c, n + kStepRows, l0, on && n + kStepRows < n_end, vec);
    const uint32_t hv = cur.valid_bytes(), same = cur.same_bytes();
    float acc = 0.0f;
    if (hv != 0u) {
      // the word's classes first, then every table read, then the terms
      int cls[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cls[j] = ((hv >> (8 * j + 7)) & 1u)
                     ? class_at(a, s_lut, row[j], cur.packed(j, nm))
                     : 0;
      float base[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool sj = (same >> (8 * j + 7)) & 1u;
        const int z0 = sbyte(cur.z[0], j), l = l0 + j, ll = ll0 + j;
        base[j] = !((hv >> (8 * j + 7)) & 1u) ? 0.0f
                  : sj ? (kStage ? tab_s[(z0 * kSumTile + ll) * G + cls[j]]
                                 : __ldg(a.tab + (((long long)c * K + z0) * L +
                                                  l) * G + cls[j]))
                       : (kStage ? lm_s[ll * G + cls[j]]
                                 : __ldg(a.log_mult + (long long)l * G +
                                         cls[j]));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!((hv >> (8 * j + 7)) & 1u)) continue;
        float s = base[j];
        if (!((same >> (8 * j + 7)) & 1u)) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int zm = sbyte(cur.z[m], j), gm = sbyte(cur.g[m], j);
            if (kStage) {
              s = s + slot_log<kAuto>(a, logs, m, zm, ll0 + j, gm);
            } else {
              const float* f = (kAuto || m < 2) ? f1 : f2;
              s = s + slog(__ldg(f + ((long long)zm * L + l0 + j) * A + gm));
            }
          }
        }
        acc = acc + s;
      }
    }
    // the row's tile partial: its 8 lanes by a butterfly
#pragma unroll
    for (int o = kRowLanes / 2; o >= 1; o >>= 1)
      acc = acc + __shfl_xor_sync(0xffffffffu, acc, o);
    if ((lane & (kRowLanes - 1)) == 0 && n < n_end)
      a.part[((long long)c * a.tiles + tile) * N + n] = acc;
    cur = nxt;
  }
  if (!last_of(a.tickets + (long long)c * a.strips + strip, a.tiles)) return;
  // ll[c, n] of the strip's rows: the tiles' partials in tile order
  for (int n = n0 + tid; n < n_end; n += kThreads) {
    const float* src = a.part + (long long)c * a.tiles * N + n;
    float s = __ldcg(src);
#pragma unroll 8
    for (int t = 1; t < a.tiles; ++t) s = s + __ldcg(src + (long long)t * N);
    a.out[(long long)c * N + n] = s;
  }
}

}  // namespace

// Every launch function returns the cudaGetLastError() code; the wrappers in
// kernels/tetra_geno.py check shapes, types and contiguity first.

extern "C" int geno_choice_launch(
    const void* table, const void* z, const void* dist, const void* nc,
    const void* q, const void* freq, const void* freq2, const void* sel,
    const void* cls, const void* mult, const void* gumbel, void* choice, int C,
    int N, int L, int K, int A, int G, int n_cand, int autopoly, unsigned k0,
    unsigned k1, const void* chain_key, unsigned step, void* stream) {
  if (K < 1 || K > kMaxPops || n_cand < 1 || n_cand > kMaxCand ||
      (N + kWarps - 1) / kWarps > 65535)
    return (int)cudaErrorInvalidValue;
  if (C == 0 || N == 0 || L == 0) return 0;
  GenoArgs a;
  a.table = (const float*)table;
  a.z = (const int8_t*)z;
  a.dist = (const int8_t*)dist;
  a.nc = (const uint8_t*)nc;
  a.q = (const float*)q;
  a.freq = (const float*)freq;
  a.freq2 = (const float*)(freq2 != nullptr ? freq2 : freq);
  a.sel = (const uint8_t*)sel;
  a.cls = (const int16_t*)cls;
  a.mult = (const uint8_t*)mult;
  a.gumbel = (const float*)gumbel;
  a.choice = (int8_t*)choice;
  a.C = C;
  a.N = N;
  a.L = L;
  a.K = K;
  a.A = A;
  a.G = G;
  a.n_cand = n_cand;
  a.bps = (n_cand + 3) / 4;
  a.k0 = k0;
  a.k1 = k1;
  a.step = step;
  a.chain_key = (const int*)chain_key;
  const dim3 grid((L + 31) / 32, (N + kWarps - 1) / kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  if (autopoly)
    geno_choice_kernel<true><<<grid, kThreads, 0, s>>>(a);
  else
    geno_choice_kernel<false><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of an s_delta / site_ll launch with the plan's
// flags (kernels/tetra_geno.py:sums_plan computes the same).
extern "C" int s_delta_launch_dyn_smem(int K, int G, int V, int n_cls,
                                       int stage, int lut_smem) {
  return (int)s_delta_smem(K, G, V, n_cls, stage, lut_smem);
}

extern "C" int site_ll_launch_dyn_smem(int K, int A, int G, int V, int n_cls,
                                       int autopoly, int stage,
                                       int lut_smem) {
  return (int)site_ll_smem(K, A, G, V, n_cls, autopoly, stage, lut_smem);
}

namespace {

// The plan's launch of an s_delta / site_ll body: grid (strips, tiles, C),
// its dynamic shared memory opted in beyond 48 KB.
template <class Kernel>
cudaError_t launch_sums(Kernel kernel, const SumArgs& a, int C, size_t smem,
                        cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(a.strips, a.tiles, C), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// Fills the arguments the two share and checks the plan: every row in a
// strip, every locus in a tile, the grid and the class rows' width.
bool sums_args(SumArgs& a, const void* lut, const void* cls_of,
               const void* z, const void* geno, const void* valid,
               void* part, void* tickets, void* out, int C, int N, int L,
               int K, int G, int V, int n_max, int n_cls, int strips,
               int rows, int lut_smem) {
  a.lut = (const int*)lut;
  a.cls_of = (const uint8_t*)cls_of;
  a.z = (const int8_t*)z;
  a.geno = (const int8_t*)geno;
  a.valid = (const int8_t*)valid;
  a.part = (float*)part;
  a.tickets = (int*)tickets;
  a.out = (float*)out;
  a.N = N;
  a.L = L;
  a.K = K;
  a.G = G;
  a.V = V;
  a.n_max = n_max;
  a.n_cls = n_cls;
  a.strips = strips;
  a.rows = rows;
  a.tiles = (L + kSumTile - 1) / kSumTile;
  a.lut_smem = lut_smem;
  return K >= 1 && K <= kMaxPops && C <= 65535 && a.tiles <= 65535 &&
         strips >= 1 && rows >= 1 && (long long)strips * rows >= N &&
         (long long)(strips - 1) * rows < N &&
         (cls_of != nullptr || !lut_smem) && (!lut_smem || G <= 32767);
}

}  // namespace

// s_delta and site_ll take their launch plan from the wrappers (strips,
// rows, stage, lut_smem: kernels/tetra_geno.py:sums_plan).  lookup is
// lookup_l [L, V], or with cls_of [L] the class rows [n_cls, V]; part and
// tickets are the wrapper's scratch (tickets zero between calls).

extern "C" int s_delta_launch(const void* tab_cur, const void* tab_prop,
                              const void* lookup, const void* cls_of,
                              const void* z, const void* geno,
                              const void* valid, void* part, void* tickets,
                              void* delta, int C, int N, int L, int K, int G,
                              int V, int n_max, int n_cls, int strips,
                              int rows, int stage, int lut_smem,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || K > kMaxPops || C > 65535) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  if (N == 0 || L == 0) {
    cudaMemsetAsync(delta, 0, sizeof(float) * (size_t)C * K, s);
    return (int)cudaGetLastError();
  }
  SumArgs a = {};
  if (!sums_args(a, lookup, cls_of, z, geno, valid, part, tickets, delta, C,
                 N, L, K, G, V, n_max, n_cls, strips, rows, lut_smem))
    return (int)cudaErrorInvalidValue;
  a.tab = (const float*)tab_cur;
  a.tab_prop = (const float*)tab_prop;
  const size_t smem = s_delta_smem(K, G, V, n_cls, stage, lut_smem);
  return (int)(stage ? launch_sums(s_delta_kernel<true>, a, C, smem, s)
                     : launch_sums(s_delta_kernel<false>, a, C, smem, s));
}

extern "C" int site_ll_launch(const void* table, const void* lookup,
                              const void* cls_of, const void* log_mult,
                              const void* freq, const void* freq2,
                              const void* z, const void* geno,
                              const void* valid, void* part, void* tickets,
                              void* ll, int C, int N, int L, int K, int A,
                              int G, int V, int n_max, int n_cls,
                              int autopoly, int strips, int rows, int stage,
                              int lut_smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || K > kMaxPops || C > 65535) return (int)cudaErrorInvalidValue;
  if (C == 0 || N == 0) return 0;
  if (L == 0) {
    cudaMemsetAsync(ll, 0, sizeof(float) * (size_t)C * N, s);
    return (int)cudaGetLastError();
  }
  SumArgs a = {};
  if (!sums_args(a, lookup, cls_of, z, geno, valid, part, tickets, ll, C, N,
                 L, K, G, V, n_max, n_cls, strips, rows, lut_smem))
    return (int)cudaErrorInvalidValue;
  a.tab = (const float*)table;
  a.log_mult = (const float*)log_mult;
  a.freq = (const float*)freq;
  a.freq2 = (const float*)(freq2 != nullptr ? freq2 : freq);
  a.A = A;
  const size_t smem =
      site_ll_smem(K, A, G, V, n_cls, autopoly, stage, lut_smem);
  cudaError_t e;
  if (autopoly)
    e = stage ? launch_sums(site_ll_kernel<true, true>, a, C, smem, s)
              : launch_sums(site_ll_kernel<true, false>, a, C, smem, s);
  else
    e = stage ? launch_sums(site_ll_kernel<false, true>, a, C, smem, s)
              : launch_sums(site_ll_kernel<false, false>, a, C, smem, s);
  return (int)e;
}
