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
// column m * L + l); lookup i32[L, V] (packed code -> class, per locus),
// log_mult f32[L, G]; freq, freq2 f32[C, K, L, A]; the candidate planes sel
// u8, cls i16, mult u8 [n_cand, N, L] and nc u8[N, L] are data-only.
//
// What bounds them: per site a handful of bytes of planes against a few to a
// few dozen float operations (logs included) -- bytes and operations are of
// one order; the table and frequency reads are gathers that stay in L2 (a
// chain's table is 6 MB at L = 5000, G = 100, K = 3).
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
//   * s_delta, site_ll: real-valued sums in a fixed order, no float atomics:
//     each thread adds its loci in order, a warp butterfly, the block's 8
//     warp partials in order; s_delta's per-row partials are then added over
//     the rows in order by a second small kernel.  Two runs are bitwise
//     equal.  An s_delta block keeps the sums of a group of up to 8 pops
//     (grid z: the groups), so any K runs.  A block of either owns one row
//     (chain, individual); its threads walk the row's loci with stride 256,
//     so the byte planes are read coalesced along L.
// The source is compiled without FMA contraction, so the mixtures and the
// weights round as in the plain PyTorch versions (kernels/tetra_geno.py).
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPops = 127;  // z is int8
constexpr int kPopGroup = 8;  // pops per s_delta block
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

// The block's total of one float per thread: warps in order.
__device__ __forceinline__ float block_sum(float v, float* wpart) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) wpart[warp] = v;
  __syncthreads();
  float s = wpart[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s = s + wpart[w];
  return s;
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
// s_delta
// ---------------------------------------------------------------------------

struct SDeltaArgs {
  const float* tab_cur;    // [C, K, L, G]
  const float* tab_prop;   // [C, K, L, G]
  const int* lookup;       // [L, V]
  const int8_t* z;         // [C, N, 4L]
  const int8_t* geno;      // [C, N, 4L]
  const int8_t* valid;     // [N, L] bool
  float* part;             // [C, N, K] per-row partials
  int N, L, K, G, V, n_max;
};

__global__ void __launch_bounds__(kThreads) s_delta_kernel(
    const SDeltaArgs a) {
  const int n = blockIdx.x, c = blockIdx.y, k0 = blockIdx.z * kPopGroup;
  const int N = a.N, L = a.L, K = a.K, G = a.G, nm = a.n_max;
  __shared__ float wpart[kPopGroup][kWarps];
  const long long row = ((long long)c * N + n) * 4 * L;
  const int8_t* zrow = a.z + row;
  const int8_t* grow = a.geno + row;
  const int8_t* vrow = a.valid + (long long)n * L;
  float acc[kPopGroup];
#pragma unroll
  for (int k = 0; k < kPopGroup; ++k) acc[k] = 0.0f;
  for (int l = threadIdx.x; l < L; l += kThreads) {
    if (!vrow[l]) continue;
    const int z0 = zrow[l], rel = z0 - k0;  // rel: the pop within the group
    if ((unsigned)rel >= (unsigned)kPopGroup) continue;
    if (zrow[L + l] != z0 || zrow[2 * L + l] != z0 || zrow[3 * L + l] != z0)
      continue;
    const int packed =
        ((grow[l] * nm + grow[L + l]) * nm + grow[2 * L + l]) * nm +
        grow[3 * L + l];
    const int cls = __ldg(a.lookup + (long long)l * a.V + packed);
    const long long off = (((long long)c * K + z0) * L + l) * G + cls;
    const float d = __ldg(a.tab_prop + off) - __ldg(a.tab_cur + off);
#pragma unroll
    for (int k = 0; k < kPopGroup; ++k) acc[k] = acc[k] + (rel == k ? d : 0.0f);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kn = min(kPopGroup, K - k0);
#pragma unroll
  for (int k = 0; k < kPopGroup; ++k) {
    if (k >= kn) break;
    const float s = warp_sum(acc[k]);
    if (lane == 0) wpart[k][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < kn) {
    const int k = threadIdx.x;
    float s = wpart[k][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = s + wpart[k][w];
    a.part[((long long)c * N + n) * K + k0 + k] = s;
  }
}

// delta[c, k] = the rows' partials added in order.
__global__ void s_delta_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ delta, int C, int N,
                                      int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * K) return;
  const int c = i / K, k = i - c * K;
  float s = 0.0f;
  for (int n = 0; n < N; ++n) s = s + part[((long long)c * N + n) * K + k];
  delta[i] = s;
}

// ---------------------------------------------------------------------------
// site_ll
// ---------------------------------------------------------------------------

struct SiteLlArgs {
  const float* table;      // [C, K, L, G]
  const int* lookup;       // [L, V]
  const float* log_mult;   // [L, G]
  const float* freq;       // [C, K, L, A]
  const float* freq2;      // [C, K, L, A]
  const int8_t* z;         // [C, N, 4L]
  const int8_t* geno;      // [C, N, 4L]
  const int8_t* valid;     // [N, L] bool
  float* ll;               // [C, N] out
  int N, L, K, A, G, V, n_max, autopoly;
};

__global__ void __launch_bounds__(kThreads) site_ll_kernel(
    const SiteLlArgs a) {
  const int n = blockIdx.x, c = blockIdx.y;
  const int N = a.N, L = a.L, K = a.K, A = a.A, G = a.G, nm = a.n_max;
  __shared__ float wpart[kWarps];
  const long long row = ((long long)c * N + n) * 4 * L;
  const int8_t* zrow = a.z + row;
  const int8_t* grow = a.geno + row;
  const int8_t* vrow = a.valid + (long long)n * L;
  const float* f1 = a.freq + (long long)c * K * L * A;
  const float* f2 = a.freq2 + (long long)c * K * L * A;
  float acc = 0.0f;
  for (int l = threadIdx.x; l < L; l += kThreads) {
    if (!vrow[l]) continue;
    int zs[4], gs[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      zs[m] = zrow[m * L + l];
      gs[m] = grow[m * L + l];
    }
    const int packed = ((gs[0] * nm + gs[1]) * nm + gs[2]) * nm + gs[3];
    const int cls = __ldg(a.lookup + (long long)l * a.V + packed);
    float s;
    if (zs[0] == zs[1] && zs[1] == zs[2] && zs[2] == zs[3]) {
      s = __ldg(a.table + (((long long)c * K + zs[0]) * L + l) * G + cls);
    } else {
      s = __ldg(a.log_mult + (long long)l * G + cls);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float* f = (a.autopoly || m < 2) ? f1 : f2;
        s = s + slog(__ldg(f + ((long long)zs[m] * L + l) * A + gs[m]));
      }
    }
    acc = acc + s;
  }
  const float total = block_sum(acc, wpart);
  if (threadIdx.x == 0) a.ll[(long long)c * N + n] = total;
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

extern "C" int s_delta_launch(const void* tab_cur, const void* tab_prop,
                              const void* lookup, const void* z,
                              const void* geno, const void* valid, void* part,
                              void* delta, int C, int N, int L, int K, int G,
                              int V, int n_max, void* stream) {
  if (K < 1 || K > kMaxPops || C > 65535) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (N > 0) {
    SDeltaArgs a;
    a.tab_cur = (const float*)tab_cur;
    a.tab_prop = (const float*)tab_prop;
    a.lookup = (const int*)lookup;
    a.z = (const int8_t*)z;
    a.geno = (const int8_t*)geno;
    a.valid = (const int8_t*)valid;
    a.part = (float*)part;
    a.N = N;
    a.L = L;
    a.K = K;
    a.G = G;
    a.V = V;
    a.n_max = n_max;
    s_delta_kernel<<<dim3(N, C, (K + kPopGroup - 1) / kPopGroup), kThreads, 0,
                     s>>>(a);
  }
  const int threads = 64;
  s_delta_reduce_kernel<<<(C * K + threads - 1) / threads, threads, 0, s>>>(
      (const float*)part, (float*)delta, C, N, K);
  return (int)cudaGetLastError();
}

extern "C" int site_ll_launch(const void* table, const void* lookup,
                              const void* log_mult, const void* freq,
                              const void* freq2, const void* z,
                              const void* geno, const void* valid, void* ll,
                              int C, int N, int L, int K, int A, int G, int V,
                              int n_max, int autopoly, void* stream) {
  if (K < 1 || C > 65535) return (int)cudaErrorInvalidValue;
  if (C == 0 || N == 0) return 0;
  SiteLlArgs a;
  a.table = (const float*)table;
  a.lookup = (const int*)lookup;
  a.log_mult = (const float*)log_mult;
  a.freq = (const float*)freq;
  a.freq2 = (const float*)(freq2 != nullptr ? freq2 : freq);
  a.z = (const int8_t*)z;
  a.geno = (const int8_t*)geno;
  a.valid = (const int8_t*)valid;
  a.ll = (float*)ll;
  a.N = N;
  a.L = L;
  a.K = K;
  a.A = A;
  a.G = G;
  a.V = V;
  a.n_max = n_max;
  a.autopoly = autopoly;
  site_ll_kernel<<<dim3(N, C), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
