// The Z-Gibbs draw of the unfused sweep: per allele copy
// z ~ Cat_k(q[n, k] * P[k, l, a]) by inverse CDF, and qqnum[n, k] = the valid
// copies of individual n drawn to pop k -- for any number of pops K, any
// number of alleles A and any ploidy (1..4 copies per locus).
//
// Replaces the TPU kernel zq_sample_counts / _kernel of
// instruct_tpu/kernels/zq_pallas.py.  The same function of the uniforms, in
// the same order of float operations: terms[k] = q[n, k] * w_k with
// w_k = P[k, l, code] and 0 for a code outside [0, A) (a missing copy: the
// total is 0 and z = 0); total = terms summed for k = 0..K-1; ut = u01 * total;
// z = #{k < K-1 : ut > cum_k}.  z is written for every site, counted only
// where the site is valid.  The source is compiled without FMA contraction,
// so the prefixes round as in the plain PyTorch version and both give the
// same z everywhere.  For K <= 8 this is also what the generic path of the
// site pass (site_pass.cuh) draws from the same keys.
//
// What bounds it: operations (a quarter of a Philox block and ~5K float
// operations per copy against ~2 bytes).  The first body gathered each
// copy's K values of P through the read-only cache twice, from rows spread
// 4 * A * K floats apart between the lanes of a warp: every gather touched
// 32 sectors, so L1 and not the arithmetic set its pace.
// Design: the TPU version holds a (128, 1024) block of every plane and all
// K*A frequency rows in VMEM and selects by static loops over (k, a); here:
//   * Pop buckets (zq_bucket_kernel<KB>): one body per K <= 8 and two padded
//     ones, K <= 16 and K <= 32.  A block owns a tile of 128 loci (32 quads)
//     x a strip of rows of one chain and stages the tile's P once, read
//     coalesced as the wrapper hands it over ([C, K, L, A], no transposed
//     copy), into shared memory laid out [k][j][quad][A | 1]: a lane reads
//     its quad's column, so the lanes of a warp hit 32 distinct banks
//     whatever their allele codes.  Each warp draws its own rows of the
//     strip, 4 consecutive loci a lane (one Philox block per copy); the
//     strip's q sits in shared memory, a row's q and a copy's K terms in
//     registers, so P is read once a copy.  A
//     pop past K adds +0 to the total and to every prefix and is never drawn
//     (u * total <= total); an injected u >= 1 is clamped to pop K - 1, as
//     the plain version's count stops there.  The launch plan
//     (the strip's rows) is kernels/zq.py:zq_plan; zq_sample_launch_dyn_smem
//     gives the shared memory that the plan predicts.
//   * The generic body (zq_sample_kernel, K > 32 or a tile of P beyond
//     shared memory): 1024 loci x 16 rows a block, P read pop-minor,
//     Pt[l, code, k] (a transposed copy from the wrapper), twice a copy
//     through the read-only cache.
//   * qqnum is integer-valued, so counting needs no fixed order.  Buckets:
//     a lane keeps its row's counts in 8-bit fields, 4 pops a word (at most
//     16 copies a lane and row), splits them into 16-bit fields and the warp
//     adds each word with one redux; lane k adds pop k's count to the
//     strip's shared counters.  Generic body: per pop a warp adds its lanes'
//     hits with one redux.  Both count only the panel's copies (1..4), and
//     the block adds its non-zero counters to qqnum with one float atomicAdd
//     each (exact below 2^24).  Two runs from one seed are bitwise equal.
// Uniforms: copy (n, s), s = copy * L + l, takes word n * S + s of the
// (chain, step, STREAM_Z) Philox counter space through the [0, 1) conversion
// -- for a diploid panel exactly the site pass's layout -- or u[c, n, s] when
// uniforms are injected.
#include "quad.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kQuad;   // loci per block (generic body)
constexpr int kRows = 16;                 // individuals per block (generic)
constexpr int kMaxPloid = 4;
constexpr int kMaxPops = 127;             // z is int8
constexpr int kMaxAlleles = 127;          // allele codes are int8
constexpr int kWarpLoci = 32 * kQuad;     // loci of one warp's row (bucket)
constexpr int kMaxSmem = 232448;          // a block's shared memory (H100)

struct ZqArgs {
  const float* q;          // [C, N, K]
  const float* freq;       // buckets: [C, K, L, A]; generic: [C, L, A, K]
  const int8_t* geno;      // [N, S] allele codes, copy-major, S = P * L, or
  //                          one such plane per chain (the tetraploid latent
  //                          genotype), chain stride geno_cs
  const int8_t* valid;     // [N, L] bool
  const float* u;          // [C, N, S] injected uniforms, or null
  int8_t* z;               // [C, N, S] out
  float* qqnum;            // [C, N, K] out, zeroed by the launch function
  int N, L, K, A, P;
  int rows;                // buckets: rows of a block
  long long geno_cs;
  uint32_t k0, k1, step;
  const int* chain_key;
};

// The pop bucket of K (0: the generic body).
__host__ __device__ constexpr int zq_bucket(int K) {
  return K <= 8 ? K : (K <= 16 ? 16 : (K <= 32 ? 32 : 0));
}

// Shared-memory bytes of a bucket block: the tile's P, [K][4][32][A | 1]
// floats, and the strip's q rows and counters, [rows][K] each.
__host__ __device__ inline long long bucket_smem(int K, int A, int rows) {
  return 4LL * ((long long)K * kWarpLoci * (A | 1) + 2LL * rows * K);
}

// Blocks an SM that a bucket body is held to (its registers): 4 for the
// bodies of K <= 8, 2 for the padded buckets.
#ifndef ZQ_MIN_BLOCKS
#define ZQ_MIN_BLOCKS 4
#endif

template <int KB>
__global__ void __launch_bounds__(kThreads, KB <= 8 ? ZQ_MIN_BLOCKS : 2)
    zq_bucket_kernel(const ZqArgs a) {
  extern __shared__ float smem[];
  const int N = a.N, L = a.L, K = a.K, A = a.A, P = a.P;
  constexpr int T = kWarpLoci, QT = 32;             // loci, quads a tile
  const int As = A | 1;
  const long long S = (long long)P * L;
  const int kstride = kQuad * QT * As;              // floats per staged pop
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.z, l_begin = blockIdx.x * T;
  const int n_begin = blockIdx.y * a.rows;
  const int n_rows = min(a.rows, N - n_begin);
  float* ps = smem;                                 // [K][4][QT][As]
  float* qs = smem + K * kstride;                   // [rows][K]
  int* cnt = reinterpret_cast<int*>(qs + a.rows * K);   // [rows][K]

  // stage the tile's P, read coalesced: pop k's tile is T * A consecutive
  // floats of freq; locus l = 4 quad + j goes to column quad of plane j
  const float* fc = a.freq + ((long long)c * K * L + l_begin) * A;
  const int span = min(T, L - l_begin) * A;         // floats of a pop's tile
  for (int k = 0; k < K; ++k) {
    const float* src = fc + (long long)k * L * A;
    float* dst = ps + k * kstride;
#pragma unroll 4
    for (int e = tid; e < span; e += kThreads) {
      const int l = e / A, al = e - l * A;
      dst[((l & 3) * QT + (l >> 2)) * As + al] = __ldg(src + e);
    }
  }
  const long long strip = ((long long)c * N + n_begin) * K;
  for (int i = tid; i < n_rows * K; i += kThreads) {
    qs[i] = a.q[strip + i];
    cnt[i] = 0;
  }
  __syncthreads();

  const int qi = lane;
  const int l0 = l_begin + kQuad * qi;
  const int n_live = min(kQuad, L - l0);            // <= 0: no locus
  const bool vec = (L % 4) == 0;
  const uint32_t chain = (uint32_t)a.chain_key[c];
  const float* inj = a.u == nullptr ? nullptr : a.u + (long long)c * N * S;
  constexpr int kWords = (KB + 3) / 4;              // 8-bit count fields
  constexpr bool kExact = KB <= 8;                  // a body of K itself

  for (int r = warp; r < n_rows; r += kWarps) {
    const int n = n_begin + r;
    const long long cn = (long long)c * N + n;
    uint32_t cw[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) cw[w] = 0u;

    if (n_live > 0) {
      float qk[KB];
#pragma unroll
      for (int k = 0; k < KB; ++k)
        qk[k] = kExact || k < K ? qs[r * K + k] : 0.0f;
      int okv[kQuad];
      load_bytes(a.valid + (long long)n * L, l0, L, vec, okv);
#pragma unroll
      for (int p = 0; p < kMaxPloid; ++p) {
        if (p >= P) break;
        const long long row = (long long)n * S + (long long)p * L;
        int gv[kQuad], zv[kQuad];
        float uq[kQuad];
        load_bytes(a.geno + c * a.geno_cs + row, l0, L, vec, gv);
        quad_uniforms(inj, row + l0, n_live, a.step, chain, a.k0, a.k1, uq);
#pragma unroll
        for (int j = 0; j < kQuad; ++j) {
          zv[j] = 0;
          const int g = (int)(int8_t)gv[j];    // a negative code is missing
          if (j < n_live && g >= 0 && g < A) {
            const float* pp = ps + (j * QT + qi) * As + g;
            float t[KB];
#pragma unroll
            for (int k = 0; k < KB; ++k)
              t[k] = kExact || k < K ? qk[k] * pp[k * kstride] : 0.0f;
            float total = t[0];
#pragma unroll
            for (int k = 1; k < KB; ++k) total = total + t[k];
            const float ut = uq[j] * total;
            float cum = 0.0f;
            int z = 0;
#pragma unroll
            for (int k = 0; k < KB - 1; ++k) {
              cum = cum + t[k];
              z += ut > cum ? 1 : 0;
            }
            zv[j] = kExact ? z : min(z, K - 1);
          }
          if (j < n_live && okv[j] != 0) {
            const uint32_t inc = 1u << (8 * (zv[j] & 3));
#pragma unroll
            for (int w = 0; w < kWords; ++w)
              cw[w] += (zv[j] >> 2) == w ? inc : 0u;
          }
        }
        store_bytes(a.z + cn * S + (long long)p * L, l0, L, vec, zv);
      }
    }

    // the warp's counts of the row: 16-bit fields, one redux a word; lane k
    // takes pop k (every lane of the warp takes part)
    uint32_t mine = 0u;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint32_t even =
          __reduce_add_sync(0xffffffffu, cw[w] & 0x00ff00ffu);
      const uint32_t odd =
          __reduce_add_sync(0xffffffffu, (cw[w] >> 8) & 0x00ff00ffu);
      if ((lane >> 2) == w) {
        const uint32_t half = (lane & 1) ? odd : even;
        mine = (half >> (16 * ((lane >> 1) & 1))) & 0xffffu;
      }
    }
    if (lane < K && mine != 0u) atomicAdd(&cnt[r * K + lane], (int)mine);
  }
  __syncthreads();

  for (int i = tid; i < n_rows * K; i += kThreads) {
    const int v = cnt[i];
    if (v != 0) atomicAdd(a.qqnum + strip + i, (float)v);
  }
}

__global__ void __launch_bounds__(kThreads) zq_sample_kernel(const ZqArgs a) {
  extern __shared__ float smem[];
  const int N = a.N, L = a.L, K = a.K, A = a.A, P = a.P;
  const long long S = (long long)P * L;
  float* qs = smem;                                       // [kRows][K]
  int* cnt = reinterpret_cast<int*>(smem + kRows * K);    // [kRows][K]
  const int tile = blockIdx.x, c = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_begin = blockIdx.y * kRows;
  const int n_rows = min(kRows, N - n_begin);
  const long long strip = ((long long)c * N + n_begin) * K;
  for (int i = tid; i < n_rows * K; i += kThreads) {
    qs[i] = a.q[strip + i];
    cnt[i] = 0;
  }
  __syncthreads();

  const int l0 = tile * kTile + tid * kQuad;
  const int n_live = min(kQuad, L - l0);       // <= 0: thread has no locus
  const bool vec = (L % 4) == 0;
  const uint32_t chain = (uint32_t)a.chain_key[c];
  const float* freq_c = a.freq + (long long)c * L * A * K;
  const float* inj = a.u == nullptr ? nullptr : a.u + (long long)c * N * S;

  for (int r = 0; r < n_rows; ++r) {
    const int n = n_begin + r;
    const long long cn = (long long)c * N + n;
    const float* qr = qs + r * K;
    // the z of the thread's copies that count towards qqnum; -1 elsewhere
    int zc[kMaxPloid][kQuad];
#pragma unroll
    for (int p = 0; p < kMaxPloid; ++p)
#pragma unroll
      for (int j = 0; j < kQuad; ++j) zc[p][j] = -1;

    if (n_live > 0) {
      int okv[kQuad];
      load_bytes(a.valid + (long long)n * L, l0, L, vec, okv);
#pragma unroll
      for (int p = 0; p < kMaxPloid; ++p) {
        if (p >= P) continue;
        const long long row = (long long)n * S + (long long)p * L;
        int gv[kQuad], zv[kQuad];
        float uq[kQuad];
        load_bytes(a.geno + c * a.geno_cs + row, l0, L, vec, gv);
        quad_uniforms(inj, row + l0, n_live, a.step, chain, a.k0, a.k1, uq);
#pragma unroll
        for (int j = 0; j < kQuad; ++j) {
          zv[j] = 0;
          if (j >= n_live) continue;
          const int g = (int)(int8_t)gv[j];    // a negative code is missing
          if (g >= 0 && g < A) {
            const float* fp = freq_c + ((long long)(l0 + j) * A + g) * K;
            float total = qr[0] * __ldg(fp);
            for (int k = 1; k < K; ++k) total = total + qr[k] * __ldg(fp + k);
            const float ut = uq[j] * total;
            float cum = 0.0f;
            int z = 0;
            for (int k = 0; k < K - 1; ++k) {
              cum = cum + qr[k] * __ldg(fp + k);
              z += ut > cum ? 1 : 0;
            }
            zv[j] = z;
          }
          if (okv[j] != 0) zc[p][j] = zv[j];
        }
        store_bytes(a.z + cn * S + (long long)p * L, l0, L, vec, zv);
      }
    }

    // every thread of the block takes part: the loop bounds are uniform
    for (int k = 0; k < K; ++k) {
      int m = 0;
#pragma unroll
      for (int p = 0; p < kMaxPloid; ++p) {
        if (p >= P) break;
#pragma unroll
        for (int j = 0; j < kQuad; ++j) m += zc[p][j] == k ? 1 : 0;
      }
      m = __reduce_add_sync(0xffffffffu, m);
      if (lane == 0 && m != 0) atomicAdd(&cnt[r * K + k], m);
    }
  }
  __syncthreads();

  for (int i = tid; i < n_rows * K; i += kThreads) {
    const int v = cnt[i];
    if (v != 0) atomicAdd(a.qqnum + strip + i, (float)v);
  }
}

template <int KB>
int launch_bucket(const ZqArgs& a, int C, cudaStream_t s) {
  const long long smem = bucket_smem(a.K, a.A, a.rows);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(zq_bucket_kernel<KB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return (int)cudaGetLastError();
  const dim3 grid((a.L + kWarpLoci - 1) / kWarpLoci,
                  (a.N + a.rows - 1) / a.rows, C);
  zq_bucket_kernel<KB><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared-memory bytes of a launch with this plan (rows 0: the
// generic body); kernels/zq.py:zq_plan predicts the same.
extern "C" int zq_sample_launch_dyn_smem(int K, int A, int rows) {
  if (rows == 0) return (int)(sizeof(float) * 2 * kRows * K);
  return (int)bucket_smem(K, A, rows);
}

// rows: the bucket body's strip (kernels/zq.py:zq_plan), 0 for the generic
// body (freq then pop-minor, [C, L, A, K]).
extern "C" int zq_sample_launch(const void* q, const void* freq,
                                const void* geno, const void* valid,
                                const void* u, void* z, void* qqnum, int C,
                                int N, int L, int K, int A, int P, int rows,
                                long long geno_cs, unsigned k0,
                                unsigned k1, const void* chain_key,
                                unsigned step, void* stream) {
  if (K < 1 || K > kMaxPops || A < 1 || A > kMaxAlleles || P < 1 ||
      P > kMaxPloid || C > 65535)
    return (int)cudaErrorInvalidValue;
  const int bucket = zq_bucket(K);
  if (rows != 0 &&
      (bucket == 0 || rows < 0 || bucket_smem(K, A, rows) > kMaxSmem ||
       (N + rows - 1) / rows > 65535))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 && (N + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(qqnum, 0, sizeof(float) * (size_t)C * N * K, s);
  if (C == 0 || N == 0 || L == 0) return (int)cudaGetLastError();
  ZqArgs a;
  a.q = (const float*)q;
  a.freq = (const float*)freq;
  a.geno = (const int8_t*)geno;
  a.valid = (const int8_t*)valid;
  a.u = (const float*)u;
  a.z = (int8_t*)z;
  a.qqnum = (float*)qqnum;
  a.N = N;
  a.L = L;
  a.K = K;
  a.A = A;
  a.P = P;
  a.rows = rows;
  a.geno_cs = geno_cs;
  a.k0 = k0;
  a.k1 = k1;
  a.step = step;
  a.chain_key = (const int*)chain_key;
  if (rows == 0) {
    const dim3 grid((L + kTile - 1) / kTile, (N + kRows - 1) / kRows, C);
    const size_t shared = sizeof(float) * 2 * kRows * K;
    zq_sample_kernel<<<grid, kThreads, shared, s>>>(a);
    return (int)cudaGetLastError();
  }
  switch (bucket) {
    case 1: return launch_bucket<1>(a, C, s);
    case 2: return launch_bucket<2>(a, C, s);
    case 3: return launch_bucket<3>(a, C, s);
    case 4: return launch_bucket<4>(a, C, s);
    case 5: return launch_bucket<5>(a, C, s);
    case 6: return launch_bucket<6>(a, C, s);
    case 7: return launch_bucket<7>(a, C, s);
    case 8: return launch_bucket<8>(a, C, s);
    case 16: return launch_bucket<16>(a, C, s);
    default: return launch_bucket<32>(a, C, s);
  }
}
