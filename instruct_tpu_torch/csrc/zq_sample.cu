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
// What bounds it: operations at small K*A (a quarter of a Philox block and
// ~6K float operations per copy against ~2 bytes), the P gathers beyond.
// Design: the TPU version holds a (128, 1024) block of every plane and all
// K*A frequency rows in VMEM and selects by static loops over (k, a); here
// K, A and the ploidy are run-time arguments, so there is one instantiation
// and no bound on K*A.
//   * A block owns a tile of 1024 loci x a strip of 16 individuals of one
//     chain; a thread owns 4 consecutive loci (one Philox block per copy and
//     row; the byte planes move as 32-bit words).
//   * The strip's q rows sit in shared memory (16 K floats), read as
//     broadcasts.  P is read pop-minor, Pt[l, code, k] (the wrapper hands
//     over that copy of P[k, l, a]): the K values a copy needs are then
//     consecutive, one or two 32-byte sectors, where the [K, L, A] layout
//     costs one sector per pop -- at K*A = 80 the tile's 320 KB of P rows
//     overflow L1 and every gather goes to L2.  They are read through the
//     read-only cache twice per copy (once for the total, once for the
//     prefixes; the second read hits L1): K terms do not fit registers when
//     K is a run-time number.
//   * qqnum is integer-valued, so counting needs no fixed order: per pop a
//     warp adds its lanes' hits with one redux instruction, lane 0 adds them
//     to the strip's shared counters, and the block adds its non-zero
//     counters to qqnum with one float atomicAdd each (exact below 2^24).
//     Two runs from one seed are therefore bitwise equal.
// Uniforms: copy (n, s), s = copy * L + l, takes word n * S + s of the
// (chain, step, STREAM_Z) Philox counter space through the [0, 1) conversion
// -- for a diploid panel exactly the site pass's layout -- or u[c, n, s] when
// uniforms are injected.
#include "quad.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads * kQuad;   // loci per block
constexpr int kRows = 16;                 // individuals per block
constexpr int kMaxPloid = 4;
constexpr int kMaxPops = 127;             // z is int8

struct ZqArgs {
  const float* q;          // [C, N, K]
  const float* freq_t;     // [C, L, A, K]: P[k, l, a] with the pop axis last
  const int8_t* geno;      // [N, S] allele codes, copy-major, S = P * L, or
  //                          one such plane per chain (the tetraploid latent
  //                          genotype), chain stride geno_cs
  const int8_t* valid;     // [N, L] bool
  const float* u;          // [C, N, S] injected uniforms, or null
  int8_t* z;               // [C, N, S] out
  float* qqnum;            // [C, N, K] out, zeroed by the launch function
  int N, L, K, A, P;
  long long geno_cs;
  uint32_t k0, k1, step;
  const int* chain_key;
};

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
  const float* freq_c = a.freq_t + (long long)c * L * A * K;
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
      for (int p = 0; p < kMaxPloid; ++p)
#pragma unroll
        for (int j = 0; j < kQuad; ++j) m += zc[p][j] == k ? 1 : 0;
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

}  // namespace

extern "C" int zq_sample_launch(const void* q, const void* freq_t,
                                const void* geno, const void* valid,
                                const void* u, void* z, void* qqnum, int C,
                                int N, int L, int K, int A, int P,
                                long long geno_cs, unsigned k0, unsigned k1,
                                const void* chain_key, unsigned step,
                                void* stream) {
  if (K < 1 || K > kMaxPops || A < 1 || P < 1 || P > kMaxPloid)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(qqnum, 0, sizeof(float) * (size_t)C * N * K, s);
  if (C == 0 || N == 0 || L == 0) return (int)cudaGetLastError();
  ZqArgs a;
  a.q = (const float*)q;
  a.freq_t = (const float*)freq_t;
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
  a.geno_cs = geno_cs;
  a.k0 = k0;
  a.k1 = k1;
  a.step = step;
  a.chain_key = (const int*)chain_key;
  const dim3 grid((L + kTile - 1) / kTile, (N + kRows - 1) / kRows, C);
  const size_t shared = sizeof(float) * 2 * kRows * K;
  zq_sample_kernel<<<grid, kThreads, shared, s>>>(a);
  return (int)cudaGetLastError();
}
