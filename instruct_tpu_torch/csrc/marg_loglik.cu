// The Z-marginalized per-individual log-likelihood of the diploid modes 1-5
// (the deviance focus of WAIC and the corrected DIC), in one pass over the
// panel.
//
// Replaces no Pallas kernel: instruct_tpu/model/likelihood.py:213-275
// (marginal_site_loglik) is tensor code that XLA fuses; eager PyTorch runs
// it (model/likelihood.py, the plain version) as ~15 elementwise passes a
// pop over [chains, N, L] float planes, a chain at a time.  Per chain c,
// individual n and valid locus l, with x_0, x_1 the copies' alleles:
//
//   p_k,i = P[c, k, l, x_i],   m_i = sum_k q_k p_k,i
//   same  = sum_k q_k^2 p_k,0 p_k,1
//   joint = sum_k q_k^2 j_k     (j_k the same-pop genotype frequency:
//           modes 2/3  hom p0 p0 + p0 (1 - p0)(1 - w), het 2 p0 p1 w,
//                      w = 2^(1 - gen)
//           modes 4/5  hom p0 p0 (1 - F) + p0 F, het 2 p0 p1 (1 - F),
//                      F of pop k (mode 4) or of the individual (mode 5))
//   prob  = mode 1: (same + (m0 m1 - same)) mult
//           else:   joint + (m0 m1 - same) mult,   mult 1 hom, 2 het
//   out[c, n] = sum over valid l of log(max(prob, 1e-30))
//
// What bounds it.  The bytes are the panel (one byte a site packed, four
// through the allele codes) and P, ~0.3-0.6 GB at the benchmark's panels;
// the operations are ~14 a pop and a logarithm a (chain, individual, locus):
// ~2 ms (RegMap, K = 8) and ~3.8 ms (HGDP, K = 7) at 67 TFLOP/s float32.  So
// the kernel is bound by operations, and its design keeps every one of them
// in registers:
//   * a block takes one chain x a tile of kTile = 512 consecutive loci x a
//     strip of kStrip = 64 individuals; warp w the strip's individuals w, w
//     + 8, ...; a lane the loci lane, lane + 32, ... of the tile, so each
//     panel read of a warp is 32 consecutive bytes of one row;
//   * the tile's P is staged in shared memory as [K][A][kTile] (conflict-free
//     reads, one copy a strip) where K * A <= kStageCells; beyond it is read
//     through the read-only cache;
//   * a row's constants are computed once a row (q_k and q_k^2, w, 1 - w and
//     2w, F, 1 - F and 2 (1 - F)); at K <= 8 the pop loop is unrolled with
//     them in registers (a body a K), beyond it runs to a run-time K;
//   * each row's sum over the tile: a lane's sites in order, then a
//     butterfly over the warp, written to part[c, tile, n]; a second launch
//     sums each row's tiles in tile order in float64.  No atomics, a fixed
//     order: two runs give bitwise the same result.  A float32 sum of 2e5 and
//     more sites in series would lose the accuracy of the plain version's
//     tree sum; the tile partials keep it.
// No [chains, N, L] tensor is written.  Built with -fmad=false like the
// other sources, and the products and sums of a site are taken in the plain
// version's order (2 p0 p1 w as p0 p1 (2w), exact), so a site's value is the
// plain version's; logf is the full-precision logarithm.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;        // loci of a tile (TILE)
constexpr int kLaneSites = kTile / 32;
constexpr int kStrip = 64;        // individuals of a strip (STRIP)
constexpr int kStageCells = 32;   // P staged when K * A <= this (STAGE_CELLS)
constexpr int kMaxA = 127;
constexpr int kMaxGrid = 65535;   // strips and chains: grid dimensions y, z
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100
constexpr float kEps = 1e-30f;

// the likelihood family of a mode (FAMILY in kernels/marg_loglik.py)
constexpr int kMode1 = 1;         // mode 1: independent copies
constexpr int kSelfing = 2;       // modes 2, 3: genofreq under selfing
constexpr int kFPop = 4;          // mode 4: F of each pop
constexpr int kFIndv = 5;         // mode 5: F of each individual

bool staged(int K, int A) { return K * A <= kStageCells; }

int smem_bytes(int K, int A) {
  return staged(K, A) ? 4 * K * A * kTile : 0;
}

// The same-pop genotype frequency j_k of a site (modes 2-5), with the plain
// version's products in its order; `hom` selects, both sides are computed.
template <int FAM>
__device__ __forceinline__ float joint_freq(float p0, float p1, bool hom,
                                            float a, float b, float c) {
  // kSelfing: a = 1 - w, c = 2w; F: a = 1 - F, b = F, c = 2 (1 - F)
  if (FAM == kSelfing)
    return hom ? p0 * p0 + (p0 * (1.0f - p0)) * a : (p0 * p1) * c;
  return hom ? (p0 * p0) * a + p0 * b : (p0 * p1) * c;
}

// The running sums of one site over the pops
struct Site {
  float m0 = 0.0f, m1 = 0.0f, same = 0.0f, joint = 0.0f;
};

// Pop k's terms of a site: its P of both copies (from the staged tile or
// through the read-only cache), then the sums in the plain version's order.
// a, b, c: the same-pop frequency's constants (joint_freq).
template <int FAM, bool STAGE>
__device__ __forceinline__ void add_pop(Site& s, int k, float qk, float qk2,
                                        float a, float b, float c,
                                        const float* p_tile, const float* pc,
                                        int A, int L, int l, int t, int x0,
                                        int x1, bool hom) {
  float p0, p1;
  if (STAGE) {
    p0 = p_tile[(k * A + x0) * kTile + t];
    p1 = p_tile[(k * A + x1) * kTile + t];
  } else {
    p0 = __ldg(pc + ((size_t)k * L + l) * A + x0);
    p1 = __ldg(pc + ((size_t)k * L + l) * A + x1);
  }
  s.m0 = s.m0 + qk * p0;
  s.m1 = s.m1 + qk * p1;
  s.same = s.same + qk2 * (p0 * p1);
  if (FAM != kMode1) s.joint = s.joint + qk2 * joint_freq<FAM>(p0, p1, hom,
                                                               a, b, c);
}

// KC: K when it is known at compile time (1..8; the row's constants in
// registers, the pop loop unrolled), 0 for a run-time K.
template <int KC, int FAM, bool STAGE>
__global__ void __launch_bounds__(kThreads)
marg_loglik_kernel(const float* __restrict__ q, const float* __restrict__ p,
                   const int8_t* __restrict__ bits2,
                   const int8_t* __restrict__ geno,
                   const bool* __restrict__ hom_plane,
                   const bool* __restrict__ valid_plane,
                   const void* __restrict__ gen, int gen_float,
                   const float* __restrict__ rates, float* __restrict__ part,
                   int N, int L, int K, int A) {
  extern __shared__ float p_tile[];   // STAGE: [K][A][kTile]
  constexpr int kRegs = KC > 0 ? KC : 1;
  const int k_pops = KC > 0 ? KC : K;
  const int tile = blockIdx.x, tiles = gridDim.x;
  const int c = blockIdx.z;
  const int l0 = tile * kTile;
  const int span = min(kTile, L - l0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* pc = p + (size_t)c * k_pops * L * A;
  const float* fpop = rates + (size_t)c * k_pops;   // mode 4's F by pop

  if (STAGE) {
    // the tile's P rows P[c, k, l0:l0+span, :] read in global order
    // (coalesced) into [K][A][kTile]
    const int cells = kTile * A;
    for (int i = threadIdx.x; i < k_pops * cells; i += kThreads) {
      const int k = i / cells;
      const int r = i - k * cells;
      const int t = r / A, a = r - t * A;
      p_tile[(k * A + a) * kTile + t] =
          t < span ? __ldg(pc + ((size_t)k * L + l0) * A + r) : 0.0f;
    }
    __syncthreads();
  }

  for (int r = warp; r < kStrip; r += kWarps) {
    const int n = blockIdx.y * kStrip + r;
    if (n >= N) break;
    const size_t row = (size_t)c * N + n;
    const float* qr = q + row * k_pops;

    // the row's constants: selfing a = 1 - w, c = 2w; mode 5 a = 1 - F,
    // b = F, c = 2 (1 - F); mode 4 the same of each pop
    float ra = 0.0f, rb = 0.0f, rc = 0.0f;
    if (FAM == kSelfing) {
      const float g = gen_float ? static_cast<const float*>(gen)[row]
                                : (float)static_cast<const int*>(gen)[row];
      const float w = exp2f(1.0f - g);
      ra = 1.0f - w;
      rc = 2.0f * w;
    } else if (FAM == kFIndv) {
      rb = __ldg(rates + row);
      ra = 1.0f - rb;
      rc = 2.0f * ra;
    }
    float qv[kRegs], qq[kRegs], fa[kRegs], fb[kRegs], fc[kRegs];
    if constexpr (KC > 0) {
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        qv[k] = __ldg(qr + k);
        qq[k] = qv[k] * qv[k];
        fa[k] = ra, fb[k] = rb, fc[k] = rc;
        if (FAM == kFPop) {
          fb[k] = __ldg(fpop + k);
          fa[k] = 1.0f - fb[k];
          fc[k] = 2.0f * fa[k];
        }
      }
    }

    float acc = 0.0f;
#pragma unroll 4
    for (int j = 0; j < kLaneSites; ++j) {
      const int t = lane + 32 * j;
      if (t >= span) break;
      const int l = l0 + t;
      int x0, x1;
      bool hom;
      if (bits2 != nullptr) {
        const int b = bits2[(size_t)n * L + l];
        if (!(b & 4)) continue;
        x0 = b & 1;
        x1 = (b >> 1) & 1;
        hom = x0 == x1;
      } else {
        if (!valid_plane[(size_t)n * L + l]) continue;
        x0 = geno[(size_t)n * 2 * L + l];
        x1 = geno[(size_t)n * 2 * L + L + l];
        hom = hom_plane[(size_t)n * L + l];
      }
      Site s;
      if constexpr (KC > 0) {
#pragma unroll
        for (int k = 0; k < KC; ++k)
          add_pop<FAM, STAGE>(s, k, qv[k], qq[k], fa[k], fb[k], fc[k],
                              p_tile, pc, A, L, l, t, x0, x1, hom);
      } else {
        for (int k = 0; k < k_pops; ++k) {
          const float qk = __ldg(qr + k);
          float a = ra, b = rb, cc = rc;
          if (FAM == kFPop) {
            b = __ldg(fpop + k);
            a = 1.0f - b;
            cc = 2.0f * a;
          }
          add_pop<FAM, STAGE>(s, k, qk, qk * qk, a, b, cc, p_tile, pc, A, L,
                              l, t, x0, x1, hom);
        }
      }
      const float cross = s.m0 * s.m1 - s.same;
      const float mult = hom ? 1.0f : 2.0f;
      float prob = FAM == kMode1 ? (s.same + cross) * mult
                                 : s.joint + cross * mult;
      prob = prob < kEps ? kEps : prob;   // a NaN stays NaN, as in torch
      acc += logf(prob);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) part[((size_t)c * tiles + tile) * N + n] = acc;
  }
}

// out[c, n] = the row's tile partials summed in tile order in float64
__global__ void marg_loglik_sum_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int N,
                                       int tiles, long long rows) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const long long c = i / N, n = i - c * N;
  const float* pr = part + c * tiles * (long long)N + n;
  double s = 0.0;
  for (int t = 0; t < tiles; ++t) s += (double)pr[(size_t)t * N];
  out[i] = (float)s;
}

int check_shapes(int C, int N, int L, int K, int A, int family) {
  if (C < 1 || C > kMaxGrid || N < 1 || L < 1 || K < 1 || A < 2 ||
      A > kMaxA || (N + kStrip - 1) / kStrip > kMaxGrid ||
      smem_bytes(K, A) > kMaxSmem ||
      (family != kMode1 && family != kSelfing && family != kFPop &&
       family != kFIndv))
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

struct Args {
  const float* q;
  const float* p;
  const int8_t* bits2;
  const int8_t* geno;
  const bool* hom;
  const bool* valid;
  const void* gen;
  int gen_float;
  const float* rates;
  float* part;
  int N, L, K, A;
};

template <int KC, int FAM, bool STAGE>
cudaError_t run(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  auto kernel = marg_loglik_kernel<KC, FAM, STAGE>;
  if (cudaError_t e = allow_smem(kernel, smem)) return e;
  kernel<<<grid, kThreads, smem, stream>>>(a.q, a.p, a.bits2, a.geno, a.hom,
                                           a.valid, a.gen, a.gen_float,
                                           a.rates, a.part, a.N, a.L, a.K,
                                           a.A);
  return cudaGetLastError();
}

template <int FAM>
cudaError_t by_pops(const Args& a, dim3 grid, int smem,
                    cudaStream_t stream) {
  if (!staged(a.K, a.A)) return run<0, FAM, false>(a, grid, smem, stream);
  switch (a.K) {
    case 1: return run<1, FAM, true>(a, grid, smem, stream);
    case 2: return run<2, FAM, true>(a, grid, smem, stream);
    case 3: return run<3, FAM, true>(a, grid, smem, stream);
    case 4: return run<4, FAM, true>(a, grid, smem, stream);
    case 5: return run<5, FAM, true>(a, grid, smem, stream);
    case 6: return run<6, FAM, true>(a, grid, smem, stream);
    case 7: return run<7, FAM, true>(a, grid, smem, stream);
    case 8: return run<8, FAM, true>(a, grid, smem, stream);
    default: return run<0, FAM, true>(a, grid, smem, stream);
  }
}

}  // namespace

// The launch plan (kernels/marg_loglik.py:marg_plan): out = (loci a tile,
// individuals a strip, tiles, strips, staged, dynamic shared-memory bytes)
extern "C" int marg_loglik_plan(int C, int N, int L, int K, int A,
                                int* out) {
  if (int rc = check_shapes(C, N, L, K, A, kMode1)) return rc;
  out[0] = kTile;
  out[1] = kStrip;
  out[2] = (L + kTile - 1) / kTile;
  out[3] = (N + kStrip - 1) / kStrip;
  out[4] = staged(K, A) ? 1 : 0;
  out[5] = smem_bytes(K, A);
  return 0;
}

// q f32[C, N, K], p f32[C, K, L, A]; the panel as bits2 int8[N, L] (packed,
// geno/hom/valid unread) or geno int8[N, 2L] with hom and valid bool[N, L]
// (bits2 NULL); gen [C, N] int32 (gen_float 0) or f32 (modes 2/3), rates
// f32[C, K] (mode 4) or [C, N] (mode 5); part f32[C, tiles, N] scratch; out
// f32[C, N].
extern "C" int marg_loglik_launch(const float* q, const float* p,
                                  const int8_t* bits2, const int8_t* geno,
                                  const bool* hom, const bool* valid,
                                  const void* gen, const float* rates,
                                  float* part, float* out, int C, int N,
                                  int L, int K, int A, int family,
                                  int gen_float, cudaStream_t stream) {
  if (int rc = check_shapes(C, N, L, K, A, family)) return rc;
  const int tiles = (L + kTile - 1) / kTile;
  const dim3 grid((unsigned)tiles, (unsigned)((N + kStrip - 1) / kStrip),
                  (unsigned)C);
  const Args a{q, p, bits2, geno, hom, valid, gen, gen_float, rates, part,
               N, L, K, A};
  const int smem = smem_bytes(K, A);
  cudaError_t e;
  switch (family) {
    case kMode1: e = by_pops<kMode1>(a, grid, smem, stream); break;
    case kSelfing: e = by_pops<kSelfing>(a, grid, smem, stream); break;
    case kFPop: e = by_pops<kFPop>(a, grid, smem, stream); break;
    default: e = by_pops<kFIndv>(a, grid, smem, stream); break;
  }
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)C * N;
  marg_loglik_sum_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      part, out, N, tiles, rows);
  return (int)cudaGetLastError();
}
