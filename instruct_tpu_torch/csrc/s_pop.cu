// The mode-2 S-update tail as one kernel.
//
// Replaces the TPU kernel s_pop_tail / _kernel of
// instruct_tpu/kernels/s_pop_pallas.py: all J*K back-reflection MH
// iterations on the per-pop selfing rates against the cached scalar target
// f(sbar), then the selfing-generation proposal g' ~ Geom(1 - sbar) with
// update_G's boundary overrides, the generation-weight pair 2^(1-g) and the
// log-uniforms of the downstream G accept.
//
// What bounds it: the J*K iterations are sequential (each accept decides the
// state the next one starts from) and each needs one reduction over the N
// individuals, so latency bounds the kernel: J*K + 1 dependent block-wide
// reductions, not bytes (q is 12 kB per chain at N = 1000, K = 3) and not
// operations.  Design, so that only the reduction stays on the serial chain:
//   * one block of 512 threads per chain; thread t owns individuals
//     t, t + 512, ... and keeps their q[i, :], g_i and sbar_i in registers
//     for the whole kernel (up to 8 individuals a thread, N <= 4096; a
//     larger N streams the same state through memory, sbar in a scratch row
//     the thread owns).  The two logs per individual and iteration are the
//     work on the serial chain; 512 threads hide their latency better than
//     256 or 1024 (tools/s_pop_variants.py times the three);
//   * the MH proposal and accept uniforms are drawn before the loop, one
//     Philox block per thread for four consecutive iterations (the counters
//     of the per-iteration draws), into shared memory, with log u_acc
//     already taken -- in chunks of 2048 iterations;
//   * the sum over individuals is taken in ONE fixed order: each thread adds
//     its own individuals in turn, a warp butterfly adds the 32 lanes, and
//     after one barrier every thread adds the 16 warp partials in order (a
//     double-buffered partial row, so one barrier per reduction).  The plain
//     version, block_sum() in instruct_tpu_torch/kernels/s_pop.py, adds in
//     exactly this order, so the knife-edge accept tests see the same floats
//     in both and two runs from one seed are bitwise equal.
// Ragged N is masked (i < N); no 128-lane padding.
#include "philox.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPops = 8;
constexpr int kMaxItems = 8;            // individuals a thread holds in registers
constexpr int kChunk = 4 * kThreads;    // MH iterations drawn at a time
constexpr float kEps = 1e-30f;

struct TailArgs {
  const float* q;          // [C, N, K]
  const int* gen;          // [C, N]
  const float* rates;      // [C, K]
  const float* u_prop;     // [C, J*K] injected, or null
  const float* u_acc;      // [C, J*K] injected, or null
  const float* ug;         // [C, N] injected, or null
  const float* ul;         // [C, N] injected, or null
  float* sbar;             // [C, N] scratch (streamed path only)
  float* out_rates;        // [C, K]
  int* gen_prop;           // [C, N]
  float* wg_pair;          // [C, N, 2]
  float* logu;             // [C, N]
  int N, K, sweeps, gen_cap;
  float delta0;
  uint32_t k0, k1, step;
  const int* chain_key;
};

__device__ __forceinline__ float draw(const float* inj, long long i,
                                      uint32_t stream, uint32_t step,
                                      uint32_t chain, uint32_t k0,
                                      uint32_t k1) {
  if (inj != nullptr) return inj[i];
  const Philox4 r =
      philox4x32_10((uint32_t)(i >> 2), stream, step, chain, k0, k1);
  return u01_open(philox_word(r, (int)(i & 3)));
}

__device__ __forceinline__ float target_term(float sb, float g1) {
  const float a = g1 > 0.0f ? g1 * logf(fmaxf(sb, kEps)) : 0.0f;
  return a + logf(fmaxf(1.0f - sb, kEps));
}

// Sum of one value per thread: a warp butterfly, then the warp partials in
// order; every thread returns the total.  `red` is double-buffered by
// `parity`, so a reduction needs one barrier.
__device__ __forceinline__ float block_sum(float v, float (*red)[kWarps],
                                           int& parity) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[parity][threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[parity][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s = s + red[parity][w];
  parity ^= 1;
  return s;
}

// The proposal uniforms and the log accept uniforms of MH iterations
// [base, base + kChunk): thread t fills iterations base + 4t .. base + 4t + 3
// from one Philox block of each stream (block = iteration / 4, word =
// iteration % 4: the counters of one draw per iteration).
__device__ __forceinline__ void fill_chunk(const TailArgs& a, int c,
                                           uint32_t chain, int base, int nu,
                                           float* s_up, float* s_lu) {
  const int w0 = base + 4 * (int)threadIdx.x;
  if (w0 >= nu) return;
  const float* up = a.u_prop == nullptr ? nullptr
                                        : a.u_prop + (long long)c * nu;
  const float* ua = a.u_acc == nullptr ? nullptr : a.u_acc + (long long)c * nu;
  Philox4 pp{0, 0, 0, 0}, pa{0, 0, 0, 0};
  if (up == nullptr)
    pp = philox4x32_10((uint32_t)(w0 >> 2), STREAM_S_PROP, a.step, chain,
                       a.k0, a.k1);
  if (ua == nullptr)
    pa = philox4x32_10((uint32_t)(w0 >> 2), STREAM_S_ACC, a.step, chain,
                       a.k0, a.k1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int w = w0 + i;
    if (w >= nu) break;
    s_up[w - base] = up != nullptr ? up[w] : u01_open(philox_word(pp, i));
    s_lu[w - base] =
        logf(ua != nullptr ? ua[w] : u01_open(philox_word(pa, i)));
  }
}

// The selfing-generation proposal of individual i at its final sbar `s`
// (g - 1 = `g1`), the generation-weight pair and the G accept's log u.
__device__ __forceinline__ void gen_proposal(const TailArgs& a, int c,
                                             uint32_t chain, int i, float s,
                                             float g1) {
  const float hi = (float)(1.0 - 1e-6);
  const float hi3 = (float)(1.0 - 1e-3);
  const long long o = (long long)c * a.N + i;
  const float* ugc = a.ug == nullptr ? nullptr : a.ug + (long long)c * a.N;
  const float* ulc = a.ul == nullptr ? nullptr : a.ul + (long long)c * a.N;
  const float s_c = fminf(fmaxf(s, 1e-6f), hi);
  const float x =
      logf(draw(ugc, i, STREAM_S_GEN, a.step, chain, a.k0, a.k1)) /
      logf(s_c);
  // clamp in float first: a huge quotient would overflow the int cast
  int g = 1 + (int)fminf(fmaxf(floorf(x), 0.0f), (float)a.gen_cap);
  g = min(max(g, 1), a.gen_cap);
  if (s <= 1e-3f) g = 1;
  if (s >= hi3) g = a.gen_cap;
  a.gen_prop[o] = g;
  a.wg_pair[2 * o] = exp2f(1.0f - (g1 + 1.0f));
  a.wg_pair[2 * o + 1] = exp2f(1.0f - (float)g);
  a.logu[o] = logf(draw(ulc, i, STREAM_S_LOGU, a.step, chain, a.k0, a.k1));
}

// R > 0: each thread's (at most R) individuals live in registers; R == 0:
// any N, the same state read from q / gen and a scratch sbar row.
template <int R>
__global__ void __launch_bounds__(kThreads) s_pop_tail_kernel(
    const TailArgs a) {
  constexpr int RR = R > 0 ? R : 1;
  __shared__ float s_up[kChunk], s_lu[kChunk];
  __shared__ float red[2][kWarps];
  int parity = 0;
  const int c = blockIdx.x, tid = threadIdx.x;
  const int N = a.N, K = a.K;
  const uint32_t chain = (uint32_t)a.chain_key[c];
  const float* qc = a.q + (long long)c * N * K;
  const int* genc = a.gen + (long long)c * N;
  float* sbc = a.sbar == nullptr ? nullptr : a.sbar + (long long)c * N;
  const int items = (N - tid + kThreads - 1) / kThreads;   // may be <= 0
  const int nu = a.sweeps * K;

  float r[kMaxPops];
#pragma unroll
  for (int k = 0; k < kMaxPops; ++k)
    r[k] = k < K ? a.rates[c * K + k] : 0.0f;

  // per-individual state: q row, g - 1 and sbar = sum_k q_k s_k
  float qv[RR][kMaxPops], g1v[RR], sbv[RR];
  float acc = 0.0f;
  if constexpr (R > 0) {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int i = tid + m * kThreads;
#pragma unroll
      for (int k = 0; k < kMaxPops; ++k)
        qv[m][k] = m < items && k < K ? qc[(long long)i * K + k] : 0.0f;
      g1v[m] = m < items ? (float)genc[i] - 1.0f : 0.0f;
      float s = r[0] * qv[m][0];
#pragma unroll
      for (int k = 1; k < kMaxPops; ++k)
        if (k < K) s = s + r[k] * qv[m][k];
      sbv[m] = s;
      if (m < items) acc = acc + target_term(s, g1v[m]);
    }
  } else {
    for (int m = 0; m < items; ++m) {
      const int i = tid + m * kThreads;
      float s = r[0] * qc[(long long)i * K];
      for (int k = 1; k < K; ++k) s = s + r[k] * qc[(long long)i * K + k];
      sbc[i] = s;
      acc = acc + target_term(s, (float)genc[i] - 1.0f);
    }
  }
  fill_chunk(a, c, chain, 0, nu, s_up, s_lu);
  float f_cur = block_sum(acc, red, parity);   // its barrier publishes s_up

  int idx = 0;
  for (int j = 0; j < a.sweeps; ++j) {
#pragma unroll
    for (int kk = 0; kk < kMaxPops; ++kk) {
      if (kk >= K) break;
      if (idx > 0 && idx % kChunk == 0) {       // uniform over the block
        __syncthreads();
        fill_chunk(a, c, chain, idx, nu, s_up, s_lu);
        __syncthreads();
      }
      const float u = s_up[idx % kChunk];
      const float s_old = r[kk];
      const float s_step = fabsf(s_old + (2.0f * u - 1.0f) * a.delta0);
      const float s_new = s_step >= 1.0f ? 2.0f - s_step : s_step;
      const float ds = s_new - s_old;
      acc = 0.0f;
      if constexpr (R > 0) {
#pragma unroll
        for (int m = 0; m < RR; ++m)
          if (m < items)
            acc = acc + target_term(sbv[m] + qv[m][kk] * ds, g1v[m]);
      } else {
        for (int m = 0; m < items; ++m) {
          const int i = tid + m * kThreads;
          acc = acc + target_term(sbc[i] + qc[(long long)i * K + kk] * ds,
                                  (float)genc[i] - 1.0f);
        }
      }
      const float f_new = block_sum(acc, red, parity);
      if (s_lu[idx % kChunk] < f_new - f_cur) {     // uniform over the block
        r[kk] = s_new;
        f_cur = f_new;
        if constexpr (R > 0) {
#pragma unroll
          for (int m = 0; m < RR; ++m) sbv[m] = sbv[m] + qv[m][kk] * ds;
        } else {
          for (int m = 0; m < items; ++m) {
            const int i = tid + m * kThreads;
            sbc[i] = sbc[i] + qc[(long long)i * K + kk] * ds;
          }
        }
      }
      ++idx;
    }
  }

  if constexpr (R > 0) {
#pragma unroll
    for (int m = 0; m < R; ++m)
      if (m < items) gen_proposal(a, c, chain, tid + m * kThreads, sbv[m],
                                  g1v[m]);
  } else {
    for (int m = 0; m < items; ++m) {
      const int i = tid + m * kThreads;
      gen_proposal(a, c, chain, i, sbc[i], (float)genc[i] - 1.0f);
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxPops; ++k)
    if (tid == k && k < K) a.out_rates[c * K + k] = r[k];
}

// The latency floor of the tail: `iters` dependent reductions of N floats
// per chain with the tail's block shape, sum order and register layout, and
// nothing else (each reduction's input depends on the previous total).
template <int R>
__global__ void __launch_bounds__(kThreads) s_pop_floor_kernel(
    const float* __restrict__ x, float* __restrict__ out, int N, int iters) {
  __shared__ float red[2][kWarps];
  int parity = 0;
  const int c = blockIdx.x, tid = threadIdx.x;
  const int items = (N - tid + kThreads - 1) / kThreads;
  float xv[R];
#pragma unroll
  for (int m = 0; m < R; ++m)
    xv[m] = m < items ? x[(long long)c * N + tid + m * kThreads] : 0.0f;
  float total = 0.0f;
  for (int it = 0; it < iters; ++it) {
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < R; ++m)
      if (m < items) acc = acc + (xv[m] + total * 1e-30f);
    total = block_sum(acc, red, parity);
  }
  if (tid == 0) out[c] = total;
}

// Smallest register depth that holds ceil(N / kThreads) individuals; 0 when
// none does.
inline int items_case(int N) {
  const int items = (N + kThreads - 1) / kThreads;
  for (int r = 1; r <= kMaxItems; r *= 2)
    if (items <= r) return r;
  return 0;
}

}  // namespace

extern "C" int s_pop_tail_launch(
    const void* q, const void* gen, const void* rates, const void* u_prop,
    const void* u_acc, const void* ug, const void* ul, void* sbar,
    void* out_rates, void* gen_prop, void* wg_pair, void* logu, int C, int N,
    int K, int sweeps, float delta0, int gen_cap, unsigned k0, unsigned k1,
    const void* chain_key, unsigned step, void* stream) {
  if (C == 0) return 0;
  if (K < 1 || K > kMaxPops) return (int)cudaErrorInvalidValue;
  TailArgs a;
  a.q = (const float*)q;
  a.gen = (const int*)gen;
  a.rates = (const float*)rates;
  a.u_prop = (const float*)u_prop;
  a.u_acc = (const float*)u_acc;
  a.ug = (const float*)ug;
  a.ul = (const float*)ul;
  a.sbar = (float*)sbar;
  a.out_rates = (float*)out_rates;
  a.gen_prop = (int*)gen_prop;
  a.wg_pair = (float*)wg_pair;
  a.logu = (float*)logu;
  a.N = N;
  a.K = K;
  a.sweeps = sweeps;
  a.gen_cap = gen_cap;
  a.delta0 = delta0;
  a.k0 = k0;
  a.k1 = k1;
  a.step = step;
  a.chain_key = (const int*)chain_key;
  cudaStream_t s = (cudaStream_t)stream;
  switch (items_case(N)) {
    case 1: s_pop_tail_kernel<1><<<C, kThreads, 0, s>>>(a); break;
    case 2: s_pop_tail_kernel<2><<<C, kThreads, 0, s>>>(a); break;
    case 4: s_pop_tail_kernel<4><<<C, kThreads, 0, s>>>(a); break;
    case 8: s_pop_tail_kernel<8><<<C, kThreads, 0, s>>>(a); break;
    default: s_pop_tail_kernel<0><<<C, kThreads, 0, s>>>(a); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int s_pop_floor_launch(const void* x, void* out, int C, int N,
                                  int iters, void* stream) {
  if (C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  float* op = (float*)out;
  switch (items_case(N)) {
    case 1: s_pop_floor_kernel<1><<<C, kThreads, 0, s>>>(xp, op, N, iters); break;
    case 2: s_pop_floor_kernel<2><<<C, kThreads, 0, s>>>(xp, op, N, iters); break;
    case 4: s_pop_floor_kernel<4><<<C, kThreads, 0, s>>>(xp, op, N, iters); break;
    case 8: s_pop_floor_kernel<8><<<C, kThreads, 0, s>>>(xp, op, N, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
