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
// individuals, so latency bounds the kernel: J*K block-wide reductions, not
// bytes (q is 12 kB per chain at N = 1000, K = 3) and not operations.
// Design: one block of 1024 threads per chain, the iterations a loop inside
// the block; sbar lives in a scratch row the block owns.  The sum over
// individuals is taken in ONE fixed order (thread i adds elements i,
// i + 1024, ...; then a halving tree), the order of block_sum() in
// instruct_tpu_torch/kernels/s_pop.py, so the knife-edge accept tests see
// the same floats in both and two runs from one seed are bitwise equal.
// Ragged N is masked (i < N); no 128-lane padding.
#include "philox.cuh"

namespace {

constexpr int kLanes = 1024;
constexpr int kMaxPops = 8;
constexpr float kEps = 1e-30f;

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

// Sum of one value per thread in the fixed halving order; every thread
// returns the total.
__device__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = kLanes / 2; s >= 1; s >>= 1) {
    if (tid < s) red[tid] = red[tid] + red[tid + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kLanes) s_pop_tail_kernel(
    const float* __restrict__ q, const int* __restrict__ gen,
    const float* __restrict__ rates, const float* __restrict__ u_prop,
    const float* __restrict__ u_acc, const float* __restrict__ ug,
    const float* __restrict__ ul, float* __restrict__ sbar,
    float* __restrict__ out_rates, int* __restrict__ gen_prop,
    float* __restrict__ wg_pair, float* __restrict__ logu, int N, int K,
    int sweeps, float delta0, int gen_cap, uint32_t k0, uint32_t k1,
    const int* __restrict__ chain_key, uint32_t step) {
  __shared__ float red[kLanes];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t chain = (uint32_t)chain_key[c];
  const float* qc = q + (long long)c * N * K;
  const int* genc = gen + (long long)c * N;
  float* sb = sbar + (long long)c * N;
  const int nu = sweeps * K;
  const float* up = u_prop == nullptr ? nullptr : u_prop + (long long)c * nu;
  const float* ua = u_acc == nullptr ? nullptr : u_acc + (long long)c * nu;
  const float* ugc = ug == nullptr ? nullptr : ug + (long long)c * N;
  const float* ulc = ul == nullptr ? nullptr : ul + (long long)c * N;

  float r[kMaxPops];
#pragma unroll
  for (int k = 0; k < kMaxPops; ++k) r[k] = k < K ? rates[c * K + k] : 0.0f;

  float acc = 0.0f;
  for (int i = tid; i < N; i += kLanes) {
    float s = r[0] * qc[(long long)i * K];
    for (int k = 1; k < K; ++k) s = s + r[k] * qc[(long long)i * K + k];
    sb[i] = s;
    acc = acc + target_term(s, (float)genc[i] - 1.0f);
  }
  float f_cur = block_sum(acc, red);

  for (int j = 0; j < sweeps; ++j) {
    for (int kk = 0; kk < K; ++kk) {
      const int idx = j * K + kk;
      const float u = draw(up, idx, STREAM_S_PROP, step, chain, k0, k1);
      const float s_old = r[kk];
      const float s_step = fabsf(s_old + (2.0f * u - 1.0f) * delta0);
      const float s_new = s_step >= 1.0f ? 2.0f - s_step : s_step;
      const float ds = s_new - s_old;
      acc = 0.0f;
      for (int i = tid; i < N; i += kLanes) {
        const float s = sb[i] + qc[(long long)i * K + kk] * ds;
        acc = acc + target_term(s, (float)genc[i] - 1.0f);
      }
      const float f_new = block_sum(acc, red);
      const float lu =
          logf(draw(ua, idx, STREAM_S_ACC, step, chain, k0, k1));
      if (lu < f_new - f_cur) {     // uniform over the block
        r[kk] = s_new;
        f_cur = f_new;
        for (int i = tid; i < N; i += kLanes)
          sb[i] = sb[i] + qc[(long long)i * K + kk] * ds;
      }
    }
  }

  const float hi = (float)(1.0 - 1e-6);
  const float hi3 = (float)(1.0 - 1e-3);
  for (int i = tid; i < N; i += kLanes) {
    const float s = sb[i];
    const float s_c = fminf(fmaxf(s, 1e-6f), hi);
    const float x =
        logf(draw(ugc, i, STREAM_S_GEN, step, chain, k0, k1)) / logf(s_c);
    // clamp in float first: a huge quotient would overflow the int cast
    int g = 1 + (int)fminf(fmaxf(floorf(x), 0.0f), (float)gen_cap);
    g = min(max(g, 1), gen_cap);
    if (s <= 1e-3f) g = 1;
    if (s >= hi3) g = gen_cap;
    const long long o = (long long)c * N + i;
    gen_prop[o] = g;
    wg_pair[2 * o] = exp2f(1.0f - (float)genc[i]);
    wg_pair[2 * o + 1] = exp2f(1.0f - (float)g);
    logu[o] = logf(draw(ulc, i, STREAM_S_LOGU, step, chain, k0, k1));
  }
  if (tid < K) out_rates[c * K + tid] = r[tid];
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
  s_pop_tail_kernel<<<C, kLanes, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const int*)gen, (const float*)rates,
      (const float*)u_prop, (const float*)u_acc, (const float*)ug,
      (const float*)ul, (float*)sbar, (float*)out_rates, (int*)gen_prop,
      (float*)wg_pair, (float*)logu, N, K, sweeps, delta0, gen_cap, k0, k1,
      (const int*)chain_key, step);
  return (int)cudaGetLastError();
}
