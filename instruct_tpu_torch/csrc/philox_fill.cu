// Raw Philox4x32-10 words for every chain: out[c, b, :] is the output block
// of counter (b, stream, step, chain_key[c]).  It serves the draws that no
// sampling kernel makes itself (the alpha MH step's normal and uniform), and
// holds the CUDA generator (philox.cuh) bit for bit against the plain
// PyTorch one (instruct_tpu_torch/kernels/philox.py).  It replaces the key
// handling of the TPU kernels (instruct_tpu/kernels/fused_step.py:
// seed_words + pltpu.prng_seed / prng_random_bits).  Bound by the launch: a
// few words per chain on the sampler's path.
#include "philox.cuh"

__global__ void philox_fill_kernel(uint32_t* out, int n_chains,
                                   long long n_blocks, uint32_t k0,
                                   uint32_t k1, uint32_t stream,
                                   uint32_t step,
                                   const int* __restrict__ chain_key) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_blocks * n_chains) return;
  const int c = (int)(i / n_blocks);
  const long long b = i - (long long)c * n_blocks;
  const Philox4 r = philox4x32_10((uint32_t)b, stream, step,
                                  (uint32_t)chain_key[c], k0, k1);
  reinterpret_cast<uint4*>(out)[i] = make_uint4(r.x, r.y, r.z, r.w);
}

extern "C" int philox_fill_launch(void* out, int n_chains,
                                  long long n_blocks, unsigned k0,
                                  unsigned k1, unsigned stream_id,
                                  unsigned step, const void* chain_key,
                                  void* stream) {
  const long long total = n_blocks * n_chains;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  philox_fill_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, n_chains, n_blocks, k0, k1, stream_id, step,
      (const int*)chain_key);
  return (int)cudaGetLastError();
}
