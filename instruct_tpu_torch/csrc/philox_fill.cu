// Raw Philox4x32-10 words for every chain: out[c, s, b, :] is the output
// block of counter (b, stream0 + s, step, chain_key[c]).  It serves the draws
// that no sampling kernel makes itself -- the alpha MH step's normal and
// uniform, and the S/F random-walk proposals, MH accept uniforms and G
// proposal of the modes whose tail is plain tensor code (several consecutive
// streams in one launch) -- and holds the CUDA generator (philox.cuh) bit for
// bit against the plain PyTorch one (instruct_tpu_torch/kernels/philox.py).
// It replaces the key handling of the TPU kernels
// (instruct_tpu/kernels/fused_step.py: seed_words + pltpu.prng_seed /
// prng_random_bits).  Bound by the launch: a few words per chain, or per
// individual, on the sampler's path.
#include "philox.cuh"

__global__ void philox_fill_kernel(uint32_t* out, int n_chains,
                                   int n_streams, long long n_blocks,
                                   uint32_t k0, uint32_t k1, uint32_t stream0,
                                   uint32_t step,
                                   const int* __restrict__ chain_key) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_blocks * n_streams * n_chains) return;
  const long long cs = i / n_blocks;            // chain * n_streams + s
  const long long b = i - cs * n_blocks;
  const int c = (int)(cs / n_streams);
  const uint32_t s = (uint32_t)(cs - (long long)c * n_streams);
  const Philox4 r = philox4x32_10((uint32_t)b, stream0 + s, step,
                                  (uint32_t)chain_key[c], k0, k1);
  reinterpret_cast<uint4*>(out)[i] = make_uint4(r.x, r.y, r.z, r.w);
}

extern "C" int philox_fill_launch(void* out, int n_chains, int n_streams,
                                  long long n_blocks, unsigned k0,
                                  unsigned k1, unsigned stream0,
                                  unsigned step, const void* chain_key,
                                  void* stream) {
  const long long total = n_blocks * n_streams * n_chains;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  philox_fill_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, n_chains, n_streams, n_blocks, k0, k1, stream0, step,
      (const int*)chain_key);
  return (int)cudaGetLastError();
}
