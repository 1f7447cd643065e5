// Allele-pop counts of the current z: counts[C, K, L, A] of valid allele
// copies per (chain, pop, locus, allele) -- update_P's counting loop.
//
// Replaces the TPU kernel allele_counts / _counts_kernel of
// instruct_tpu/kernels/fused_step.py.
//
// What bounds it: bytes.  Per chain it must read z (2*N*L bytes) and the
// panel (bits2, N*L bytes, when the panel is packed biallelic; otherwise
// geno 2*N*L + site_valid N*L); the output is K*L*A floats.
// The panel planes (bits2 or geno) are shared by the chains, or -- the
// tetraploid engine's latent genotype -- one per chain (chain stride
// plane_cs).
// Design: the TPU grid walks the N blocks in order into a resident output
// block.  Here a thread owns one locus of one chain over a strip of 64
// individuals and counts in a small private table, so loads are coalesced
// along L and the strip costs one atomicAdd per non-empty (pop, allele)
// cell.  The counts are integer-valued floats (<= 2N, far below 2^24), so
// the atomic sum is exact whatever its order.  Beyond K * A = 64 cells (a
// microsatellite panel, or many pops) the table no longer fits a thread: the
// wide kernel walks the same strip and adds each run of equal cells to the
// counts directly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;
constexpr int kMaxCells = 64;   // K * A that the private table holds

__global__ void __launch_bounds__(kThreads) allele_counts_kernel(
    const int8_t* __restrict__ z, const int8_t* __restrict__ bits2,
    const int8_t* __restrict__ geno, const bool* __restrict__ valid,
    float* __restrict__ counts, int N, int L, int K, int A,
    long long plane_cs) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.z;
  if (l >= L) return;
  const int cells = K * A;
  if (bits2 != nullptr) bits2 += c * plane_cs;
  if (geno != nullptr) geno += c * plane_cs;
  int cnt[kMaxCells];
  for (int i = 0; i < cells; ++i) cnt[i] = 0;

  const int n_begin = blockIdx.y * kRows;
  const int n_end = min(N, n_begin + kRows);
  for (int n = n_begin; n < n_end; ++n) {
    int g0, g1;
    bool ok;
    if (bits2 != nullptr) {
      const int b = (int)(uint8_t)bits2[(long long)n * L + l];
      g0 = b & 1;
      g1 = (b >> 1) & 1;
      ok = (b & 4) != 0;
    } else {
      g0 = geno[(long long)n * 2 * L + l];
      g1 = geno[(long long)n * 2 * L + L + l];
      ok = valid[(long long)n * L + l];
    }
    if (!ok) continue;
    const int8_t* zrow = z + ((long long)c * N + n) * 2 * L;
    const int z0 = zrow[l], z1 = zrow[L + l];
    // a value outside the table would be a corrupted state: drop it
    if (z0 >= 0 && z0 < K && g0 >= 0 && g0 < A) cnt[z0 * A + g0] += 1;
    if (z1 >= 0 && z1 < K && g1 >= 0 && g1 < A) cnt[z1 * A + g1] += 1;
  }
  for (int k = 0; k < K; ++k)
    for (int a = 0; a < A; ++a) {
      const int v = cnt[k * A + a];
      if (v != 0)
        atomicAdd(counts + (((long long)c * K + k) * L + l) * A + a,
                  (float)v);
    }
}

// K * A > kMaxCells: no private table; consecutive copies that fall into one
// cell are merged into one atomicAdd.
__global__ void __launch_bounds__(kThreads) allele_counts_wide_kernel(
    const int8_t* __restrict__ z, const int8_t* __restrict__ geno,
    const bool* __restrict__ valid, float* __restrict__ counts, int N, int L,
    int K, int A, long long plane_cs) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.z;
  if (l >= L) return;
  geno += c * plane_cs;
  float* col = counts + (long long)c * K * L * A + (long long)l * A;
  const long long kstride = (long long)L * A;
  long long pending = -1;         // offset of the cell being counted
  int run = 0;
  const int n_begin = blockIdx.y * kRows;
  const int n_end = min(N, n_begin + kRows);
  for (int n = n_begin; n < n_end; ++n) {
    if (!valid[(long long)n * L + l]) continue;
    const int8_t* grow = geno + (long long)n * 2 * L;
    const int8_t* zrow = z + ((long long)c * N + n) * 2 * L;
#pragma unroll
    for (int copy = 0; copy < 2; ++copy) {
      const int g = grow[copy * L + l], zz = zrow[copy * L + l];
      if (zz < 0 || zz >= K || g < 0 || g >= A) continue;
      const long long cell = zz * kstride + g;
      if (cell == pending) {
        run += 1;
        continue;
      }
      if (run != 0) atomicAdd(col + pending, (float)run);
      pending = cell;
      run = 1;
    }
  }
  if (run != 0) atomicAdd(col + pending, (float)run);
}

}  // namespace

extern "C" int allele_counts_launch(const void* z, const void* bits2,
                                    const void* geno, const void* valid,
                                    void* counts, int C, int N, int L, int K,
                                    int A, long long plane_cs,
                                    void* stream) {
  if (K < 1 || A < 1) return (int)cudaErrorInvalidValue;
  // the wide kernel reads the allele codes, not the packed plane (A = 2)
  if (K * A > kMaxCells && geno == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(counts, 0, sizeof(float) * (size_t)C * K * L * A, s);
  if (C == 0 || N == 0 || L == 0) return (int)cudaGetLastError();
  const dim3 grid((L + kThreads - 1) / kThreads, (N + kRows - 1) / kRows, C);
  if (K * A > kMaxCells) {
    allele_counts_wide_kernel<<<grid, kThreads, 0, s>>>(
        (const int8_t*)z, (const int8_t*)geno, (const bool*)valid,
        (float*)counts, N, L, K, A, plane_cs);
  } else {
    allele_counts_kernel<<<grid, kThreads, 0, s>>>(
        (const int8_t*)z, (const int8_t*)bits2, (const int8_t*)geno,
        (const bool*)valid, (float*)counts, N, L, K, A, plane_cs);
  }
  return (int)cudaGetLastError();
}
