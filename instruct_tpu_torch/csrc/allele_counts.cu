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
// Design (kernels/fused_step.py:counts_plan is the same plan in Python):
//   * A block of 8 warps owns a tile of 128 loci of one chain over a strip
//     of rows; a lane owns 4 consecutive loci, so every plane of a row moves
//     as one 32-bit word a lane (128 bytes a warp), and the warps take the
//     strip's rows in turn, the next 2-8 rows' words loading while a warp
//     counts the current ones.
//   * The packed plane (A = 2, K <= 32; one instantiation per pop bucket 4,
//     8, 16, 32): the 4 loci of a word are counted at once, in bytes of
//     registers.  Per pop k and copy, one exact byte-equality test of the
//     z word against k, masked by the valid bits, gives 0 or 1 a byte;
//     two registers a pop count the copies with z = k and those of them
//     with allele 1.  A z outside [0, K) matches no pop, so a corrupted
//     state drops out as the plain version drops it.
//   * The allele codes, K * A <= 8: each lane counts its loci's copies in
//     8-bit fields of two registers a locus (4 cells a register, the field
//     picked by unrolled compares: no array indexed at run time).
//   * Both register bodies add their bytes to the block's table in shared
//     memory every 127 rows (2 copies a row: at most 254 a byte) and at the
//     end.
//   * The allele codes, K * A > 8 (the table body): each copy is a
//     shared-memory atomic add to the block's table of a window of pops (as
//     many as 48 KB hold; more windows, more blocks, where K * A is
//     larger).  Register fields of cell buckets 16 to 64 ran slower than
//     this table at K * A = 12 and 24 (tools/dirichlet_counts_variants.py).
//   * The strips of a tile (at most 8) are one thread-block cluster: after
//     a cluster barrier each block sums a slice of the tile's cells over
//     its cluster's tables (distributed shared memory) and stores it, in
//     the counts' memory order.  Every count is stored once: no memset, no
//     global atomic.  The counts are integers (<= 2N, far below 2^24), so
//     the float stores are exact.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQuad = 4;
constexpr int kTile = 32 * kQuad;   // loci a block
constexpr int kMaxCells = 64;       // K * A of the packed body (A = 2)
constexpr int kCodesCells = 8;      // K * A of the codes register body
constexpr int kFieldRows = 127;     // rows a lane counts between flushes
constexpr int kMinRows = 4 * kWarps;   // rows a strip at least
constexpr int kMaxStrips = 8;       // a portable cluster
constexpr size_t kTableSmem = 48 * 1024;
// Strips a tile (see plan): where the chains' tiles would fill at most half
// a wave of resident blocks, as many as fill one; where they fill half a
// wave to two, COUNTS_MID_STRIPS, so that long tiles balance over the SMs;
// beyond, one.  A wave: the H100's SMs times the blocks an SM of the body
// holds (its register cap); twice that for the table body, whose blocks
// wait on their shared atomics (tools/dirichlet_counts_variants.py: 8
// strips ran 9-13% faster than 6 on the wide and A = 8 panels).
#ifndef COUNTS_SMS
#define COUNTS_SMS 132
#endif
#ifndef COUNTS_MID_STRIPS
#define COUNTS_MID_STRIPS 2
#endif
#ifndef COUNTS_TABLE_ROWS
#define COUNTS_TABLE_ROWS 2     // rows a warp loads at once, table body
#endif
// Blocks an SM holds: the register cap of each body (65536 / (256 * n)),
// as many as hold its counters and two batches of row words unspilled.
constexpr int packed_blocks(int kb) { return kb <= 4 ? 4 : (kb <= 8 ? 3 : 2); }
constexpr int kCodesBlocks = 3;
constexpr int kTableBlocks = 3;

struct CountArgs {
  const int8_t* z;
  const int8_t* bits2;
  const int8_t* geno;
  const bool* valid;
  float* counts;
  int C, N, L, K, A;
  long long plane_cs;
  int rows;      // rows a strip
  int kw;        // pops a window (the table body; K for the others)
  int windows;   // pop windows a tile
};

// The 4 bytes of a row at loci l0..l0+3 as one word (bytes past L are 0):
// one 32-bit load when `vec` (L % 4 == 0, so every quad is whole and
// aligned).
__device__ __forceinline__ uint32_t quad_word(const int8_t* row, int l0,
                                              int L, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(row + l0));
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < kQuad; ++j)
    if (l0 + j < L) w |= (uint32_t)(uint8_t)__ldg(row + l0 + j) << (8 * j);
  return w;
}

__device__ __forceinline__ int sbyte(uint32_t w, int j) {
  return (int)(int8_t)(uint8_t)(w >> (8 * j));
}

// The table cell of one copy, or -1: a z or allele code outside the table
// would be a corrupted state and is dropped, as the plain version drops it.
__device__ __forceinline__ int cell_of(bool ok, int z, int g, int K, int A) {
  return ok && (unsigned)z < (unsigned)K && (unsigned)g < (unsigned)A
             ? z * A + g
             : -1;
}

// The words of U rows of a warp (rows n, n + 8, ...; zero past n_end or L,
// which leaves every site invalid): z's two copies and the packed plane
// (p0), or the two allele-code copies (p0, p1) and site_valid (v).
template <int U, bool PACKED>
struct Rows {
  uint32_t z0[U], z1[U], p0[U], p1[U], v[U];

  __device__ __forceinline__ void load(const CountArgs& a, const int8_t* zc,
                                       const int8_t* pl, int n, int n_end,
                                       int l0, bool live, bool vec) {
    const int L = a.L;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int nn = n + u * kWarps;
      z0[u] = z1[u] = p0[u] = p1[u] = v[u] = 0u;
      if (live && nn < n_end) {
        const int8_t* zr = zc + (long long)nn * 2 * L;
        z0[u] = quad_word(zr, l0, L, vec);
        z1[u] = quad_word(zr + L, l0, L, vec);
        if (PACKED) {
          p0[u] = quad_word(pl + (long long)nn * L, l0, L, vec);
        } else {
          const int8_t* gr = pl + (long long)nn * 2 * L;
          p0[u] = quad_word(gr, l0, L, vec);
          p1[u] = quad_word(gr + L, l0, L, vec);
          v[u] = quad_word(
              reinterpret_cast<const int8_t*>(a.valid) + (long long)nn * L,
              l0, L, vec);
        }
      }
    }
  }

  // Site j of row u: valid, allele codes of the two copies.
  __device__ __forceinline__ bool site(int u, int j, int& g0,
                                       int& g1) const {
    if (PACKED) {
      const int b = (int)((p0[u] >> (8 * j)) & 0xffu);
      g0 = b & 1;
      g1 = (b >> 1) & 1;
      return (b & 4) != 0;
    }
    g0 = sbyte(p0[u], j);
    g1 = sbyte(p1[u], j);
    return ((v[u] >> (8 * j)) & 0xffu) != 0u;
  }
};

// One copy into the lane's 8-bit fields of a locus: cell e is byte e & 3
// of register e >> 2.
template <int NR>
__device__ __forceinline__ void add_copy(uint32_t (&f)[NR], int cell) {
  const int ri = cell >> 2;
  const uint32_t inc = 1u << ((cell & 3) << 3);
#pragma unroll
  for (int r = 0; r < NR; ++r) f[r] += ri == r ? inc : 0u;
}

// The shared table: cell e, locus 4 * lane + j at (e * 4 + j) * 32 + lane.
__device__ __forceinline__ int tab_at(int e, int j, int lane) {
  return (e * kQuad + j) * 32 + lane;
}

template <int NR>
__device__ __forceinline__ void flush(uint32_t (&f)[kQuad][NR],
                                      uint32_t* tab, int lane) {
#pragma unroll
  for (int j = 0; j < kQuad; ++j) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const uint32_t w = f[j][r];
      if (w != 0u) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t v = (w >> (8 * b)) & 0xffu;
          if (v != 0u) atomicAdd(tab + tab_at(4 * r + b, j, lane), v);
        }
      }
      f[j][r] = 0u;
    }
  }
}

template <int KB>
__device__ __forceinline__ void flush_packed(uint32_t (&cnt)[KB],
                                             uint32_t (&one)[KB], int K,
                                             uint32_t* tab, int lane) {
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (k < K && cnt[k] != 0u) {
#pragma unroll
      for (int j = 0; j < kQuad; ++j) {
        const uint32_t all = (cnt[k] >> (8 * j)) & 0xffu;
        const uint32_t ones = (one[k] >> (8 * j)) & 0xffu;
        if (all != ones) atomicAdd(tab + tab_at(2 * k, j, lane), all - ones);
        if (ones != 0u) atomicAdd(tab + tab_at(2 * k + 1, j, lane), ones);
      }
    }
    cnt[k] = one[k] = 0u;
  }
}

__device__ __forceinline__ void zero_table(uint32_t* tab, int cells) {
  for (int i = threadIdx.x; i < cells * kTile; i += kThreads) tab[i] = 0u;
  __syncthreads();
}

// The tile's counts (pops k0..k0+kw of its loci): block y of the cluster
// of the tile's strips sums its slice of the table's cells over the
// cluster's tables, in table order (consecutive threads, consecutive banks
// of every table), and stores them.
__device__ void write_counts(const CountArgs& a, uint32_t* tab, int c,
                             int tile, int k0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int strips = gridDim.y, rank = blockIdx.y;
  cluster.sync();                          // every strip's table is whole
  const int total = min(a.kw, a.K - k0) * a.A * kTile;
  const int share = (total + strips - 1) / strips;
  const int end = min(total, (rank + 1) * share);
  const int lt = min(kTile, a.L - tile * kTile);
  float* base =
      a.counts + (((long long)c * a.K + k0) * a.L + tile * kTile) * a.A;
  const uint32_t* peer[kMaxStrips];
#pragma unroll
  for (int s = 0; s < kMaxStrips; ++s)
    peer[s] = cluster.map_shared_rank(tab, s < strips ? s : 0);
  for (int i = rank * share + threadIdx.x; i < end; i += kThreads) {
    const int e = i >> 7;                        // i = tab_at(e, j, lane)
    const int ll = ((i & 31) << 2) | ((i >> 5) & 3);
    if (ll >= lt) continue;
    uint32_t part[kMaxStrips];           // the strips' loads in flight
#pragma unroll
    for (int s = 0; s < kMaxStrips; ++s) part[s] = s < strips ? peer[s][i] : 0u;
    uint32_t v = 0u;
#pragma unroll
    for (int s = 0; s < kMaxStrips; ++s) v += part[s];
    const int kk = e / a.A, al = e - kk * a.A;
    base[((long long)kk * a.L + ll) * a.A + al] = (float)v;
  }
  cluster.sync();                 // no table is read once its block exits
}

// 0x80 in each byte of w equal to the byte of k4 where hv has 0x80: an
// exact zero-byte test of w ^ k4 (no carry crosses a byte).
__device__ __forceinline__ uint32_t eq_bytes(uint32_t w, uint32_t k4,
                                             uint32_t hv) {
  const uint32_t x = w ^ k4;
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & hv;
}

// The packed plane: per pop k, byte j of cnt[k] counts the copies of locus
// l0 + j with z = k, of one[k] those of them with allele 1.
template <int KB>
__global__ void __launch_bounds__(kThreads, packed_blocks(KB))
    allele_counts_packed_kernel(const CountArgs a) {
  extern __shared__ uint32_t tab[];
  constexpr int U = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, c = blockIdx.z;
  const int L = a.L, K = a.K;
  zero_table(tab, 2 * K);
  const int l0 = tile * kTile + lane * kQuad;
  const bool vec = (L & 3) == 0, live = l0 < L;
  const int n_end = min(a.N, (int)blockIdx.y * a.rows + a.rows);
  const int8_t* zc = a.z + (long long)c * a.N * 2 * L;
  const int8_t* pl = a.bits2 + c * a.plane_cs;
  uint32_t cnt[KB], one[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) cnt[k] = one[k] = 0u;
  int since = 0;   // rows counted since the last flush
  Rows<U, true> cur, nxt;
  int n = blockIdx.y * a.rows + warp;
  cur.load(a, zc, pl, n, n_end, l0, live, vec);
  for (; n < n_end; n += kWarps * U) {
    if (n + kWarps * U < n_end)
      nxt.load(a, zc, pl, n + kWarps * U, n_end, l0, live, vec);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t b = cur.p0[u];
      const uint32_t hv = (b << 5) & 0x80808080u;    // the valid bits
      const uint32_t g0 = b & 0x01010101u, g1 = (b >> 1) & 0x01010101u;
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k < K) {
          const uint32_t k4 = (uint32_t)k * 0x01010101u;
          const uint32_t m0 = eq_bytes(cur.z0[u], k4, hv) >> 7;
          const uint32_t m1 = eq_bytes(cur.z1[u], k4, hv) >> 7;
          cnt[k] += m0 + m1;
          one[k] += (m0 & g0) + (m1 & g1);
        }
      }
    }
    since += U;
    if (since > kFieldRows - U) {
      flush_packed(cnt, one, K, tab, lane);
      since = 0;
    }
    cur = nxt;
  }
  flush_packed(cnt, one, K, tab, lane);
  __syncthreads();
  write_counts(a, tab, c, tile, 0);
}

// The allele codes, K * A <= 8: counts in registers (NR registers of 4
// fields a locus).  The next U rows' words load while the current ones are
// counted.
__global__ void __launch_bounds__(kThreads, kCodesBlocks)
    allele_counts_codes_kernel(const CountArgs a) {
  extern __shared__ uint32_t tab[];
  constexpr int NR = kCodesCells / 4, U = 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, c = blockIdx.z;
  const int L = a.L, K = a.K, A = a.A;
  zero_table(tab, K * A);
  const int l0 = tile * kTile + lane * kQuad;
  const bool vec = (L & 3) == 0, live = l0 < L;
  const int n_end = min(a.N, (int)blockIdx.y * a.rows + a.rows);
  const int8_t* zc = a.z + (long long)c * a.N * 2 * L;
  const int8_t* pl = a.geno + c * a.plane_cs;

  uint32_t f[kQuad][NR];
#pragma unroll
  for (int j = 0; j < kQuad; ++j)
#pragma unroll
    for (int r = 0; r < NR; ++r) f[j][r] = 0u;
  int since = 0;   // rows counted since the last flush
  Rows<U, false> cur, nxt;
  int n = blockIdx.y * a.rows + warp;
  cur.load(a, zc, pl, n, n_end, l0, live, vec);
  for (; n < n_end; n += kWarps * U) {
    if (n + kWarps * U < n_end)
      nxt.load(a, zc, pl, n + kWarps * U, n_end, l0, live, vec);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < kQuad; ++j) {
        int g0, g1;
        const bool ok = cur.site(u, j, g0, g1);
        add_copy(f[j], cell_of(ok, sbyte(cur.z0[u], j), g0, K, A));
        add_copy(f[j], cell_of(ok, sbyte(cur.z1[u], j), g1, K, A));
      }
    }
    since += U;
    if (since > kFieldRows - U) {
      flush(f, tab, lane);
      since = 0;
    }
    cur = nxt;
  }
  flush(f, tab, lane);
  __syncthreads();
  write_counts(a, tab, c, tile, 0);
}

// The allele codes, K * A > 8: a shared-memory table of a window of pops,
// one atomic a copy.
__global__ void __launch_bounds__(kThreads, kTableBlocks)
    allele_counts_table_kernel(
    const CountArgs a) {
  extern __shared__ uint32_t tab[];
  constexpr int U = COUNTS_TABLE_ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x / a.windows;
  const int k0 = (blockIdx.x - tile * a.windows) * a.kw;
  const int c = blockIdx.z;
  const int L = a.L, A = a.A, nk = min(a.kw, a.K - k0);
  zero_table(tab, nk * A);
  const int l0 = tile * kTile + lane * kQuad;
  const bool vec = (L & 3) == 0, live = l0 < L;
  const int n_end = min(a.N, (int)blockIdx.y * a.rows + a.rows);
  const int8_t* zc = a.z + (long long)c * a.N * 2 * L;
  const int8_t* gc = a.geno + c * a.plane_cs;
  Rows<U, false> cur, nxt;
  int n = blockIdx.y * a.rows + warp;
  cur.load(a, zc, gc, n, n_end, l0, live, vec);
  for (; n < n_end; n += kWarps * U) {
    if (n + kWarps * U < n_end)
      nxt.load(a, zc, gc, n + kWarps * U, n_end, l0, live, vec);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < kQuad; ++j) {
        int g0, g1;
        const bool ok = cur.site(u, j, g0, g1);
        const int e0 = cell_of(ok, sbyte(cur.z0[u], j) - k0, g0, nk, A);
        const int e1 = cell_of(ok, sbyte(cur.z1[u], j) - k0, g1, nk, A);
        if (e0 >= 0) atomicAdd(tab + tab_at(e0, j, lane), 1u);
        if (e1 >= 0) atomicAdd(tab + tab_at(e1, j, lane), 1u);
      }
    }
    cur = nxt;
  }
  __syncthreads();
  write_counts(a, tab, c, tile, k0);
}


// The plan of a launch (kernels/fused_step.py:counts_plan).
void plan(int C, int N, int L, int K, int A, bool packed, CountArgs& a,
          dim3& grid, size_t& smem) {
  const int tiles = (L + kTile - 1) / kTile;
  const bool table = !packed && K * A > kCodesCells;
  a.kw = K;
  if (table) {
    a.kw = (int)(kTableSmem / ((size_t)A * kTile * sizeof(uint32_t)));
    a.kw = a.kw < 1 ? 1 : (a.kw > K ? K : a.kw);
  }
  a.windows = (K + a.kw - 1) / a.kw;
  // blocks an SM holds of the body this call runs
  const int kb = K <= 4 ? 4 : (K <= 8 ? 8 : (K <= 16 ? 16 : 32));
  const int per_sm = packed ? packed_blocks(kb)
                     : table ? kTableBlocks : kCodesBlocks;
  const long long cols = (long long)C * tiles * a.windows;
  const long long wave = (long long)COUNTS_SMS * per_sm * (table ? 2 : 1);
  long long strips = 2 * cols <= wave ? wave / cols
                     : (cols < 2 * wave ? COUNTS_MID_STRIPS : 1);
  const long long most = N / kMinRows;
  strips = strips < most ? strips : most;
  strips = strips < 1 ? 1 : (strips > kMaxStrips ? kMaxStrips : strips);
  a.rows = (int)((N + strips - 1) / strips);
  strips = (N + a.rows - 1) / a.rows;             // balanced strips
  grid = dim3((unsigned)(tiles * a.windows), (unsigned)strips, (unsigned)C);
  smem = (size_t)a.kw * A * kTile * sizeof(uint32_t);
}

// One launch, the strips of a tile a cluster.
template <class Kernel>
cudaError_t launch(Kernel kernel, const CountArgs& a, dim3 grid, size_t smem,
                   cudaStream_t s) {
  if (smem > kTableSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// The plan at (C, N, L, K, A) on the packed plane (packed != 0) or the
// allele codes: out = {grid x, grid y (strips: the cluster), rows a strip,
// pops a window, dynamic shared memory}.
extern "C" int allele_counts_launch_plan(int C, int N, int L, int K, int A,
                                         int packed, int* out) {
  if (C < 1 || N < 1 || L < 1 || K < 1 || A < 1)
    return (int)cudaErrorInvalidValue;
  CountArgs a;
  dim3 grid;
  size_t smem;
  plan(C, N, L, K, A, packed != 0 && A == 2 && K * A <= kMaxCells, a, grid,
       smem);
  out[0] = (int)grid.x;
  out[1] = (int)grid.y;
  out[2] = a.rows;
  out[3] = a.kw;
  out[4] = (int)smem;
  return 0;
}

extern "C" int allele_counts_launch(const void* z, const void* bits2,
                                    const void* geno, const void* valid,
                                    void* counts, int C, int N, int L, int K,
                                    int A, long long plane_cs,
                                    void* stream) {
  if (K < 1 || A < 1) return (int)cudaErrorInvalidValue;
  const int cells = K * A;
  // the packed plane holds a biallelic panel's sites (K <= 32); the other
  // bodies read the allele codes
  const bool packed = bits2 != nullptr && A == 2 && cells <= kMaxCells;
  if (!packed && geno == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 0 || L == 0) return 0;
  if (N == 0) {
    cudaMemsetAsync(counts, 0, sizeof(float) * (size_t)C * K * L * A, s);
    return (int)cudaGetLastError();
  }
  CountArgs a;
  dim3 grid;
  size_t smem;
  plan(C, N, L, K, A, packed, a, grid, smem);
  a.z = (const int8_t*)z;
  a.bits2 = packed ? (const int8_t*)bits2 : nullptr;
  a.geno = (const int8_t*)geno;
  a.valid = (const bool*)valid;
  a.counts = (float*)counts;
  a.C = C; a.N = N; a.L = L; a.K = K; a.A = A;
  a.plane_cs = plane_cs;
  cudaError_t e;
  if (packed) {
    e = K <= 4    ? launch(allele_counts_packed_kernel<4>, a, grid, smem, s)
        : K <= 8  ? launch(allele_counts_packed_kernel<8>, a, grid, smem, s)
        : K <= 16 ? launch(allele_counts_packed_kernel<16>, a, grid, smem, s)
                  : launch(allele_counts_packed_kernel<32>, a, grid, smem, s);
  } else if (cells <= kCodesCells) {
    e = launch(allele_counts_codes_kernel, a, grid, smem, s);
  } else {
    e = launch(allele_counts_table_kernel, a, grid, smem, s);
  }
  return (int)e;
}
