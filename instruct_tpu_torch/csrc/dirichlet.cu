// Dirichlet sampler over count groups: the P and Q draws of the sweep.
//
// Replaces the TPU kernel dirichlet_rows / _kernel of
// instruct_tpu/kernels/dirichlet_pallas.py (its layout wrapper dirichlet_kla
// included).  Same function of the uniforms: Gamma(conc) per cell by
// Marsaglia-Tsang with a FIXED number of rejection rounds, Wilson-Hilferty
// fallback, Box-Muller normals, the Gamma(a+1) * U^(1/a) boost for a < 1,
// normalised within each group.
//
// What bounds it: operations.  A cell takes n_test_draws(rounds) = 12
// uniforms (a quarter of a Philox block each) and ~20 logs, cosines, roots
// and divisions; the arrays are a few hundred kilobytes.  At the sampler's
// small shapes (Q: 4 chains x 1000 groups of 3 cells) the latency of one
// cell's chain of transcendentals bounds it instead.
// Design (kernels/dirichlet.py:dirichlet_plan is the same plan in Python):
//   * A task is one cell row j of a tile of 32 consecutive columns m of one
//     (chain, group): a warp, a lane per column.  The J cells of a group are
//     split over the warps of a block (jw warps a tile, up to 4, a block of
//     1, 2 or 4 tiles), so a group's cells are drawn in parallel and the
//     card is filled even where groups are few; where tiles are many (the
//     K grid's P), a warp draws its tile's J cells itself.
//   * Philox: the words of plane d of a task are 32 consecutive words of the
//     counter space, so 8 blocks (9 where they straddle a block edge: M not
//     a multiple of 4) serve the task's lanes.  The lanes compute the
//     task's 8 (9) x n_test_draws blocks together -- each block once, 3 (4)
//     a lane -- into a staging area in shared memory, and each lane takes
//     its words from there.
//   * The gammas go to shared memory; after a barrier a thread a column
//     takes its group's sum in j order (0..J-1, as the plain version does)
//     and writes the group's cells once, divided by it.
// Built with -fmad=false, a cell's float operations are those of the plain
// version and of the first body of this kernel, bit for bit.
//
// Uniform plane d of the cell in (row r = g*J + j, column m) is word
// d*R*M + r*M + m of the (chain, step, stream) Philox counter space, or
// draws[c, d, r, m] when uniforms are injected.
#include "philox.cuh"

namespace {

constexpr float kTiny = 1e-30f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kThird = 1.0f / 3.0f;
constexpr int kCols = 32;        // columns a task: a warp's lanes
constexpr int kMaxWarps = 4;     // warps a block
// Tiles from which a warp draws all J cells of its tile itself: enough to
// fill the card without spreading a group over warps (8 waves of 4-warp
// blocks, 8 an SM, on the H100's 132 SMs).
#ifndef DIRICHLET_SERIAL_TILES
#define DIRICHLET_SERIAL_TILES (8 * 132 * 8 * 4)
#endif

struct DirArgs {
  const float* conc;
  const bool* valid;
  const float* draws;
  float* out;
  int C, G, J, M;
  long long cs_c, cs_g, cs_j, cs_m, vs_g, vs_j, vs_m;
  int rounds;
  uint32_t k0, k1;
  const int* chain_key;
  uint32_t step, stream;
  // the plan
  int jw;             // warps a tile (its cells j = w, w + jw, ...)
  int nt;             // tiles a block
  int slots;          // Philox blocks staged a plane: 8, or 9 when M % 4
  uint32_t col_tiles, tiles;   // 32-column tiles a (chain, group); all
};

// The (chain, group, first column) of a tile.
struct Tile {
  int c, g, m0;
  __device__ __forceinline__ Tile(const DirArgs& a, uint32_t t) {
    const uint32_t row = t / a.col_tiles;
    m0 = (int)(t - row * a.col_tiles) * 32;
    c = (int)(row / (uint32_t)a.G);
    g = (int)(row - (uint32_t)c * (uint32_t)a.G);
  }
};

// The uniforms of one lane's cell: staged Philox words or injected planes.
struct Draws {
  const uint32_t* stage;   // the warp's staged blocks, 4 words a slot
  const float* inj;        // injected planes of this chain, or nullptr
  long long plane;         // R * M
  long long cell;          // this lane's r * M + m
  int slots, p4, c4, lane; // plane & 3, (the task's first cell) & 3

  __device__ __forceinline__ float operator()(int d) const {
    if (inj != nullptr) return inj[(long long)d * plane + cell];
    // word d*plane + cell of the counter space: slot x >> 2 of plane d
    // holds the block of its word x - lane, at the plane's offset in a block
    const int x = ((d * p4 + c4) & 3) + lane;
    return u01_open(stage[(d * slots + (x >> 2)) * 4 + (x & 3)]);
  }
};

__device__ __forceinline__ float box_muller(float u1, float u2) {
  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
}

__device__ float gamma_cell(float conc, bool valid, const Draws& u,
                            int rounds) {
  const float a0 = valid ? conc : 1.0f;
  const bool small = a0 < 1.0f;
  const float a = a0 + (small ? 1.0f : 0.0f);
  const float d = a - kThird;
  const float c = rsqrtf(9.0f * d);
  float g = 0.0f;
  bool acc = false;
  for (int r = 0; r < rounds; ++r) {
    const float z = box_muller(u(3 * r), u(3 * r + 1));
    const float v1 = 1.0f + c * z;
    const float v = v1 * v1 * v1;
    const float rhs =
        0.5f * z * z + d - d * v + d * logf(fmaxf(v, kTiny));
    const bool ok = (v > 0.0f) && (logf(u(3 * r + 2)) < rhs);
    if (ok && !acc) g = d * v;
    acc = acc || ok;
  }
  const float zf = box_muller(u(3 * rounds), u(3 * rounds + 1));
  const float w1 = 1.0f - 1.0f / (9.0f * a) + zf * rsqrtf(9.0f * a);
  const float wh = a * w1 * w1 * w1;
  if (!acc) g = fmaxf(wh, kTiny);
  if (small) {
    g = g * expf(logf(u(3 * rounds + 2)) / fmaxf(a0, 1e-6f));
  }
  return valid ? g : 0.0f;
}

__global__ void __launch_bounds__(kMaxWarps * kCols) dirichlet_kernel(
    const DirArgs a) {
  extern __shared__ uint4 smem[];
  const int warp = threadIdx.x / kCols, lane = threadIdx.x % kCols;
  const int nw = blockDim.x / kCols;
  const int nd = 3 * a.rounds + 3, J = a.J;
  uint4* stage = smem + warp * nd * a.slots;
  float* gam = reinterpret_cast<float*>(smem + nw * nd * a.slots);
  const long long plane = (long long)a.G * J * a.M;

  const int tl = warp / a.jw;
  const uint32_t tile = blockIdx.x * (uint32_t)a.nt + tl;   // gam [nt][J][32]
  if (tile < a.tiles) {
    const Tile t(a, tile);
    const int c = t.c, g = t.g, m0 = t.m0;
    const int live = min(kCols, a.M - m0);
    const int m = m0 + lane;
    const uint32_t chain = (uint32_t)a.chain_key[c];
    Draws u;
    u.stage = reinterpret_cast<const uint32_t*>(stage);
    u.inj = a.draws == nullptr ? nullptr
                               : a.draws + (long long)c * nd * plane;
    u.plane = plane;
    u.slots = a.slots;
    u.p4 = (int)(plane & 3);
    u.lane = lane;
    for (int j = warp - tl * a.jw; j < J; j += a.jw) {
      const long long cell0 = ((long long)g * J + j) * a.M + m0;
      u.cell = cell0 + lane;
      u.c4 = (int)(cell0 & 3);
      if (u.inj == nullptr) {
        __syncwarp();                  // the last cell's reads are done
        for (int q = lane; q < nd * a.slots; q += kCols) {
          const int d = a.slots == 8 ? q >> 3 : q / 9;
          const int k = q - d * a.slots;
          const long long base = (long long)d * plane + cell0;
          if (k <= (((int)(base & 3) + live - 1) >> 2)) {
            const Philox4 r = philox4x32_10(
                (uint32_t)(base >> 2) + (uint32_t)k, a.stream, a.step, chain,
                a.k0, a.k1);
            stage[q] = make_uint4(r.x, r.y, r.z, r.w);
          }
        }
        __syncwarp();
      }
      float gj = 0.0f;
      if (lane < live) {
        const long long off =
            c * a.cs_c + g * a.cs_g + j * a.cs_j + m * a.cs_m;
        const bool ok = a.valid == nullptr
                            ? true
                            : a.valid[g * a.vs_g + j * a.vs_j + m * a.vs_m];
        gj = gamma_cell(a.conc[off], ok, u, a.rounds);
      }
      gam[(tl * J + j) * kCols + lane] = gj;
    }
  }
  __syncthreads();
  // A thread a column: the group's sum in j order, then its J cells.
  const uint32_t t2 = blockIdx.x * (uint32_t)a.nt + threadIdx.x / kCols;
  if (threadIdx.x >= a.nt * kCols || t2 >= a.tiles) return;
  const Tile t(a, t2);
  const int m = t.m0 + lane;
  if (m >= a.M) return;
  const float* col = gam + (threadIdx.x / kCols) * J * kCols + lane;
  float tot = col[0];
  for (int j = 1; j < J; ++j) tot = tot + col[j * kCols];
  const float den = fmaxf(tot, kTiny);
  float* out = a.out + t.c * a.cs_c + t.g * a.cs_g + m * a.cs_m;
  for (int j = 0; j < J; ++j) out[j * a.cs_j] = col[j * kCols] / den;
}

// The plan of a launch (kernels/dirichlet.py:dirichlet_plan).
void plan(int C, int G, int J, int M, int rounds, DirArgs& a, int& threads,
          size_t& smem) {
  a.col_tiles = (uint32_t)((M + kCols - 1) / kCols);
  a.tiles = (uint32_t)C * (uint32_t)G * a.col_tiles;
  const int per = (J + kMaxWarps - 1) / kMaxWarps;   // cells a warp
  a.jw = a.tiles >= DIRICHLET_SERIAL_TILES ? 1 : (J + per - 1) / per;
  a.nt = a.jw > kMaxWarps / 2 ? 1 : kMaxWarps / a.jw;
  a.slots = M % 4 == 0 ? 8 : 9;
  threads = kCols * a.jw * a.nt;
  smem = (size_t)a.jw * a.nt * (3 * rounds + 3) * a.slots * sizeof(uint4) +
         (size_t)a.nt * J * kCols * sizeof(float);
}

}  // namespace

// Dynamic shared memory (bytes) and threads of the launch at (C, G, J, M,
// rounds): out[0], out[1].
extern "C" int dirichlet_launch_plan(int C, int G, int J, int M, int rounds,
                                     int* out) {
  if (C <= 0 || G <= 0 || J <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  DirArgs a;
  int threads;
  size_t smem;
  plan(C, G, J, M, rounds, a, threads, smem);
  out[0] = (int)smem;
  out[1] = threads;
  return 0;
}

extern "C" int dirichlet_launch(
    const void* conc, const void* valid, const void* draws, void* out, int C,
    int G, int J, int M, long long cs_c, long long cs_g, long long cs_j,
    long long cs_m, long long vs_g, long long vs_j, long long vs_m,
    int rounds, unsigned k0, unsigned k1, const void* chain_key,
    unsigned step, unsigned stream_id, void* stream) {
  if (C <= 0 || G <= 0 || J <= 0 || M <= 0) return 0;
  DirArgs a;
  int threads;
  size_t smem;
  plan(C, G, J, M, rounds, a, threads, smem);
  a.conc = (const float*)conc;
  a.valid = (const bool*)valid;
  a.draws = (const float*)draws;
  a.out = (float*)out;
  a.C = C; a.G = G; a.J = J; a.M = M;
  a.cs_c = cs_c; a.cs_g = cs_g; a.cs_j = cs_j; a.cs_m = cs_m;
  a.vs_g = vs_g; a.vs_j = vs_j; a.vs_m = vs_m;
  a.rounds = rounds;
  a.k0 = k0; a.k1 = k1;
  a.chain_key = (const int*)chain_key;
  a.step = step; a.stream = stream_id;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dirichlet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (a.tiles + a.nt - 1) / a.nt;
  dirichlet_kernel<<<blocks, threads, smem,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
