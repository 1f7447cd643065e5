// The sequential Chinese-restaurant-process seating sweep of the DPM prior
// as one kernel.
//
// Replaces no Pallas kernel: it is the lax.scan over individuals of
// instruct_tpu/mcmc/dpm.py (init_dpm :81, crp_sweep_selfing :120,
// crp_sweep_inbreeding :238), which XLA runs as one loop on the device and
// eager PyTorch would run as 10-15 launches an individual.  The three
// variants share the body and differ only in how a table scores:
//   prior       log count                  (the table starts empty; no
//                                            removal step)
//   selfing     log count + (g1 > 0 ? g1 log v : 0) + log(1 - v)
//   inbreeding  log count + ll_j[vidx]     (ll_j staged in shared memory)
// A new table scores log_new[j], and takes new_val[j] (and, inbreeding,
// the grid index new_idx[j]): the caller computes both for every j before
// the launch, as the JAX functions hoist them.
//
// What bounds it: latency.  Each individual's seat depends on the seating
// the one before it left, so the N steps are a dependent chain, and each
// step needs a block-wide argmax (first index on ties) and a block-wide
// argmin (the first empty slot).  Bytes (the table, 16 B a slot) and
// operations (a Philox word and two logs per occupied table) are far
// below what the card does in that time.  Design, so that one barrier is
// the only block-wide wait of a step:
//   * one block of 256 threads per chain (a step scans only the occupied
//     slots, so few threads have work, and fewer warps wait at the barrier
//     than at 512 or 1024); slot s belongs to thread s % 256, which alone
//     reads and writes it (count, log count and the variant's cached logs
//     of the value), so seating j needs no barrier:
//     every thread knows the winner after the reduction, and the owner
//     updates its slot;
//   * the argmax and the argmin are one reduction: each warp takes the
//     maximum of the order-preserving unsigned key of its scores, the least
//     choice index at that key and the least empty slot by redux.sync,
//     writes the three to a double-buffered row, and after one barrier
//     every warp reduces the 32 warp partials the same way;
//   * an empty table scores _NEG + noise = _NEG exactly (|noise| is far
//     below half an ulp of 1e30), so the noise is drawn for occupied tables
//     and the new table only: Philox element j * (N + 1) + t of stream
//     STREAM_DPM_SEAT, -log(-log u) -- the words and float operations of
//     the plain version, kernels/crp.py:crp_sweep_reference, which this
//     kernel matches bit for bit (built with -fmad=false, no fast math);
//   * the table lives in shared memory up to SMEM_SLOTS slots, in a global
//     scratch row above (the same owner layout, so still no barrier);
//   * an individual's inputs (its slot, g, the new table's score and value)
//     are loaded one step ahead, mode 5's grid curve row two steps ahead;
//     the new table's noise is drawn a step ahead by the last thread, whose
//     slots are the last to fill (a new table takes the lowest free slot);
//   * a step scans only the slots below hi + 1, hi bounding every slot
//     ever occupied in the sweep: since new tables take the lowest free
//     slot, that is O(tables), not O(N), and it holds the first empty slot.
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // <= 32: one partial a lane
// scores the new table: slots are taken lowest first, so the last thread's
// (255, 511, ...) are the last to be occupied
constexpr int kNewThread = kThreads - 1;
constexpr int kSmemSlots = 4096;        // kernels/crp.py:SMEM_SLOTS
constexpr int kMaxGrid = kThreads;      // kernels/crp.py:MAX_GRID: a thread
                                        // stages a grid point
constexpr float kEps = 1e-30f;
constexpr float kNeg = -1e30f;
constexpr unsigned kNone = 0x7fffffffu;
constexpr unsigned kFull = 0xffffffffu;

enum { kPrior = 0, kSelfing = 1, kInbreeding = 2 };

struct CrpArgs {
  const float* values_in;   // [C, N]  (not read by the prior draw)
  const int* counts_in;     // [C, N]
  const int* assign_in;     // [C, N]
  const float* log_new;     // [C, N]
  const float* new_val;     // [C, N]
  const int* new_idx;       // [C, N]  inbreeding
  const int* gen;           // [C, N]  selfing
  const float* ll_grid;     // [C, N, M]  inbreeding
  float* values_out;        // [C, N]
  int* counts_out;          // [C, N]
  int* assign_out;          // [C, N]
  float4* scratch;          // [C, N] working table above kSmemSlots
  int N, M;
  uint32_t k0, k1, step;
  const int* chain_key;
};

__device__ __forceinline__ float slog(float x) { return logf(fmaxf(x, kEps)); }

// A slot: x = count (int bits), y = log count, z/w = the variant's cached
// terms of the value: selfing log v and log(1 - v); inbreeding the grid
// index (int bits) in z.
template <int V>
__device__ __forceinline__ float4 make_slot(int count, float v, int vidx) {
  float4 r;
  r.x = __int_as_float(count);
  r.y = slog((float)count);
  r.z = 0.0f;
  r.w = 0.0f;
  if (V == kSelfing) {
    r.z = slog(v);
    r.w = slog(1.0f - v);
  } else if (V == kInbreeding) {
    r.z = __int_as_float(vidx);
  }
  return r;
}

// The inputs of individual j, loaded one step ahead so that their latency
// is off the dependent chain.
struct Inputs {
  int old;          // the slot j leaves
  float g1;         // selfing: g_j - 1
  float log_new;    // the new table's score
  float new_val;    // a new table's value
  int new_idx;      // inbreeding: its grid index
};

template <int V>
__device__ __forceinline__ Inputs load_inputs(const CrpArgs& a, long long cj) {
  Inputs in;
  in.old = V != kPrior ? a.assign_in[cj] : 0;
  in.g1 = V == kSelfing ? (float)(a.gen[cj] - 1) : 0.0f;
  in.log_new = a.log_new[cj];
  in.new_val = a.new_val[cj];
  in.new_idx = V == kInbreeding ? a.new_idx[cj] : 0;
  return in;
}

// Unsigned key that orders as the float does (-0 is first made +0).
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(s + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float seat_noise(const CrpArgs& a, uint32_t chain,
                                            int j, int t) {
  const long long e = (long long)j * (a.N + 1) + t;
  const Philox4 r = philox4x32_10((uint32_t)(e >> 2), STREAM_DPM_SEAT, a.step,
                                  chain, a.k0, a.k1);
  const float u = u01_open(philox_word(r, (int)(e & 3)));
  return -logf(-logf(u));
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    crp_kernel(const CrpArgs a) {
  extern __shared__ float4 smem_table[];
  __shared__ float ll_s[2][kMaxGrid];
  __shared__ unsigned red[2][3][kWarps];
  const int c = blockIdx.x;
  const int N = a.N;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)c * N;
  float4* tab = N <= kSmemSlots ? smem_table : a.scratch + row0;
  const uint32_t chain = (uint32_t)a.chain_key[c];

  unsigned top = 0u;
  for (int s = tid; s < N; s += kThreads) {
    int count = 0, vidx = 0;
    float v = 0.0f;
    if (V != kPrior) {
      count = a.counts_in[row0 + s];
      v = a.values_in[row0 + s];
      if (V == kInbreeding)
        vidx = min(max((int)(v * (float)a.M), 0), a.M - 1);
    }
    if (count > 0) top = (unsigned)(s + 1);
    a.values_out[row0 + s] = v;
    tab[s] = make_slot<V>(count, v, vidx);
  }
  float ll_next = 0.0f;
  if (V == kInbreeding && tid < a.M) {
    ll_s[0][tid] = a.ll_grid[row0 * a.M + tid];
    if (N > 1) ll_next = a.ll_grid[(row0 + 1) * a.M + tid];
  }
  // the first loop step writes red[0], its next red[1]: every thread reads
  // this before the first step's barrier
  top = __reduce_max_sync(kFull, top);
  if (lane == 0) red[1][0][warp] = top;
  __syncthreads();
  // every occupied slot lies below hi, a bound all threads keep alike (it
  // only rises): a step scores slots below hi + 1, which holds the first
  // empty slot
  int hi = (int)__reduce_max_sync(kFull, lane < kWarps ? red[1][0][lane] : 0u);

  int parity = 0;
  Inputs next = load_inputs<V>(a, row0);
  float noise0 = tid == kNewThread ? seat_noise(a, chain, 0, 0) : 0.0f;
  for (int j = 0; j < N; ++j) {
    const long long cj = row0 + j;
    const Inputs in = next;
    if (j + 1 < N) next = load_inputs<V>(a, cj + 1);
    if (V != kPrior && in.old % kThreads == tid) {
      float4 r = tab[in.old];
      const int count = __float_as_int(r.x) - 1;
      r.x = __int_as_float(count);
      r.y = slog((float)count);
      tab[in.old] = r;
    }
    const float g1 = in.g1;
    const float* ll = ll_s[j & 1];

    unsigned best_key = 0u, best_idx = kNone, free_idx = kNone;
    if (tid == kNewThread) {
      // the new table, scored by a thread that owns no leading slot, with
      // its noise drawn a step ahead
      best_key = order_key(in.log_new + noise0);
      best_idx = 0u;
      if (j + 1 < N) noise0 = seat_noise(a, chain, j + 1, 0);
    }
    const int lim = min(N, hi + 1);
    for (int s = tid; s < lim; s += kThreads) {
      const float4 r = tab[s];
      float score = kNeg;
      if (__float_as_int(r.x) > 0) {
        float t = r.y;
        if (V == kSelfing) {
          t = t + ((g1 > 0.0f ? g1 * r.z : 0.0f) + r.w);
        } else if (V == kInbreeding) {
          t = t + ll[__float_as_int(r.z)];
        }
        score = t + seat_noise(a, chain, j, s + 1);
      } else if (free_idx == kNone) {
        free_idx = (unsigned)s;
      }
      const unsigned key = order_key(score);
      if (key > best_key) {     // strictly: the first index wins ties
        best_key = key;
        best_idx = (unsigned)(s + 1);
      }
    }
    if (V == kInbreeding && tid < a.M) {
      // the next row, loaded a step ago, into the buffer the previous step
      // read (that step's reads came before its barrier); the row after it
      // into a register
      if (j + 1 < N) ll_s[(j + 1) & 1][tid] = ll_next;
      if (j + 2 < N) ll_next = a.ll_grid[(cj + 2) * a.M + tid];
    }

    unsigned wkey = __reduce_max_sync(kFull, best_key);
    unsigned widx =
        __reduce_min_sync(kFull, best_key == wkey ? best_idx : kNone);
    unsigned wfree = __reduce_min_sync(kFull, free_idx);
    if (lane == 0) {
      red[parity][0][warp] = wkey;
      red[parity][1][warp] = widx;
      red[parity][2][warp] = wfree;
    }
    __syncthreads();
    const bool part = lane < kWarps;
    const unsigned pkey = part ? red[parity][0][lane] : 0u;
    const unsigned pidx = part ? red[parity][1][lane] : kNone;
    const unsigned pfree = part ? red[parity][2][lane] : kNone;
    parity ^= 1;
    const unsigned bkey = __reduce_max_sync(kFull, pkey);
    const unsigned choice =
        __reduce_min_sync(kFull, pkey == bkey ? pidx : kNone);
    const unsigned free_slot = __reduce_min_sync(kFull, pfree);

    const bool is_new = choice == 0u;
    const int slot = is_new ? (int)free_slot : (int)choice - 1;
    hi = max(hi, slot + 1);
    if (slot % kThreads == tid) {
      float4 r = tab[slot];
      const int count = __float_as_int(r.x) + 1;
      if (is_new) {
        a.values_out[row0 + slot] = in.new_val;
        r = make_slot<V>(count, in.new_val, in.new_idx);
      } else {
        r.x = __int_as_float(count);
        r.y = slog((float)count);
      }
      tab[slot] = r;
    }
    if (tid == 0) a.assign_out[cj] = slot;
  }
  for (int s = tid; s < N; s += kThreads)
    a.counts_out[row0 + s] = __float_as_int(tab[s].x);
}

template <int V>
int launch_variant(const CrpArgs& a, int C, cudaStream_t stream) {
  const int smem = a.N <= kSmemSlots ? a.N * (int)sizeof(float4) : 0;
  // the opt-in above 48 KB holds for the current device only, so it is set
  // at every launch (a cheap call)
  const cudaError_t err = cudaFuncSetAttribute(
      crp_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemSlots * (int)sizeof(float4));
  if (err != cudaSuccess) return (int)err;
  crp_kernel<V><<<C, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int crp_sweep_launch(
    const float* values_in, const int* counts_in, const int* assign_in,
    const float* log_new, const float* new_val, const int* new_idx,
    const int* gen, const float* ll_grid, float* values_out, int* counts_out,
    int* assign_out, void* scratch, int C, int N, int M, int variant,
    unsigned k0, unsigned k1, const int* chain_key, unsigned step,
    cudaStream_t stream) {
  if (C < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (variant == kInbreeding && (M < 1 || M > kMaxGrid))
    return (int)cudaErrorInvalidValue;
  if (N > kSmemSlots && scratch == nullptr) return (int)cudaErrorInvalidValue;
  CrpArgs a{values_in, counts_in, assign_in, log_new, new_val, new_idx, gen,
            ll_grid, values_out, counts_out, assign_out, (float4*)scratch,
            N, M, k0, k1, step, chain_key};
  switch (variant) {
    case kPrior: return launch_variant<kPrior>(a, C, stream);
    case kSelfing: return launch_variant<kSelfing>(a, C, stream);
    case kInbreeding: return launch_variant<kInbreeding>(a, C, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
