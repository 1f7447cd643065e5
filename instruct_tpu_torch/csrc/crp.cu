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
//   inbreeding  log count + ll_j[vidx]
// A new table scores log_new[j], and takes new_val[j] (and, inbreeding,
// the grid index new_idx[j]): the caller computes both for every j before
// the launch, as the JAX functions hoist them.
//
// What bounds it: latency.  Each individual's seat depends on the seating
// the one before it left, so the N steps are a dependent chain, and each
// step needs an argmax over the choices (first index on ties) and the
// first empty slot.  Bytes (the table, 16 B a slot) and operations (a
// quarter of a Philox block and two logs per occupied table) are far below
// what the card does in that time.  So the chain is carried by ONE warp
// and everything that does not depend on the seating is taken off it:
//   * the seater (warp 0 of a block of CRP_WARPS = 4, one block per chain;
//     alone on its warp scheduler, warp w issuing on scheduler w % 4)
//     carries the chain with no block-wide barrier on it.  Slot s belongs
//     to lane s % 32, which alone reads and writes it (count, log count and
//     the variant's cached terms of the value), so removal, scoring and
//     update need no barrier; the argmax (the order-preserving unsigned key
//     of the score, then the least choice index at that key) and the first
//     empty slot are three redux.sync reductions.  The first kRegSlots = 64
//     slots (an ordinary table: a new table takes the first empty slot)
//     live in its registers, so a step's removal, scoring and update of
//     them are selects with no branch; a step reads the next row's header
//     and its register slots' noise while its reductions run, does the next
//     row's removal and looks up the log counts it leaves at its end, and
//     lane j % 32 keeps the seat of step j for a store of 32 at a time;
//   * the noise of choice t of individual j is element j * (N + 1) + t of
//     the Philox stream STREAM_DPM_SEAT, -log(-log u): it does not depend
//     on the seating, only which choices are scored does.  The producer
//     warps (the other CRP_WARPS - 1) draw it ahead into a ring of kDepth =
//     8 entries in shared memory, a Philox block giving its 4 consecutive
//     elements (a quarter of the first body's Philox work), each entry with
//     row j's inputs (the slot j leaves, g - 1, the new table's score,
//     value, grid index and the logs of its value) and, mode 5, the grid
//     curve row ll_grid[c, j, :] (cp.async).  Producer warp p fills rows
//     p, p + (CRP_WARPS - 1), ..., loading 32 rows' inputs at once (a lane
//     a row);
//   * which choices step j scores: the occupied slots, all below hi_j,
//     and hi rises by at most one a step (a new table takes the first
//     empty slot, which lies at or below hi).  The seater publishes hi
//     with each entry it frees (hi_at), so the producer of row j, filling
//     the entry freed by row j - kDepth, knows hi at step j - kDepth + 1
//     and fills the columns 0 .. W_j + 1, W_j = hi_(j-kDepth+1) + kDepth
//     - 1 >= hi_j (row j < kDepth: hi_0 + j; the extra column covers the
//     read ahead, hi_(j-1) + 2 <= W_j + 1).  Columns past the ring's width
//     (crp_plan: as many as shared memory holds, all N + 1 up to N = 4287
//     to 4444) go to the entry's row of a global spill [C, kDepth, N + 1 -
//     width], so any table count stays exact and no noise is drawn on the
//     chain (drawn inline by the seater's lanes, a crowded table at N =
//     10 000 would cost each lane ~80 dependent Philox blocks and log
//     pairs a step); a crowded table's slots past the registers are read
//     from the table, kScan = 8 a lane at a time, loads first;
//   * handshake by mbarriers with phase parity: full[r] (the 32 lanes of
//     the producing warp arrive), empty[r] (the seater's 32 lanes arrive
//     after the step's reductions); only the seater waits for a full
//     entry, only a producer for an empty one;
//   * the log counts by lookup: logc[k] = logf(max(k, 1e-30)) for k = 0..N
//     in shared memory, built by the block with the plain version's slog,
//     so the step's update takes no logarithm;
//   * the table lives in shared memory up to SMEM_SLOTS = 8192 slots, in a
//     global scratch row above (the same owner layout).
// The words and float operations of a score are the plain version's,
// kernels/crp.py:crp_sweep_reference, which this kernel matches bit for
// bit (built with -fmad=false, no fast math): an empty table scores _NEG
// (its noise is far below half an ulp of 1e30), the first index wins ties
// (the new table, choice 0, first of all), a new table takes the first
// empty slot after the removal.
//
// crp_warp_floor_kernel is the design's latency floor, a measurement aid:
// N dependent warp steps, each one shared-memory read, a redux max / min
// pair and one shared-memory write.
#include "philox.cuh"

#ifndef CRP_WARPS
#define CRP_WARPS 4   // the seater warp and CRP_WARPS - 1 producer warps
#endif
#ifndef CRP_DEPTH
#define CRP_DEPTH 8   // ring entries (kernels/crp.py:RING_DEPTH), a power of 2
#endif

namespace {

constexpr int kWarps = CRP_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kProducers = kWarps - 1;
constexpr int kSmemSlots = 8192;     // kernels/crp.py:SMEM_SLOTS
constexpr int kRegSlots = 64;        // the seater's register slots (REG_SLOTS)
constexpr int kScan = 8;    // a crowded table's slots a lane reads at once
constexpr int kMaxGrid = 256;        // kernels/crp.py:MAX_GRID
constexpr int kDepth = CRP_DEPTH;
static_assert((kDepth & (kDepth - 1)) == 0, "the ring's depth is a power of 2");
// a producer waits for the entry it fills to be freed one phase back; with
// more producers than entries one could wait two phases back, which the
// phase parity cannot tell from one
static_assert(kProducers <= kDepth, "more producer warps than ring entries");
constexpr int kHead = 8;             // words of an entry's header (HEAD)
// a block's shared memory (232 448 bytes) less what the kernel declares
// statically (kernels/crp.py:SMEM_BUDGET)
constexpr int kSmemBudget = 232448 - 1024;
constexpr float kEps = 1e-30f;
constexpr float kNeg = -1e30f;
constexpr unsigned kNone = 0x7fffffffu;
constexpr unsigned kFull = 0xffffffffu;

enum { kPrior = 0, kSelfing = 1, kInbreeding = 2 };

// The launch plan (kernels/crp.py:crp_plan): shared-memory words of each
// part and the ring's width (columns of noise an entry holds; the rest of
// a row's N + 1 go to the spill)
struct Plan {
  int table_bytes;   // 16 N where the table fits shared memory, else 0
  int logc_words;    // N + 1, rounded up to 4
  int ll_words;      // M rounded up to 4 (inbreeding), else 0
  int width;         // noise columns an entry holds
  int stride;        // words of an entry: kHead + ll_words + width (to 4)
  int smem;          // dynamic shared-memory bytes
};

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline Plan make_plan(int N, int M, int variant) {
  Plan p;
  p.table_bytes = N <= kSmemSlots ? 16 * N : 0;
  p.logc_words = up4(N + 1);
  p.ll_words = variant == kInbreeding ? up4(M) : 0;
  const int free_words =
      (kSmemBudget - p.table_bytes - 4 * p.logc_words) / (4 * kDepth) -
      kHead - p.ll_words;
  p.width = N + 1 <= free_words ? N + 1 : (free_words & ~3);
  // the register slots' columns lie in the ring
  if (p.width < N + 1 && p.width <= kRegSlots) p.width = 0;
  p.stride = kHead + p.ll_words + up4(p.width);
  p.smem = p.table_bytes + 4 * p.logc_words + 4 * kDepth * p.stride;
  return p;
}

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
  float* spill;             // [C, kDepth, N + 1 - width] noise past the ring
  int N, M;
  uint32_t k0, k1, step;
  const int* chain_key;
  Plan plan;
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

// Unsigned key that orders as the float does (-0 is first made +0).
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(s + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float gumbel(uint32_t word) {
  return -logf(-logf(u01_open(word)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// acquire: wait for the phase of this parity to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// release: the arriving thread's earlier accesses are ordered before the
// waiters'
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

// An entry's header: the inputs of its row
enum { hOld = 0, hG1, hLogNew, hNewVal, hNewIdx, hLogV, hLog1mV };

// Row j's ring entry: its header, mode 5's grid row, then its noise
// columns below the ring's width (which holds every register slot's:
// width > kRegSlots)
struct Row {
  const float* e;
  const float* noise;
};

__device__ __forceinline__ Row row_of(const CrpArgs& a, const float* ring,
                                      int j) {
  Row w;
  w.e = ring + (j & (kDepth - 1)) * a.plan.stride;
  w.noise = w.e + kHead + a.plan.ll_words;
  return w;
}

// Row j's spill row, indexed by the column itself (from width on)
__device__ __forceinline__ const float* spill_of(const CrpArgs& a, int c,
                                                 int j) {
  return a.spill +
         ((long long)c * kDepth + (j & (kDepth - 1))) *
             (a.N + 1 - a.plan.width) -
         a.plan.width;
}

// A producer warp: rows p, p + kProducers, ... into the ring
template <int V>
__device__ __forceinline__ void produce(const CrpArgs& a, float* ring,
                                        uint64_t* full, uint64_t* empty,
                                        const int* hi_at, int hi0,
                                        uint32_t chain, int c, int p,
                                        int lane) {
  const long long row0 = (long long)c * a.N;
  const int N = a.N;
  const Plan& pl = a.plan;
  int in_old = 0, in_idx = 0;
  float in_g1 = 0.f, in_log_new = 0.f, in_val = 0.f, in_lv = 0.f,
        in_l1v = 0.f;
  int t = 0;
  for (int j = p; j < N; j += kProducers, ++t) {
    if ((t & 31) == 0) {
      // the inputs of this row and the producer's next 31, a lane a row
      const int jl = j + lane * kProducers;
      if (jl < N) {
        const long long cj = row0 + jl;
        if (V != kPrior) in_old = a.assign_in[cj];
        if (V == kSelfing) in_g1 = (float)(a.gen[cj] - 1);
        in_log_new = a.log_new[cj];
        in_val = a.new_val[cj];
        if (V == kSelfing) {
          in_lv = slog(in_val);
          in_l1v = slog(1.0f - in_val);
        }
        if (V == kInbreeding) in_idx = a.new_idx[cj];
      }
    }
    const int src = t & 31;
    const int old = __shfl_sync(kFull, in_old, src);
    const float g1 = __shfl_sync(kFull, in_g1, src);
    const float log_new = __shfl_sync(kFull, in_log_new, src);
    const float val = __shfl_sync(kFull, in_val, src);
    const float lv = __shfl_sync(kFull, in_lv, src);
    const float l1v = __shfl_sync(kFull, in_l1v, src);
    const int idx = __shfl_sync(kFull, in_idx, src);

    const int r = j % kDepth, round = j / kDepth;
    // W_j bounds the columns step j can score; one more column lets the
    // seater read its register slots' noise a step ahead
    int w;
    if (round == 0) {
      w = hi0 + j;
    } else {
      mbar_wait(&empty[r], (unsigned)(round - 1) & 1u);
      w = hi_at[r] + kDepth - 1;
    }
    w = min(w + 1, N);
    float* e = ring + r * pl.stride;
    if (lane == 0) {
      e[hOld] = __int_as_float(old);
      e[hG1] = g1;
      e[hLogNew] = log_new;
      e[hNewVal] = val;
      e[hNewIdx] = __int_as_float(idx);
      e[hLogV] = lv;
      e[hLog1mV] = l1v;
    }
    if (V == kInbreeding) {
      const float* src_row = a.ll_grid + (row0 + j) * a.M;
      for (int m = lane; m < a.M; m += 32) cp_async4(e + kHead + m, src_row + m);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    float* noise = e + kHead + pl.ll_words;
    float* spill = const_cast<float*>(spill_of(a, c, j));
    const long long e0 = (long long)j * (N + 1);
    const long long e1 = e0 + w;
#pragma unroll 2
    for (long long b = (e0 >> 2) + lane; b <= (e1 >> 2); b += 32) {
      const Philox4 r4 = philox4x32_10((uint32_t)b, STREAM_DPM_SEAT, a.step,
                                       chain, a.k0, a.k1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long el = 4 * b + i;
        if (el < e0 || el > e1) continue;
        const int col = (int)(el - e0);
        const float v = gumbel(philox_word(r4, i));
        if (col < pl.width) noise[col] = v;
        else spill[col] = v;
      }
    }
    if (V == kInbreeding) asm volatile("cp.async.wait_all;\n" ::: "memory");
    mbar_arrive(&full[r]);
  }
}

// A row's inputs, from its entry's header
struct Head {
  int old, new_idx;
  float g1, log_new, new_val, lv, l1v;
};

__device__ __forceinline__ Head read_head(const float* e) {
  const float4 a = *reinterpret_cast<const float4*>(e);
  const float4 b = *reinterpret_cast<const float4*>(e + 4);
  Head h;
  h.old = __float_as_int(a.x);    // hOld .. hNewVal, then hNewIdx ..
  h.g1 = a.y;
  h.log_new = a.z;
  h.new_val = a.w;
  h.new_idx = __float_as_int(b.x);
  h.lv = b.y;
  h.l1v = b.z;
  return h;
}

// A slot the seater keeps in registers: lane l holds slots l and l + 32
struct RSlot {
  int s, cnt;
  float z, w;   // the variant's terms of the value (mode 5: z the grid index)
  float nz;     // this step's noise of choice s + 1, read a step ahead
  float ll;     // mode 5: this step's ll_j[grid index], read a step ahead
};

__device__ __forceinline__ void load_rslot(RSlot& x, const float4* tab,
                                           int s, int N) {
  const float4 s4 = s < N ? tab[s] : make_float4(0.f, 0.f, 0.f, 0.f);
  x.s = s;
  x.cnt = __float_as_int(s4.x);
  x.z = s4.z;
  x.w = s4.w;
  x.nz = 0.f;
  x.ll = 0.f;
}

// Score slot s of a lane (the lane's slots come in increasing order, so a
// strictly larger key keeps the first index on ties); an empty slot below
// lim scores _NEG and is the lane's first empty slot if it has none yet
template <int V>
__device__ __forceinline__ void score_slot(int s, bool occ, bool in, float y,
                                           float z, float w, float ll,
                                           float nz, const Head& h,
                                           unsigned& best_key,
                                           unsigned& best_idx,
                                           unsigned& free_idx) {
  float t = y;
  if (V == kSelfing) {
    t = t + ((h.g1 > 0.0f ? h.g1 * z : 0.0f) + w);
  } else if (V == kInbreeding) {
    t = t + ll;
  }
  const float score = occ ? t + nz : kNeg;
  if (in && !occ && free_idx == kNone) free_idx = (unsigned)s;
  const unsigned key = in ? order_key(score) : 0u;
  if (key > best_key) {
    best_key = key;
    best_idx = (unsigned)(s + 1);
  }
}

// A table slot above the registers loses (removal, d = -1) or gains (a
// seat, d = +1) a member; a new table takes its value's terms
template <int V>
__device__ __forceinline__ void table_move(float4* tab, const float* logc,
                                           int s, int d, bool is_new,
                                           const Head& h) {
  float4 s4 = tab[s];
  const int count = __float_as_int(s4.x) + d;
  s4.x = __int_as_float(count);
  s4.y = logc[count];
  if (is_new) {
    if (V == kSelfing) {
      s4.z = h.lv;
      s4.w = h.l1v;
    } else if (V == kInbreeding) {
      s4.z = __int_as_float(h.new_idx);
    }
  }
  tab[s] = s4;
}

// The slots s_begin, s_begin + 32, ... below s_end that a lane owns,
// kScan at a time, their loads first (the table and the spill may lie in
// global memory); noise from the entry or the spill row
template <int V>
__device__ __forceinline__ void score_table(
    const float4* tab, const float* noise, const float* ll, int s_begin,
    int s_end, const Head& h, unsigned& best_key,
    unsigned& best_idx, unsigned& free_idx) {
  for (int s0 = s_begin; s0 < s_end; s0 += kScan * 32) {
    float4 s4[kScan];
    float nz[kScan], lv[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      // past the end, a slot already scored (its result is not kept)
      const int s = s0 + 32 * u < s_end ? s0 + 32 * u : s_begin;
      s4[u] = tab[s];
      nz[u] = noise[s + 1];
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u)
      lv[u] = V == kInbreeding ? ll[__float_as_int(s4[u].z)] : 0.f;
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int s = s0 + 32 * u;
      const bool in = s < s_end;
      score_slot<V>(s, in && __float_as_int(s4[u].x) > 0, in, s4[u].y,
                    s4[u].z, s4[u].w, lv[u], nz[u], h, best_key, best_idx,
                    free_idx);
    }
  }
}

// The seater warp: the N dependent steps.  Slots below kRegSlots = 64 (a
// table of ordinary crowding lives there: a new table takes the first
// empty slot) are in registers, and a step's removal, scoring and update
// of them are selects with no branch.  Row j + 1's header, its new
// table's noise and its register slots' noise (and mode 5's grid values)
// are read while row j's reductions run, and its removal and the log
// counts it leaves are done at the end of step j: the producers fill the
// columns up to W_(j+1) + 1 >= hi_j + 2, which holds every register slot
// below hi_j + 2 (read whether occupied or not).  The slots from
// kRegSlots on (a crowded table) stay in the table, kScan a lane at a
// time, their columns below lim <= hi_j + 1 <= W_j + 1 read whether
// occupied or not.  Lane l keeps the seat of step j (j = l mod 32), and
// the warp stores 32 seats at a time.  Every lane arrives on the entry's
// empty barrier once a step (so no lane branches for it).
template <int V, bool kSmemTab>
__device__ __forceinline__ void seat(const CrpArgs& a, float4* tab,
                                     const float* logc, const float* ring,
                                     uint64_t* full, uint64_t* empty,
                                     int* hi_at, int hi, int c, int lane) {
  const int N = a.N;
  const int width = a.plan.width;
  const long long row0 = (long long)c * N;
  RSlot A, B;
  load_rslot(A, tab, lane, N);
  load_rslot(B, tab, lane + 32, N);
  mbar_wait(&full[0], 0u);
  Row cur = row_of(a, ring, 0);
  Head h = read_head(cur.e);
  float n0 = cur.noise[0];
  {
    const int lim = min(N, hi + 1);
    if (A.s < lim) A.nz = cur.noise[A.s + 1];
    if (B.s < lim) B.nz = cur.noise[B.s + 1];
    if (V == kInbreeding) {
      A.ll = cur.e[kHead + __float_as_int(A.z)];
      B.ll = cur.e[kHead + __float_as_int(B.z)];
    }
  }
  // step 0's removal
  if (V != kPrior) {
    A.cnt -= h.old == A.s;
    B.cnt -= h.old == B.s;
    if (__builtin_expect(h.old >= kRegSlots, 0) && (h.old & 31) == lane)
      table_move<V>(tab, logc, h.old, -1, false, h);
  }
  float yA = logc[A.cnt], yB = logc[B.cnt];
  int seats = 0;   // lane l: the seat of step j = l mod 32
  for (int j = 0; j < N; ++j) {
    const int r = j & (kDepth - 1);
    const int lim = min(N, hi + 1);
    unsigned best_key = lane == 0 ? order_key(h.log_new + n0) : 0u;
    unsigned best_idx = lane == 0 ? 0u : kNone;
    unsigned free_idx = kNone;
    score_slot<V>(A.s, A.s < lim && A.cnt > 0, A.s < lim, yA, A.z, A.w,
                  A.ll, A.nz, h, best_key, best_idx, free_idx);
    score_slot<V>(B.s, B.s < lim && B.cnt > 0, B.s < lim, yB, B.z, B.w,
                  B.ll, B.nz, h, best_key, best_idx, free_idx);
    if (__builtin_expect(lim > kRegSlots, 0)) {
      // a crowded table: columns below the ring's width from the entry,
      // the rest from the spill row
      const float* ll = cur.e + kHead;
      const int ring_end = min(lim, width - 1);
      score_table<V>(tab, cur.noise, ll, kRegSlots + lane, ring_end,
                           h, best_key, best_idx, free_idx);
      if (lim > ring_end) {
        const int s_begin = kRegSlots + lane +
                            ((ring_end - kRegSlots - lane + 31) & ~31);
        score_table<V>(tab, spill_of(a, c, j), ll, s_begin, lim, h,
                              best_key, best_idx, free_idx);
      }
    }
    // row j + 1, read while the reductions run
    Head hn = h;
    float n0n = 0.f, nA = 0.f, nB = 0.f;
    float lA = A.ll, lB = B.ll;
    Row nxt = cur;
    if (j + 1 < N) {
      mbar_wait(&full[(j + 1) & (kDepth - 1)],
                ((unsigned)(j + 1) / kDepth) & 1u);
      nxt = row_of(a, ring, j + 1);
      hn = read_head(nxt.e);
      n0n = nxt.noise[0];
      const int pre = min(N, hi + 2);
      if (A.s < pre) nA = nxt.noise[A.s + 1];
      if (B.s < pre) nB = nxt.noise[B.s + 1];
      if (V == kInbreeding) {
        lA = nxt.e[kHead + __float_as_int(A.z)];
        lB = nxt.e[kHead + __float_as_int(B.z)];
      }
    }
    const unsigned wkey = __reduce_max_sync(kFull, best_key);
    const unsigned choice =
        __reduce_min_sync(kFull, best_key == wkey ? best_idx : kNone);
    const unsigned free_slot = __reduce_min_sync(kFull, free_idx);
    const bool is_new = choice == 0u;
    const int slot = is_new ? (int)free_slot : (int)choice - 1;
    hi = max(hi, slot + 1);
    // every lane's reads of row j are done (each lane's arrive orders its
    // own): free its entry, with hi at the start of step j + 1
    hi_at[r] = hi;
    mbar_arrive(&empty[r]);
    // the seat, and every 32 steps the warp's 32 seats
    seats = lane == (j & 31) ? slot : seats;
    if ((j & 31) == 31 || j + 1 == N) {
      if (lane <= (j & 31)) a.assign_out[row0 + (j & ~31) + lane] = seats;
    }
    if (is_new && (slot & 31) == lane) a.values_out[row0 + slot] = h.new_val;
    // the seat, then step j + 1's removal and the log counts it leaves
    const bool uA = slot == A.s, uB = slot == B.s;
    const bool newA = is_new && uA, newB = is_new && uB;
    if (V == kSelfing) {
      A.z = newA ? h.lv : A.z;
      A.w = newA ? h.l1v : A.w;
      B.z = newB ? h.lv : B.z;
      B.w = newB ? h.l1v : B.w;
    } else if (V == kInbreeding) {
      const float idx = __int_as_float(h.new_idx);
      A.z = newA ? idx : A.z;
      B.z = newB ? idx : B.z;
      if (j + 1 < N && is_new) {
        const float lnew = nxt.e[kHead + h.new_idx];
        lA = newA ? lnew : lA;
        lB = newB ? lnew : lB;
      }
    }
    if (__builtin_expect(slot >= kRegSlots, 0) && (slot & 31) == lane)
      table_move<V>(tab, logc, slot, 1, is_new, h);
    const bool last = j + 1 == N;
    const int oldn = V != kPrior && !last ? hn.old : -1;
    A.cnt += (int)uA - (int)(oldn == A.s);
    B.cnt += (int)uB - (int)(oldn == B.s);
    if (__builtin_expect(oldn >= kRegSlots, 0) && (oldn & 31) == lane)
      table_move<V>(tab, logc, oldn, -1, false, hn);
    yA = logc[A.cnt];
    yB = logc[B.cnt];
    A.nz = nA;
    B.nz = nB;
    A.ll = lA;
    B.ll = lB;
    h = hn;
    n0 = n0n;
    cur = nxt;
  }
  if (A.s < N) tab[A.s] = make_float4(__int_as_float(A.cnt), yA, A.z, A.w);
  if (B.s < N) tab[B.s] = make_float4(__int_as_float(B.cnt), yB, B.z, B.w);
}

template <int V, bool kSmemTab>
__global__ void __launch_bounds__(kThreads, 1) crp_kernel(const CrpArgs a) {
  // [table (N <= kSmemSlots)][logc][ring: kDepth entries]
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[kDepth], empty[kDepth];
  __shared__ int hi_at[kDepth];
  __shared__ unsigned red[kWarps];
  const int c = blockIdx.x;
  const int N = a.N;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)c * N;
  float4* tab = kSmemTab ? reinterpret_cast<float4*>(smem) : a.scratch + row0;
  float* logc = smem + a.plan.table_bytes / 4;
  float* ring = logc + a.plan.logc_words;
  const uint32_t chain = (uint32_t)a.chain_key[c];

  for (int k = tid; k <= N; k += kThreads) logc[k] = slog((float)k);
  if (tid < kDepth) {
    mbar_init(&full[tid], 32);
    mbar_init(&empty[tid], 32);
  }
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
  top = __reduce_max_sync(kFull, top);
  if (lane == 0) red[warp] = top;
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  // every occupied slot lies below hi (it only rises): a step scores the
  // slots below hi + 1, which hold the first empty slot
  const int hi0 =
      (int)__reduce_max_sync(kFull, lane < kWarps ? red[lane] : 0u);
  if (warp == 0)
    seat<V, kSmemTab>(a, tab, logc, ring, full, empty, hi_at, hi0, c, lane);
  else
    produce<V>(a, ring, full, empty, hi_at, hi0, chain, c, warp - 1, lane);
  __syncthreads();
  for (int s = tid; s < N; s += kThreads)
    a.counts_out[row0 + s] = __float_as_int(tab[s].x);
}

template <int V, bool kSmemTab>
int launch_body(const CrpArgs& a, int C, cudaStream_t stream) {
  // the opt-in above 48 KB holds for the current device only, so it is set
  // at every launch (a cheap call)
  const cudaError_t err = cudaFuncSetAttribute(
      crp_kernel<V, kSmemTab>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.plan.smem);
  if (err != cudaSuccess) return (int)err;
  crp_kernel<V, kSmemTab><<<C, kThreads, a.plan.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the table in shared memory or in the scratch row
template <int V>
int launch_variant(const CrpArgs& a, int C, cudaStream_t stream) {
  return a.plan.table_bytes > 0 ? launch_body<V, true>(a, C, stream)
                                : launch_body<V, false>(a, C, stream);
}

// The floor: 32 rows of 32 words, word s of a row owned by lane s; a step
// reads its row, takes the maximum and the least lane holding it, the
// winner rewrites its word, and the next row depends on both
__global__ void crp_warp_floor_kernel(const unsigned* __restrict__ x,
                                      unsigned* __restrict__ out, int N) {
  __shared__ unsigned buf[32 * 32];
  const int c = blockIdx.x, lane = threadIdx.x;
  for (int s = lane; s < 32 * 32; s += 32) buf[s] = x[c * 1024 + s];
  unsigned row = 0u;
  for (int j = 0; j < N; ++j) {
    const unsigned v = buf[row * 32 + lane];
    const unsigned m = __reduce_max_sync(kFull, v);
    const unsigned win = __reduce_min_sync(kFull, v == m ? (unsigned)lane : 32u);
    if ((unsigned)lane == win) buf[row * 32 + lane] = v * 1664525u + 1013904223u;
    row = (m + win) & 31u;
  }
  __syncwarp();
  for (int s = lane; s < 32 * 32; s += 32) out[c * 1025 + s] = buf[s];
  if (lane == 0) out[c * 1025 + 1024] = row;
}

}  // namespace

extern "C" int crp_sweep_launch(
    const float* values_in, const int* counts_in, const int* assign_in,
    const float* log_new, const float* new_val, const int* new_idx,
    const int* gen, const float* ll_grid, float* values_out, int* counts_out,
    int* assign_out, void* scratch, void* spill, int C, int N, int M,
    int variant, unsigned k0, unsigned k1, const int* chain_key,
    unsigned step, cudaStream_t stream) {
  if (C < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (variant == kInbreeding && (M < 1 || M > kMaxGrid))
    return (int)cudaErrorInvalidValue;
  if (N > kSmemSlots && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(N, M, variant);
  if (plan.width < 1 || (plan.width <= N && spill == nullptr))
    return (int)cudaErrorInvalidValue;
  CrpArgs a{values_in, counts_in, assign_in, log_new, new_val, new_idx, gen,
            ll_grid, values_out, counts_out, assign_out, (float4*)scratch,
            (float*)spill, N, M, k0, k1, step, chain_key, plan};
  switch (variant) {
    case kPrior: return launch_variant<kPrior>(a, C, stream);
    case kSelfing: return launch_variant<kSelfing>(a, C, stream);
    case kInbreeding: return launch_variant<kInbreeding>(a, C, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch plan (kernels/crp.py:crp_plan, which the card checks against
// this): out = (warps, ring depth, register slots, ring width, entry
// words, table in shared memory, dynamic shared-memory bytes)
extern "C" int crp_sweep_plan(int N, int M, int variant, int* out) {
  const Plan p = make_plan(N, M, variant);
  out[0] = kWarps;
  out[1] = kDepth;
  out[2] = kRegSlots;
  out[3] = p.width;
  out[4] = p.stride;
  out[5] = p.table_bytes > 0 ? 1 : 0;
  out[6] = p.smem;
  return 0;
}


extern "C" int crp_warp_floor_launch(const unsigned* x, unsigned* out, int C,
                                     int N, cudaStream_t stream) {
  if (C < 1 || N < 0) return (int)cudaErrorInvalidValue;
  crp_warp_floor_kernel<<<C, 32, 0, stream>>>(x, out, N);
  return (int)cudaGetLastError();
}
