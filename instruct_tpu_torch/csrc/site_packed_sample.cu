// The per-site pass, packed biallelic plane, sampling passes: one of the four
// instantiations of site_pass.cuh (which says what the kernel replaces, what
// bounds it and how it is designed).
#define SITE_PACKED 1
#define SITE_SAMPLE 1
#define SITE_LAUNCH site_packed_sample_launch
#include "site_pass.cuh"

// Locus tiles per row: the wrappers size the tile partials [C, N, T, cols]
// and the tickets with it.
extern "C" int site_pass_tiles(int L) { return site_tiles(L); }

// Row strips S of a call over N individuals: strips of kStripRows rows, at
// most kMaxStrips of them (and at most kMaxStripRows rows each, the reach of
// the half-word counts), none empty.  The wrappers size the strip counts
// [C, S, K, L] and the tickets with it.
extern "C" int site_pass_strips(int N) {
  int s = (N + kStripRows - 1) / kStripRows;
  s = min(s, kMaxStrips);
  s = max(s, (N + kMaxStripRows - 1) / kMaxStripRows);
  s = max(s, 1);
  const int rows = (N + s - 1) / s;
  return (N + rows - 1) / rows;
}
