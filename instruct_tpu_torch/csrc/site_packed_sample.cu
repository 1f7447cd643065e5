// The per-site pass, packed biallelic plane, sampling passes: one of the four
// instantiations of site_pass.cuh (which says what the kernel replaces, what
// bounds it and how it is designed).
#define SITE_PACKED 1
#define SITE_SAMPLE 1
#define SITE_LAUNCH site_packed_sample_launch
#include "site_pass.cuh"

// Locus tiles per row: the wrappers size ll_part [C, N, T, n_out] and
// qq_part [C, N, T, K] with it.
extern "C" int site_pass_tiles(int L) { return site_tiles(L); }
