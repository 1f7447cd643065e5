// The per-site pass, packed biallelic plane, stored-step passes: one of the
// four instantiations of site_pass.cuh (which says what the kernel
// replaces, what bounds it and how it is designed).
#define SITE_PACKED 1
#define SITE_SAMPLE 0
#define SITE_LAUNCH site_packed_eval_launch
#include "site_pass.cuh"
