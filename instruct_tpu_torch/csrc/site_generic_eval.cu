// The per-site pass, generic path (allele codes, any A), stored-step passes:
// one of the four instantiations of site_pass.cuh (which says what the
// kernel replaces, what bounds it and how it is designed).
#define SITE_PACKED 0
#define SITE_SAMPLE 0
#define SITE_LAUNCH site_generic_eval_launch
#include "site_pass.cuh"
