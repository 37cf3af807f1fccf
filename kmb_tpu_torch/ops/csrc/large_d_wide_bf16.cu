// The large-D tile in the wide-signal mode, one bf16 pass (bfloat16 tier).
#define KMB_BF16 1
#include "large_d_wide.cuh"
