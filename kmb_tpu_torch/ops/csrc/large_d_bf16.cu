// The large-D tile in its bf16 form (bfloat16 tier).
#define KMB_BF16 1
#include "large_d.cuh"
