// The small-D loop at 8 padded coordinates in the wide-signal mode,
// one bf16 pass (bfloat16 tier).
#define KMB_DP 8
#define KMB_BF16 1
#define KMB_SMALL_D_WIDE_LAUNCH small_d_wide_8_bf16_launch
#include "small_d_wide.cuh"
