// The small-D loop at 8 padded coordinates in the wide-signal mode,
// 3xTF32 (float32 tiers).
#define KMB_DP 8
#define KMB_BF16 0
#define KMB_SMALL_D_WIDE_LAUNCH small_d_wide_8_tf32_launch
#include "small_d_wide.cuh"
