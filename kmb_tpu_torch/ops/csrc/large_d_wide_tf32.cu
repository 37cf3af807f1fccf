// The large-D tile in the wide-signal mode, 3xTF32 (float32 tiers).
#define KMB_BF16 0
#include "large_d_wide.cuh"
