// The large-D tile in its 3xTF32 form (float32 and float32x3 tiers).
#define KMB_BF16 0
#include "large_d.cuh"
