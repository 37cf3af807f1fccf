// The small-D loop at 3 padded coordinates, direct scheme.
#define KMB_DP 3
#define KMB_FLASH 0
#define KMB_SMALL_D_LAUNCH small_d_3_direct_launch
#include "small_d.cuh"
