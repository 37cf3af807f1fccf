// The small-D loop at 8 padded coordinates, direct scheme.
#define KMB_DP 8
#define KMB_FLASH 0
#define KMB_SMALL_D_LAUNCH small_d_8_direct_launch
#include "small_d.cuh"
