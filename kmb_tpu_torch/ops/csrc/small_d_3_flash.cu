// The small-D loop at 3 padded coordinates, flash scheme.
#define KMB_DP 3
#define KMB_FLASH 1
#define KMB_SMALL_D_LAUNCH small_d_3_flash_launch
#include "small_d.cuh"
