// The small-D loop at 8 padded coordinates, flash scheme.
#define KMB_DP 8
#define KMB_FLASH 1
#define KMB_SMALL_D_LAUNCH small_d_8_flash_launch
#include "small_d.cuh"
