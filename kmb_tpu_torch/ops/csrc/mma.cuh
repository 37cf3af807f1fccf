// PTX wrappers shared by the tensor-core kernels (sm_90a): cp.async
// staging, the proxy and wgmma fences, wgmma groups, ldmatrix, and the TF32
// split.
// large_d.cuh (the form product) and wide.cuh (the signal product of the
// wide mode) build on them.
#pragma once

#include "common.cuh"

namespace kmb {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's shared-memory writes visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching an accumulator, or reusing A registers,
// inside the asynchronous wgmma window.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R][4]) {
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+f"(d[j][k])::"memory");
}
__device__ __forceinline__ void fence_regs(unsigned (&r)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(r[k])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(unsigned (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(r[i]);
}

// Four 8 x 8 b16 matrices (8 x 4 words) from shared memory: lane l gives
// the address of row l % 8 of matrix l / 8 and receives, from each matrix
// in turn, the word at (row l / 4, word l % 4): wgmma's register A fragment
// for the warp's 16 rows, (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
// with g = lane / 4, t = lane % 4 (tf32: one value a word, k = 8; bf16:
// two, k = 16).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&v)[4], const unsigned* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(smem_addr(row))
               : "memory");
}

// x rounded to TF32 (10 mantissa bits, ties away from zero), as an f32
// value: the tf32_split of kmb_tpu_torch/ops/product.py.
__device__ __forceinline__ unsigned tf32_hi(unsigned bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ unsigned tf32_lo(unsigned bits, unsigned hi) {
  return tf32_hi(__float_as_uint(__uint_as_float(bits) - __uint_as_float(hi)));
}

}  // namespace kmb
