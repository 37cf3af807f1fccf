// PTX wrappers shared by the tensor-core kernels (sm_90a): cp.async
// staging, the proxy and wgmma fences, wgmma groups with A from registers
// (wgmma_rs) or shared memory (wgmma_ss_tf32), ldmatrix, and the TF32 split.
// large_d.cuh and large_d_wide.cuh (the form product) and wide.cuh (the
// signal product of the wide mode) build on them.
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

// The descriptor of k step s (32 bytes of K: 8 tf32 or 16 bf16 values) of
// a K-major operand that TMA staged with the 128-byte swizzle: boxes of
// `rows` rows x 128 bytes of K (row r at 128 r, its 16-byte piece c at
// piece c ^ (r % 8)), side by side along K, each 1024-byte aligned.  Step s
// lies in box s / 4 at byte 32 (s % 4) of each row; 8-row groups are 1024
// bytes apart (the stride byte offset); the leading byte offset is unused
// with this swizzle; layout type 1 is the 128-byte swizzle.
__device__ __forceinline__ unsigned long long sw128_desc(unsigned base, int rows, int s) {
  const unsigned addr = base + (s / 4) * rows * 128 + (s % 4) * 32;
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}
__device__ __forceinline__ unsigned long long sw128_desc(const void* base, int rows, int s) {
  return sw128_desc(smem_addr(base), rows, s);
}

// D (64 x N, f32) = A (64 x k, registers) B (k x N, shared, K-major)
// + (scale_d ? D : 0); tf32: k = 8, bf16: k = 16.  The accumulator
// fragment d[j] holds rows g and g + 8 of the warp's 16, columns 8j + 2t
// and 8j + 2t + 1.
template <int N, bool BF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const unsigned (&a)[4],
                                         unsigned long long b, int scale_d) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128,
                "8, 16, 32, 64 or 128 columns");
  if constexpr (BF16) {
    if constexpr (N == 8) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "setp.ne.b32 p, %9, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
          "{"
          "%0, %1, %2, %3 "
          "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
          "}\n"
          : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
    if constexpr (N == 16) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "setp.ne.b32 p, %13, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
          "{"
          "%0, %1, %2, %3, %4, %5, %6, %7 "
          "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
          "}\n"
          : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
            "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
    if constexpr (N == 32) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "setp.ne.b32 p, %21, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
          "{"
          "%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15 "
          "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
          "}\n"
          : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
            "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
            "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
            "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
    if constexpr (N == 64) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "setp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
          "{"
          "%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31 "
          "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
          "}\n"
          : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
            "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
            "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
            "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
            "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
            "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
            "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
            "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
    if constexpr (N == 128) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "setp.ne.b32 p, %69, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
          "{"
          "%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31, "
          "%32, %33, %34, %35, %36, %37, %38, %39, "
          "%40, %41, %42, %43, %44, %45, %46, %47, "
          "%48, %49, %50, %51, %52, %53, %54, %55, "
          "%56, %57, %58, %59, %60, %61, %62, %63 "
          "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
          "}\n"
          : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
            "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
            "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
            "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
            "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
            "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
            "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
            "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
            "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
            "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
            "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
            "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
            "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
            "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
            "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
            "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
  } else {
    if constexpr (N == 8) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "setp.ne.b32 p, %9, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
          "{"
          "%0, %1, %2, %3 "
          "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n"
          "}\n"
          : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
    if constexpr (N == 16) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "setp.ne.b32 p, %13, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
          "{"
          "%0, %1, %2, %3, %4, %5, %6, %7 "
          "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
          "}\n"
          : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
            "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
    if constexpr (N == 32) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "setp.ne.b32 p, %21, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
          "{"
          "%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15 "
          "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
          "}\n"
          : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
            "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
            "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
            "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
    if constexpr (N == 64) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "setp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
          "{"
          "%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31 "
          "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
          "}\n"
          : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
            "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
            "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
            "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
            "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
            "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
            "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
            "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
    if constexpr (N == 128) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "setp.ne.b32 p, %69, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
          "{"
          "%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31, "
          "%32, %33, %34, %35, %36, %37, %38, %39, "
          "%40, %41, %42, %43, %44, %45, %46, %47, "
          "%48, %49, %50, %51, %52, %53, %54, %55, "
          "%56, %57, %58, %59, %60, %61, %62, %63 "
          "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
          "}\n"
          : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
            "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
            "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
            "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
            "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
            "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
            "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
            "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
            "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
            "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
            "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
            "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
            "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
            "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
            "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
            "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
  }
}

// D (64 x 128, f32) = A (64 x 8, shared) B (8 x 128, shared) + (scale_d ?
// D : 0), tf32, both operands K-major through descriptors (sw128_desc).
// The accumulator fragment as wgmma_rs's.
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[16][4], unsigned long long a,
                                              unsigned long long b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Four 8 x 8 b16 matrices (8 x 4 words) from shared memory: lane l gives
// the address of row l % 8 of matrix l / 8 and receives, from each matrix
// in turn, the word at (row l / 4, word l % 4): wgmma's register A fragment
// for the warp's 16 rows, (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
// with g = lane / 4, t = lane % 4 (tf32: one value a word, k = 8; bf16:
// two, k = 16).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&v)[4], unsigned row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(row)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&v)[4], const unsigned* row) {
  ldmatrix_x4(v, smem_addr(row));
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
