// TMA loads and mbarriers (sm_90a), shared by the large-D kernels that a
// ring of shared-memory stages feeds: large_d_wide.cuh (E > 8) and
// large_d_one_chunk.cu (rows of at most 32 words, E <= 8).  Device side:
// barrier init, arrivals and waits, and the leader's cp.async.bulk.tensor
// loads; host side: tensor maps encoded through the CUDA driver API's
// cuTensorMapEncodeTiled, found at run time (the library links only the
// CUDA runtime).
#pragma once

#include <cuda.h>

#include "mma.cuh"

namespace kmb {
namespace {

constexpr long long kHangCycles = 1ll << 34;  // a wait this long is a fault: trap

// ---- PTX: mbarriers, TMA ----------------------------------------------------

// Barriers and TMA destinations by their 32-bit shared-memory addresses.
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Single-thread operations (the TMA loads by one thread, the leader; a
// warp's arrivals by its lane 0) with the block's control flow uniform
// around them: each instruction below is predicated on `leader`, so no
// branch diverges between a warpgroup's wgmma groups (a divergent path
// there makes ptxas serialise them).
// Arrive once, from the leader.
__device__ __forceinline__ void mbar_arrive_one(unsigned bar, bool leader) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar), "r"((int)leader)
      : "memory");
}
// The leader arrives and expects `bytes` of TMA transfers in the phase.
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes, bool leader) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "}\n" ::"r"(bar), "r"(bytes), "r"((int)leader)
      : "memory");
}
// Wait for the phase of parity `parity` to complete.  A wait of kHangCycles
// means a fault of the pipeline: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  const long long start = clock64();
  while (true) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > kHangCycles) __trap();
  }
}
// The same wait with its loop inside one asm statement, so the C++ code
// around it has no branch: for waits while a wgmma group is in flight.
__device__ __forceinline__ void mbar_wait_in_flight(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, %2;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity), "l"(kHangCycles)
      : "memory");
}

// The leader's TMA load of the box at element coordinates c (rank 1 to 4,
// innermost first).
template <int RANK>
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, unsigned bar,
                                         const int (&c)[RANK], bool leader) {
  const unsigned long long desc = reinterpret_cast<unsigned long long>(map);
  if constexpr (RANK == 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
        "@p cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3}], [%2];\n}\n" ::"r"(dst),
        "l"(desc), "r"(bar), "r"(c[0]), "r"((int)leader)
        : "memory");
  } else if constexpr (RANK == 2) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
        "@p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n}\n" ::"r"(dst),
        "l"(desc), "r"(bar), "r"(c[0]), "r"(c[1]), "r"((int)leader)
        : "memory");
  } else if constexpr (RANK == 3) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "@p cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n}\n" ::"r"(dst),
        "l"(desc), "r"(bar), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"((int)leader)
        : "memory");
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %7, 0;\n"
        "@p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n}\n" ::"r"(dst),
        "l"(desc), "r"(bar), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]), "r"((int)leader)
        : "memory");
  }
}

// ---- host side ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once: the library links only
// the CUDA runtime.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of a row-major array of `rank` dimensions (innermost first, `bytes`
// an element; strides in bytes of dimensions 1 and up), read in boxes of
// `box`, out-of-bounds elements as zero.
template <int RANK>
bool encode(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* base,
            const long long (&dims)[RANK], const long long (&strides)[RANK], const int (&box)[RANK],
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr || base == nullptr) return false;
  cuuint64_t d[RANK], st[RANK];
  cuuint32_t b[RANK], elem[RANK];
  for (int i = 0; i < RANK; ++i) {
    if (dims[i] < 1) return false;
    d[i] = (cuuint64_t)dims[i];
    st[i] = (cuuint64_t)strides[i];  // st[0] is not passed: elements are contiguous
    b[i] = (cuuint32_t)box[i];
    elem[i] = 1;
  }
  (void)bytes;
  return enc(map, type, RANK, const_cast<void*>(base), d, st + 1, b, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace kmb
