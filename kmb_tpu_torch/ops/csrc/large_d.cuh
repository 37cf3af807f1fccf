// Large-D tile (D > 8) of the streaming kernel product: the form product on
// the tensor cores with wgmma, the rest of the pair's work on the
// accumulator fragments, in registers.  Included by large_d_tf32.cu
// (KMB_BF16 0) and large_d_bf16.cu (KMB_BF16 1), one object file each, so
// the two build in parallel.
//
// Form product.  A block owns 128 target rows, two warpgroups of 64, and
// walks its split's source points in tiles of 128.  Each warpgroup keeps a
// 64 x 128 f32 accumulator over the whole of D (wgmma m64n128, 64 registers
// a thread).  The points are staged in chunks of 128 bytes per row by
// cp.async, four stages deep (two chunks in flight, across tile ends too):
// x rows padded to 36 words, read into registers with ldmatrix
// (conflict-free) as wgmma's A operand; y in wgmma's no-swizzle K-major
// layout (8-row x 16-byte core matrices), read by wgmma from shared memory
// through a descriptor as its B operand.  Each chunk's wgmma group runs on
// while the block waits for the next chunk, splits it and issues the loads
// after it; it is waited for just before the next A fragments are loaded
// (and before the tile's epilogue, when it ended a tile).
//   float32 / float32x3 tiers: 3xTF32.  Each staged f32 value is split into
//     TF32 parts, v = hi + lo (tf32_split in ops/product.py is the same
//     split in PyTorch): x in registers, y in shared memory (hi in place, lo
//     beside it, one pass per chunk).  wgmma m64n128k8.tf32 then sums
//     lo.hi + hi.lo + hi.hi in f32: the products of TF32 parts are exact, so
//     the result is f32-accurate (one TF32 pass keeps about three decimal
//     digits, and the squared-distance form cancels).
//   bfloat16 tier: the wrapper passes bf16 points; one wgmma
//     m64n128k16.bf16 pass with f32 accumulation, as kmb_tpu's bf16 tier
//     does.
//
// Epilogue, per tile, on the fragments: complete the form with the norms
// the wrapper computed once (2<x, y> - |x|^2 - |y|^2, clamped where the map
// needs it), apply the map with the MUFU approximations, mask (only tiles
// that hold the ragged end or the diagonal take the masked path), and
// accumulate the signal columns with FFMAs from a staged b tile.  Signal
// products stay on the FP32 units in every tier: a TF32 product would round
// each weight.  The direct scheme sums per thread and merges the quad (the
// four lanes of a row) with shuffles once, after the last tile.  The flash
// scheme keeps the FlashAttention-2 order: the tile's row max from the
// fragment and two quad shuffles, one rescale per row per tile, then exp2
// of every logit against the new max; no branch per pair.
//
// What bounds it on an H100: at D = 784 the tensor cores (3 passes of
// 2 N M D flops at 495 TFLOP/s for TF32) and the staged bytes, (128 + 128)
// rows x D x 4 per pair of tiles (x 2 in bf16), from L2; at D = 64 the
// tensor cores and the exp2 of every pair about equally.

#include "common.cuh"

#ifndef KMB_BF16
#error "define KMB_BF16 to 0 (3xTF32) or 1 (bf16)"
#endif

namespace kmb {
namespace {

constexpr bool kBf16 = KMB_BF16;
constexpr int kThreads = 256;              // two warpgroups
constexpr int kRows = 128;                 // target rows per block
constexpr int kCols = 128;                 // source points per tile (wgmma N)
constexpr int kChunk = 32;                 // 32-bit words per row per staged chunk
constexpr int kPieces = kChunk / 4;        // 16-byte cp.async pieces per row
constexpr int kStride = kChunk + 4;        // padded x row, in words
constexpr int kXWords = kRows * kStride;   // staged x chunk
constexpr int kYWords = kCols * kChunk;    // staged y chunk, core-matrix layout
// A stage: x, y (TF32 hi parts in place), and in 3xTF32 y's TF32 lo parts.
constexpr int kStageWords = kXWords + (kBf16 ? 1 : 2) * kYWords;
constexpr int kStages = 4;
// Loads run kAhead steps ahead; the stage they overwrite was last read by
// the wgmma of step s - 2, which has finished: steps s - 1 (its wgmma may
// still run), s and s + 1 keep theirs.
constexpr int kAhead = 2;

template <int NC>
__host__ __device__ constexpr int tile_buf_words() { return kCols * (1 + NC); }  // |y|^2, signal

template <int NC>
__host__ __device__ constexpr int smem_bytes() {
  // Staged chunks, then a ring of per-tile |y|^2 and signal buffers.
  return (kStages * kStageWords + kStages * tile_buf_words<NC>()) * 4;
}

// Word offset of (row r, word k) of a staged y chunk: 8-row x 16-byte core
// matrices, the 8 of one row group side by side along K (128 bytes apart,
// the descriptor's leading byte offset), row groups 1024 bytes apart (its
// stride byte offset).
__device__ __forceinline__ int y_word(int r, int k) {
  return (r / 8) * (8 * kChunk) + (k / 4) * 32 + (r % 8) * 4 + k % 4;
}

// x rounded to TF32 (10 mantissa bits, ties away from zero), as an f32
// value: the tf32_split of kmb_tpu_torch/ops/product.py.
__device__ __forceinline__ unsigned tf32_hi(unsigned bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ unsigned tf32_lo(unsigned bits, unsigned hi) {
  return tf32_hi(__float_as_uint(__uint_as_float(bits) - __uint_as_float(hi)));
}

// ---- PTX wrappers -------------------------------------------------------------

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

// Four 8 x 8 b16 matrices (8 x 4 words) from shared memory: lane l gives
// the address of row l % 8 of matrix l / 8 and receives, from each matrix
// in turn, the word at (row l / 4, word l % 4): wgmma's register A fragment
// for the warp's 16 rows, (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
// with g = lane / 4, t = lane % 4 (tf32: one value a word, k = 8; bf16:
// two, k = 16).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&v)[4], const unsigned* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(smem_addr(row)));
}

// The shared-memory descriptor of a y chunk at K step ks (two core
// matrices along K): start address, leading byte offset 128 (along K),
// stride byte offset 1024 (along N), no swizzle; each field in 16 bytes.
__device__ __forceinline__ unsigned long long y_desc(const unsigned* y_chunk, int ks) {
  const unsigned addr = smem_addr(y_chunk + ks * 64);
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | (8ull << 16) | (64ull << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from touching the accumulator, or reusing the A
// registers, inside the asynchronous wgmma window.
__device__ __forceinline__ void fence_acc(float (&d)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+f"(d[j][k])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(unsigned (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(r[i][k])::"memory");
}

// D (64 x 128, f32) += A (64 x k, registers) B (k x 128, shared, K-major).
// Accumulator fragment: d[j] holds rows g and g + 8 of the warp's 16,
// columns 8j + 2t and 8j + 2t + 1.
__device__ __forceinline__ void wgmma(float (&d)[16][4], const unsigned (&a)[4],
                                      unsigned long long b) {
  if constexpr (kBf16) {
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

// ---- the kernel ---------------------------------------------------------------

template <int K, int NC, bool FLASH, bool DEN, bool RND>
struct LargeD {
  using Map = KernelMap<K>;
  using State = RowState<NC, FLASH, DEN, RND>;

  // Stage chunk kw (word offset) of target rows [row0, row0 + 128) and
  // source points [j0, j0 + 128); with `tile`, also the tile's |y|^2 and
  // signal.  Rows past the end, and words past the row's last (a ragged
  // last chunk), are zero-filled: zero coordinates change no form.
  static __device__ __forceinline__ void load(unsigned* stage, float* tile_buf, const Args& a,
                                              int row0, int j0, int end, int kw, bool tile) {
    const unsigned* x = static_cast<const unsigned*>(a.x);
    const unsigned* y = static_cast<const unsigned*>(a.y);
#pragma unroll
    for (int h = 0; h < kRows * kPieces / kThreads; ++h) {
      const int idx = h * kThreads + threadIdx.x;
      const int r = idx / kPieces, q = idx % kPieces;  // row, 16-byte piece
      const bool kin = kw + q * 4 < a.words;
      const bool xv = kin && row0 + r < a.n, yv = kin && j0 + r < end;
      cp_async16(stage + r * kStride + q * 4,
                 x + (size_t)(xv ? row0 + r : 0) * a.words + kw + q * 4, xv);
      cp_async16(stage + kXWords + y_word(r, q * 4),
                 y + (size_t)(yv ? j0 + r : 0) * a.words + kw + q * 4, yv);
    }
    if (tile) {
      float* ysq = tile_buf;
      float* bt = tile_buf + kCols;
      const int c = threadIdx.x % kCols;
      const int j = j0 + c;
      const bool valid = j < end;
      const size_t jr = valid ? j : 0;
      if (threadIdx.x < kCols) {
        if constexpr (!Map::kDot) cp_async_small<4>(ysq + c, a.ysq + jr, valid);
      } else if constexpr (NC <= 4) {
        cp_async_small<NC * 4>(bt + c * NC, a.b + jr * NC, valid);
      } else {
#pragma unroll
        for (int q = 0; q < NC / 4; ++q) cp_async16(bt + c * NC + 4 * q, a.b + jr * NC + 4 * q, valid);
      }
    }
  }

  // 3xTF32: split a landed y chunk into TF32 parts, hi in place, lo after it.
  static __device__ __forceinline__ void split_y(unsigned* y_chunk) {
    unsigned* y_lo = y_chunk + kYWords;
#pragma unroll
    for (int h = 0; h < kYWords / kThreads; ++h) {
      const int i = h * kThreads + threadIdx.x;
      const unsigned v = y_chunk[i], hi = tf32_hi(v);
      y_chunk[i] = hi;
      y_lo[i] = tf32_lo(v, hi);
    }
  }

  static constexpr int kSteps = kChunk / 8;  // K steps of 8 words (tf32: k8, bf16: k16)

  // The warp's 16 rows of this chunk's x, as wgmma A fragments (and their
  // TF32 lo parts in 3xTF32).
  static __device__ __forceinline__ void load_a(const unsigned* stage, unsigned (&ah)[kSteps][4],
                                                unsigned (&al)[kSteps][4], int wrow, int lane) {
    const int r8 = lane % 8, q = lane / 8;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      // Matrices: rows 0-7 / 8-15 (q % 2) of words 0-3 / 4-7 (q / 2).
      unsigned v[4];
      ldmatrix_x4(v, stage + (wrow + (q % 2) * 8 + r8) * kStride + ks * 8 + (q / 2) * 4);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ah[ks][k] = kBf16 ? v[k] : tf32_hi(v[k]);
        if constexpr (!kBf16) al[ks][k] = tf32_lo(v[k], ah[ks][k]);
      }
    }
  }

  // Start acc += this chunk's 64 x 128 block of <x, y> for the warpgroup
  // (x from registers, y from shared memory; in 3xTF32 the small terms
  // first), as one wgmma group; it runs on while the caller goes on.
  static __device__ __forceinline__ void multiply(const unsigned* stage, unsigned (&ah)[kSteps][4],
                                                  unsigned (&al)[kSteps][4], float (&acc)[16][4]) {
    const unsigned* y_hi = stage + kXWords;
    const unsigned* y_lo = y_hi + kYWords;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if constexpr (!kBf16) {
        wgmma(acc, al[ks], y_desc(y_hi, ks));
        wgmma(acc, ah[ks], y_desc(y_lo, ks));
      }
      wgmma(acc, ah[ks], y_desc(y_hi, ks));
    }
    wgmma_commit();
  }

  // Wait for the running wgmma group; then acc and the A registers are free.
  static __device__ __forceinline__ void settle(unsigned (&ah)[kSteps][4],
                                                unsigned (&al)[kSteps][4], float (&acc)[16][4]) {
    wgmma_wait_all();
    fence_acc(acc);
    fence_regs(ah);
    if constexpr (!kBf16) fence_regs(al);
  }

  // The signed, scaled form from <x, y> and the norms; clamped where the
  // map takes only g >= 0.
  static __device__ __forceinline__ float form(float dot, float xq, float yq) {
    if constexpr (Map::kDot) {
      return dot;
    } else if constexpr (Map::kNegate) {
      return fmaf(2.f, dot, -(xq + yq));
    } else {
      const float g = fmaf(-2.f, dot, xq + yq);
      return Map::kClamp ? fmaxf(g, 0.f) : g;
    }
  }

  // Fold one tile's accumulator into the row states.  The thread's rows h
  // are the warp's rows g and g + 8; its columns are 8j + 2t + e.  MASKED:
  // the tile holds the split's ragged end or the diagonal.
  template <bool MASKED>
  static __device__ __forceinline__ void epilogue(float (&acc)[16][4], State (&st)[2],
                                                  const float (&xq)[2], const float* tile_buf,
                                                  int j0, int end, const int (&diag_col)[2],
                                                  int t) {
    const float* ysq = tile_buf;
    const float* bt = tile_buf + kCols;
    // Forms (flash: logits) in place.
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c0 = j * 8 + 2 * t;
      float yq[2] = {0.f, 0.f};
      if constexpr (!Map::kDot) load_vec<2>(ysq + c0, yq);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = acc[j][2 * h + e];
          v = form(v, xq[h], yq[e]);
          if constexpr (FLASH) v = Map::logit(v);
          if constexpr (MASKED) {
            const int col = j0 + c0 + e;
            if (col >= end || col == diag_col[h]) v = FLASH ? kNegInf : 0.f;
          }
        }
    }
    if constexpr (FLASH) {
      // The tile's row max over the quad (the four lanes of a row), then one
      // rescale per row.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(acc[j][2 * h], acc[j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
        if (mx > st[h].m) st[h].rescale(mx);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c0 = j * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float bj[NC];
        load_vec<NC>(bt + (c0 + e) * NC, bj);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = acc[j][2 * h + e];
          if constexpr (FLASH) {
            float p = ex2(v - st[h].m);
            // A masked logit of a row with no valid column yet would give
            // exp2(0) = 1.
            if constexpr (MASKED) p = v == kNegInf ? 0.f : p;
            st[h].add_weight(p, bj);
          } else {
            float w = Map::value(v);
            if constexpr (MASKED) {
              const int col = j0 + c0 + e;
              if (col >= end || col == diag_col[h]) w = 0.f;
            }
            st[h].add_value(w, bj);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) st[h].end_tile();
  }
};

template <int K, int NC, bool FLASH, bool DEN, bool RND>
__global__ void __launch_bounds__(kThreads, 1) large_d_kernel(const Args a) {
  using L = LargeD<K, NC, FLASH, DEN, RND>;
  extern __shared__ __align__(128) unsigned smem[];
  unsigned* stages = smem;
  float* tile_bufs = reinterpret_cast<float*>(smem + kStages * kStageWords);
  constexpr int kTileBuf = tile_buf_words<NC>();

  const Split<kCols> split(a);
  const int row0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = warp * 16;  // the warp's rows: warpgroup warp / 4, 16 each
  const int g = lane / 4, t = lane % 4;

  float xq[2];
  int diag_col[2];  // local source column on the global diagonal, or -1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + wrow + h * 8 + g;
    xq[h] = (!L::Map::kDot && i < a.n) ? a.xsq[i] : 0.f;
    const long long jd = (long long)i + a.shift;
    diag_col[h] = (a.diag && jd >= 0 && jd < a.m_eff) ? (int)jd : -1;
  }
  // The block's diagonal runs through source columns [dlo, dhi).
  const long long dlo = (long long)row0 + a.shift, dhi = dlo + kRows;

  typename L::State st[2];
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
  unsigned ah[L::kSteps][4], al[L::kSteps][4];

  const int chunks = (a.words + kChunk - 1) / kChunk;
  const int tiles = (split.end - split.begin + kCols - 1) / kCols;
  const int steps = tiles * chunks;
  // Step q is chunk q % chunks of tile q / chunks, staged in stage
  // q % kStages; tile t's |y|^2 and signal go to tile buffer t % kStages
  // with its first chunk.
  auto issue = [&](int q) {
    if (q < steps) {
      const int qt = q / chunks, qc = q % chunks;
      L::load(stages + (q % kStages) * kStageWords, tile_bufs + (qt % kStages) * kTileBuf, a,
              row0, split.begin + qt * kCols, split.end, qc * kChunk, qc == 0);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  // The epilogue of a tile runs once its last wgmma group has finished:
  // at the next step, or after the loop.
  int done_tile = -1;
  auto epilogue = [&]() {
    const int j0 = split.begin + done_tile * kCols;
    const float* tb = tile_bufs + (done_tile % kStages) * kTileBuf;
    const bool masked = j0 + kCols > split.end || (a.diag && j0 < dhi && j0 + kCols > dlo);
    if (masked) {
      L::template epilogue<true>(acc, st, xq, tb, j0, split.end, diag_col, t);
    } else {
      L::template epilogue<false>(acc, st, xq, tb, j0, split.end, diag_col, t);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
    done_tile = -1;
  };
#pragma unroll
  for (int q = 0; q < kAhead; ++q) issue(q);
  int tile = 0, chunk = 0;
  for (int s = 0; s < steps; ++s) {
    unsigned* stage = stages + (s % kStages) * kStageWords;
    cp_async_wait<kAhead - 1>();  // step s has landed (for this thread)
    fence_async_shared();
    __syncthreads();              // ... for all
    if constexpr (!kBf16) {
      L::split_y(stage + kXWords);
      fence_async_shared();
      __syncthreads();
    }
    issue(s + kAhead);
    L::settle(ah, al, acc);  // step s - 1's wgmma group
    if (done_tile >= 0) epilogue();
    L::load_a(stage, ah, al, wrow, lane);
    L::multiply(stage, ah, al, acc);
    if (++chunk == chunks) {
      done_tile = tile++;
      chunk = 0;
    }
  }
  L::settle(ah, al, acc);
  if (done_tile >= 0) epilogue();
  cp_async_wait<0>();

  // Merge the quad (the lanes of a row) and store.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st[h].sum_lanes(4);
    const int i = row0 + wrow + h * 8 + g;
    if (t == 0 && i < a.n) st[h].store(a, i, i < a.n_ok);
  }
}

// Runtime shape -> instantiation.
template <int K, int NC, bool FLASH, bool DEN>
void fill(Launch* out) {
  out->fn = reinterpret_cast<const void*>(&large_d_kernel<K, NC, FLASH, DEN, kBf16>);
  out->threads = kThreads;
  out->smem = smem_bytes<NC>();
  out->rows = kRows;
}

template <int K, int NC>
bool pick_scheme(const Shape& s, Launch* out) {
  if (s.flash) {
    if constexpr (K == kInverseDistance) {
      return false;  // only kernels with a log form run the flash scheme
    } else {
      fill<K, NC, true, false>(out);
      return true;
    }
  }
  if (s.den) fill<K, NC, false, true>(out); else fill<K, NC, false, false>(out);
  return true;
}

template <int K>
bool pick_nc(const Shape& s, Launch* out) {
  switch (s.nc) {
    case 1: return pick_scheme<K, 1>(s, out);
    case 2: return pick_scheme<K, 2>(s, out);
    case 4: return pick_scheme<K, 4>(s, out);
    case 8: return pick_scheme<K, 8>(s, out);
    default: return false;  // the wrapper pads the signal to 1, 2, 4 or 8
  }
}

}  // namespace

#if KMB_BF16
bool large_d_bf16_launch(const Shape& s, Launch* out) {
#else
bool large_d_tf32_launch(const Shape& s, Launch* out) {
#endif
  if (s.d <= 0 || s.d % 4 != 0) return false;  // the wrapper pads rows to 16 bytes
  switch (s.kernel) {
    case kGaussian: return pick_nc<kGaussian>(s, out);
    case kAbsExp: return pick_nc<kAbsExp>(s, out);
    case kInverseDistance: return pick_nc<kInverseDistance>(s, out);
    case kExponential: return pick_nc<kExponential>(s, out);
    default: return false;
  }
}

}  // namespace kmb
