// Large-D tile (D > 8) of the streaming kernel product: the form product on
// the tensor cores with wgmma, the rest of the pair's work on the
// accumulator fragments, in registers.  Included by large_d_tf32.cu
// (KMB_BF16 0) and large_d_bf16.cu (KMB_BF16 1), one object file each, so
// the two build in parallel.  In the float32 tiers, rows of one chunk (D <=
// 32) go to large_d_one_chunk.cu instead (product.cu, select); here they
// come in chunks of 32 words.
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
// accumulate the signal.  Up to 8 columns that is FFMAs on the FP32 units
// from a staged b tile.  (Above 8 columns the wide-signal kernel of
// large_d_wide.cuh takes the call.)  The direct scheme sums per thread and merges the quad (the
// four lanes of a row) with shuffles once, after the last tile.  The flash
// scheme keeps the FlashAttention-2 order: the tile's row max from the
// fragment and two quad shuffles, one rescale per row per tile, then exp2
// of every logit against the new max; no branch per pair.  In the bfloat16
// tier the flash kernel walks its split twice: the first pass takes each
// row's max, the second rounds every weight against it, as the plain
// version (and kmb_tpu's kernel_matvec_xla) round against the row's max;
// weights rounded against a running max land on another bf16 grid, 2-4% of
// the largest output apart where a row's outputs cancel (N = 300, M = 411,
// D = 784).
//
// What bounds it on an H100: at D = 784 the tensor cores (3 passes of
// 2 N M D flops at 495 TFLOP/s for TF32) and the staged bytes, (128 + 128)
// rows x D x 4 per pair of tiles (x 2 in bf16), from L2; at D = 64 the
// tensor cores and the exp2 of every pair about equally.

#include "large_d_epilogue.cuh"
#include "mma.cuh"

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

// ---- PTX wrappers (the shared ones are in mma.cuh) -----------------------------

// The shared-memory descriptor of a y chunk at K step ks (two core
// matrices along K): start address, leading byte offset 128 (along K),
// stride byte offset 1024 (along N), no swizzle; each field in 16 bytes.
__device__ __forceinline__ unsigned long long y_desc(const unsigned* y_chunk, int ks) {
  const unsigned addr = smem_addr(y_chunk + ks * 64);
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | (8ull << 16) | (64ull << 32);
}

// ---- the kernel ---------------------------------------------------------------

// The tile's epilogue (form, map, masks, signal) is TileEpilogue's.
template <int K, int NC, bool FLASH, bool DEN, bool RND>
struct LargeD : TileEpilogue<K, NC, FLASH, DEN, RND> {
  using Map = KernelMap<K>;
  static_assert(TileEpilogue<K, NC, FLASH, DEN, RND>::kTile == kCols, "one tile width");

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

  // Start this chunk's 64 x 128 block of <x, y> for the warpgroup (x from
  // registers, y from shared memory; in 3xTF32 the small terms first), as
  // one wgmma group; it runs on while the caller goes on.  bf16: acc +=
  // the block.  3xTF32: part = the block, from zero, which settle() adds
  // into acc on the FP32 units: the tensor cores truncate as they
  // accumulate, and one chain of three wgmmas per k step over all of D
  // left the form of equal points about 1e-5 from 0, which abs-exp's
  // square root amplified (1.0e-4 of the largest output off the plain
  // version at D = 256).
  static __device__ __forceinline__ void multiply(const unsigned* stage, unsigned (&ah)[kSteps][4],
                                                  unsigned (&al)[kSteps][4], float (&acc)[16][4],
                                                  float (&part)[16][4]) {
    const unsigned* y_hi = stage + kXWords;
    const unsigned* y_lo = y_hi + kYWords;
    if constexpr (kBf16) {
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
        wgmma_rs<kCols, kBf16>(acc, ah[ks], y_desc(y_hi, ks), 1);
    } else {
      fence_acc(part);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        wgmma_rs<kCols, kBf16>(part, al[ks], y_desc(y_hi, ks), ks > 0);
        wgmma_rs<kCols, kBf16>(part, ah[ks], y_desc(y_lo, ks), 1);
        wgmma_rs<kCols, kBf16>(part, ah[ks], y_desc(y_hi, ks), 1);
      }
    }
    wgmma_commit();
  }

  // Wait for the running wgmma group; then acc and the A registers are
  // free.  3xTF32: add the chunk's product into acc (part starts at zero,
  // so a settle with no group before it adds nothing).
  static __device__ __forceinline__ void settle(unsigned (&ah)[kSteps][4],
                                                unsigned (&al)[kSteps][4], float (&acc)[16][4],
                                                float (&part)[16][4]) {
    wgmma_wait<0>();
    fence_acc(acc);
    fence_regs(ah);
    if constexpr (!kBf16) {
      fence_regs(al);
      fence_acc(part);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] += part[j][k];
    }
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
  float acc[16][4], part[16][4];  // part: 3xTF32, a chunk's product
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = part[j][k] = 0.f;
  unsigned ah[L::kSteps][4], al[L::kSteps][4];

  const int chunks = (a.words + kChunk - 1) / kChunk;
  const int tiles = (split.end - split.begin + kCols - 1) / kCols;
  // bf16 flash: a first pass over the split for the rows' maxima.
  constexpr int kPasses = (FLASH && RND) ? 2 : 1;
  const int steps = kPasses * tiles * chunks;
  // Step q is chunk q % chunks of tile q / chunks (of the pass's split:
  // tile q / chunks % tiles), staged in stage q % kStages; tile t's |y|^2
  // and signal go to tile buffer t % kStages with its first chunk.
  auto issue = [&](int q) {
    if (q < steps) {
      const int qt = q / chunks, qc = q % chunks;
      L::load(stages + (q % kStages) * kStageWords, tile_bufs + (qt % kStages) * kTileBuf, a,
              row0, split.begin + (qt % tiles) * kCols, split.end, qc * kChunk, qc == 0);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  // The epilogue of a tile runs once its last wgmma group has finished:
  // at the next step, or after the loop.
  int done_tile = -1;
  auto epilogue = [&]() {
    const int j0 = split.begin + (done_tile % tiles) * kCols;
    const float* tb = tile_bufs + (done_tile % kStages) * kTileBuf;
    const bool masked = j0 + kCols > split.end || (a.diag && j0 < dhi && j0 + kCols > dlo);
    bool first_pass = false;
    if constexpr (kPasses == 2) {
      first_pass = done_tile < tiles;
      if (first_pass && masked) {
        L::template row_max<true>(acc, st, xq, tb, j0, split.end, diag_col, t);
      } else if (first_pass) {
        L::template row_max<false>(acc, st, xq, tb, j0, split.end, diag_col, t);
      }
    }
    if (!first_pass && masked) {
      L::template epilogue<true>(acc, st, xq, tb, j0, split.end, diag_col, t);
    } else if (!first_pass) {
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
    L::settle(ah, al, acc, part);  // step s - 1's wgmma group
    if (done_tile >= 0) epilogue();
    L::load_a(stage, ah, al, wrow, lane);
    L::multiply(stage, ah, al, acc, part);
    if (++chunk == chunks) {
      done_tile = tile++;
      chunk = 0;
    }
  }
  L::settle(ah, al, acc, part);
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
