// The wide-signal mode (E > 8 signal columns) of the large-D kernels
// (D > 8): the port of the Pallas kernels' MXU accumulation mode
// (kmb_tpu/ops/product.py, `_accumulate` with acc_mode="mxu", chosen at
// :560) for _direct_kernel_body (:230) and _flash_kernel_body (:260).
// Included by large_d_wide_tf32.cu (KMB_BF16 0: 3xTF32, the float32 tiers)
// and large_d_wide_bf16.cu (KMB_BF16 1), one object file each.
//
// What it computes: per block of 128 target rows, for its split's source
// points in tiles of 128, the form product <x, y> on the tensor cores
// (wgmma m64n128, x from registers, y from shared memory), completed on the
// accumulator fragments with the norms, mapped, masked, and the tile's
// kernel values (flash: exp2 weights) times a staged signal tile of EB
// columns by a second wgmma (wide.cuh, WideSignal; EB = 16, 32, or 64 in
// bf16), summed in three levels (WideRows).  E blocks of EB columns lie on
// the grid's z dimension: each kernel value is computed once per E block.
//
// What bounds it on an H100: the form on the tensor cores (2 N M D flops,
// three TF32 passes at 495 TFLOP/s in the float32 tiers, one bf16 pass at
// 989 in bf16) and the bytes each block stages from L2 per tile of 128 x
// 128 pairs: x and y, 128 rows x D each.  At D = 256, 20000^2: float32, x
// and y's two TF32 planes, 10.1 GB a call against a 1.24 ms tensor-core
// bound (8.2 TB/s, beyond L2); bf16, y alone beside resident x, 1.7 GB
// against 0.22 ms.
//
// The design, for that:
//   - Two warpgroups of 64 target rows each, 256 threads, one block an SM:
//     each thread may hold 255 registers, which the form's accumulator, the
//     3xTF32 chunk product, the x fragments and the signal sums need.
//     (ptxas gives the threads of a 288- or 384-thread block at most 168
//     registers a thread, and setmaxnreg did not raise that: a producer
//     warpgroup that gave its registers to the consumers, and a producer
//     warp, were built first and both spilled.)
//   - A TMA ring.  cp.async.bulk.tensor loads of 128-byte chunks of D (the
//     128-byte swizzle atom: wgmma and ldmatrix read them without bank
//     conflicts) fill a ring of 4 to 8 stages guarded by mbarriers,
//     "landed" (the TMA's byte count) and "empty" (each warp, once its
//     wgmma group on the stage has retired); no block barrier in the loop.
//     Thread 0 issues the loads, each a ring ahead of the last step its
//     warpgroup gave back; warpgroup 0 walks their control flow (each TMA
//     instruction predicated on thread 0, so no branch diverges between
//     wgmma groups: ptxas serialises wgmma groups around a divergent path)
//     and waits for warpgroup 1's releases, which only waits for data.  A
//     tile's |y|^2 and signal tile arrive with its last chunk into one of
//     one or two tile buffers ("tile empty": after the epilogue).
//   - The TF32 split of y (float32 tiers) once per call in the wrapper:
//     tf32_planes gives hi and lo planes, which one 3-D box loads together;
//     the consumers split their x fragments in registers after ldmatrix.
//     The planes add half again to the bytes from L2; a split in shared
//     memory needs threads that this block has no registers for.
//   - Fewer staged bytes in bf16: x stays resident in shared memory when it
//     fits beside four stages (128 x D x 2 bytes: 64 KiB at D = 256), so a
//     tile stages y alone, half the bytes.  The float32 tiers' x (128 KiB at
//     D = 256) does not fit, and streams with y.  The signal arrives in
//     groups of 128 bytes of source columns (tma_signal), one box a tile.
//   - The epilogue overlapped with the form products for E blocks of 16:
//     the first wgmma group of the next tile is issued before the tile's
//     epilogue runs (form completion, map, masks, row sums), so the tensor
//     cores keep working through it.  Wider E blocks have no registers for
//     that, and run the epilogue between the tiles.
//   - 3xTF32 as before: each chunk's product starts from zero and is added
//     on the FP32 units (the tensor cores truncate as they accumulate; the
//     diagonal of equal points needs f32 accuracy), in two halves of 64
//     source columns (a 64 x 128 chunk product beside the accumulator
//     spilled), and the signal product's hi.hi part per k step on the FP32
//     units (wide.cuh).
//
// Not yet as designed: ptxas serialises every instantiation's wgmma groups
// (its notes C7513 in 3xTF32, C7514 in bf16).  Built with KMB_NO_EPILOGUE
// neither note appears, so the epilogue (the signal product from the
// accumulator fragments, the flash rescale) draws them.
//   - The bf16 flash kernel walks its split twice: the first pass only
//     takes each row's max, so the second rounds every weight against the
//     row's max, as the plain version (and kmb_tpu's kernel_matvec_xla) do.

#include "tma.cuh"
#include "wide.cuh"

#ifndef KMB_BF16
#error "define KMB_BF16 to 0 (3xTF32) or 1 (bf16)"
#endif

namespace kmb {

// The block's dynamic shared memory (1024-byte aligned for the swizzle).
extern __shared__ __align__(1024) unsigned char wide_smem[];

namespace {

constexpr bool kBf16 = KMB_BF16;
constexpr int kThreads = 256;           // two warpgroups
constexpr int kRows = 128;              // target rows per block, 64 per consumer
constexpr int kCols = 128;              // source points per tile (the form's wgmma N)
constexpr int kChunkWords = 32;         // 32-bit words of a row per chunk: 128 bytes
constexpr int kBoxBytes = 128 * 128;    // one staged chunk of 128 rows
constexpr int kSteps = 4;               // wgmma k steps (32 bytes) per chunk
constexpr int kMinStages = 4, kMaxStages = 8;
constexpr int kSmemBudget = 232448;     // bytes of shared memory a block may use
constexpr int kBarrierBytes = 256;

// Measurement switches (tools/wide_breakdown.py; their answers are wrong):
// no TMA loads after the ring's first round of stages (the stages keep
// their data), and no epilogue (the form products alone).
#ifdef KMB_NO_STAGE_LOADS
constexpr bool kNoStageLoads = true;
#else
constexpr bool kNoStageLoads = false;
#endif
#ifdef KMB_NO_EPILOGUE
constexpr bool kNoEpilogue = true;
#else
constexpr bool kNoEpilogue = false;
#endif

// The E blocks of this tier (signal columns per block of the grid's z
// dimension): 64 in 3xTF32 leaves the consumers no registers.
__host__ __device__ constexpr bool supported_eb(int eb) {
  return eb == 16 || eb == 32 || (kBf16 && eb == 64);
}

// The epilogue overlaps the next tile's first form product where the
// registers hold a second accumulator beside the signal sums.
__host__ __device__ constexpr bool overlapped(int eb) { return eb == 16; }

// A tile buffer: the signal tile (TF32 hi and lo parts, or bf16), then the
// tile's |y|^2, in whole KiB.  Overlapped epilogues need two (the next
// tile's buffer lands while this one's epilogue runs).
template <int EB>
struct TileBuf {
  using Sig = WideSignal<kCols, EB, kBf16, true>;
  static constexpr int kSigBytes = Sig::kWords * 4;
  static constexpr int kBytes = (kSigBytes + kCols * 4 + 1023) / 1024 * 1024;
  static constexpr int kCount = overlapped(EB) ? 2 : 1;
};

// Shared memory of a launch: the ring's stages, then resident x chunks
// (bf16, when they fit beside kMinStages stages), then the tile buffers and
// the barriers.
struct Plan {
  int stages, resident, smem;
};

template <int EB>
__host__ __device__ Plan plan(int words) {
  using TB = TileBuf<EB>;
  const int chunks = (words + kChunkWords - 1) / kChunkWords;
  const int room = kSmemBudget - kBarrierBytes - TB::kCount * TB::kBytes;
  Plan p{0, 0, 0};
  int stage = kBoxBytes * (kBf16 ? 2 : 3);  // y (and its TF32 lo part), x
  int xres = 0;
  if (kBf16 && room - chunks * kBoxBytes >= kMinStages * kBoxBytes) {
    p.resident = 1;
    xres = chunks * kBoxBytes;
    stage = kBoxBytes;
  }
  p.stages = (room - xres) / stage < kMaxStages ? (room - xres) / stage : kMaxStages;
  p.smem = p.stages * stage + xres + TB::kCount * TB::kBytes + kBarrierBytes;
  return p;
}

// x (rows of words), y (bf16: rows of words; 3xTF32: the hi and lo planes),
// |y|^2, and the signal in groups of 128 bytes of source columns
// (product.py, tma_signal: 3xTF32 its hi and lo planes).
struct Maps {
  CUtensorMap x, y, ysq, sig;
  int stages, resident;
};

// ---- registers ----------------------------------------------------------------

template <int R>
__device__ __forceinline__ void zero(float (&d)[R][4]) {
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) d[j][k] = 0.f;
}

// ---- the kernel ---------------------------------------------------------------

// The block's view of its shared memory and pipeline: byte offsets into
// wide_smem, and `sbase`, its shared-memory address (32-bit addresses
// keep the bookkeeping in few registers).
struct Ring {
  unsigned sbase;
  int xres;    // resident x chunks (bf16), kBoxBytes each
  int tiles;   // tile buffers
  int bars;    // barriers: landed, empty (kMaxStages each), tempty (2), xfull
  int stages, resident, stage_bytes, chunks, tiles_per_pass, steps;

  // Stage of step q: y (3xTF32: its hi plane, then its lo plane), x unless
  // resident.
  __device__ int stage(int q) const { return (q % stages) * stage_bytes; }
  __device__ unsigned parity(int q) const { return (q / stages) & 1; }
  __device__ unsigned at(int offset) const { return sbase + offset; }
  __device__ int x_chunk(int q) const {
    return resident ? xres + (q % chunks) * kBoxBytes : stage(q) + kBoxBytes * (kBf16 ? 1 : 2);
  }
  __device__ int tile_buf(int qt, int bytes, int count) const {
    return tiles + (qt % count) * bytes;
  }
  __device__ unsigned bar(int i) const { return sbase + bars + 8 * i; }
  // The TMA's bytes landed.
  __device__ unsigned landed(int q) const { return bar(q % stages); }
  // The consumers' wgmma groups on the stage retired.
  __device__ unsigned empty(int q) const { return bar(kMaxStages + q % stages); }
  // The tile buffer's epilogue done.
  __device__ unsigned tempty(int b) const { return bar(2 * kMaxStages + b); }
  // Resident x landed.
  __device__ unsigned xfull() const { return bar(2 * kMaxStages + 2); }
};

template <int K, bool FLASH, int EB>
struct LargeDWide {
  using Map = KernelMap<K>;
  using TB = TileBuf<EB>;
  using Sig = typename TB::Sig;
  static constexpr int NB = EB / 8;
  static constexpr bool kOverlap = overlapped(EB);
  static constexpr int kPasses = (FLASH && kBf16) ? 2 : 1;

  // The leader's loads: resident x, once (bf16, when it fits).
  static __device__ __forceinline__ void load_x(const Maps& maps, const Ring& r, bool leader) {
    mbar_expect_tx(r.xfull(), r.chunks * kBoxBytes, leader);
#pragma unroll 1
    for (int c = 0; c < r.chunks; ++c) {
      const int at[2] = {c * kChunkWords, (int)blockIdx.y * kRows};
      tma_load(r.at(r.xres + c * kBoxBytes), &maps.x, r.xfull(), at, leader);
    }
  }

  // The leader's loads of step q into its stage, once both warpgroups gave
  // the stage back (every thread waits): y (float32 tiers: its TF32 hi and
  // lo planes), x unless resident, and with a tile's last chunk the tile's
  // |y|^2 and signal tile into its tile buffer, once both warpgroups have
  // done the epilogue that last used it.
  static __device__ __forceinline__ void load(int q, const Maps& maps, const Ring& r, int begin,
                                              bool leader) {
    if (q >= r.stages) mbar_wait(r.empty(q), r.parity(q) ^ 1);
    const int qt = q / r.chunks, qc = q % r.chunks;
    const bool last = qc == r.chunks - 1;
    const unsigned st = r.at(r.stage(q)), landed = r.landed(q);
    const unsigned tb = r.at(r.tile_buf(qt, TB::kBytes, TB::kCount));
    unsigned bytes = kBoxBytes * ((kBf16 ? 1 : 2) + (r.resident ? 0 : 1));
    if (last) {
      if (qt >= TB::kCount) mbar_wait(r.tempty(qt % TB::kCount), ((qt / TB::kCount) - 1) & 1);
      bytes += TB::kSigBytes + (Map::kDot ? 0 : kCols * 4);
    }
    if (kNoStageLoads && q >= r.stages) {
      mbar_arrive_one(landed, leader);
      return;
    }
    mbar_expect_tx(landed, bytes, leader);
    const int j0 = begin + (qt % r.tiles_per_pass) * kCols;
    if constexpr (kBf16) {
      const int at[2] = {qc * kChunkWords, j0};
      tma_load(st, &maps.y, landed, at, leader);
    } else {  // both planes: hi, then lo kBoxBytes further
      const int at[3] = {qc * kChunkWords, j0, 0};
      tma_load(st, &maps.y, landed, at, leader);
    }
    if (!r.resident) {
      const int at[2] = {qc * kChunkWords, (int)blockIdx.y * kRows};
      tma_load(st + kBoxBytes * (kBf16 ? 1 : 2), &maps.x, landed, at, leader);
    }
    if (last) {
      if constexpr (!Map::kDot) {
        const int at[1] = {j0};
        tma_load(tb + TB::kSigBytes, &maps.ysq, landed, at, leader);
      }
      // The tile's 128 source columns: groups of 128 bytes side by side
      // (and 3xTF32's lo plane after the hi plane), as WideSignal reads.
      constexpr int kGroup = kBf16 ? 64 : 32;  // source columns a group
      if constexpr (kBf16) {
        const int at[3] = {0, (int)blockIdx.z * EB, j0 / kGroup};
        tma_load(tb, &maps.sig, landed, at, leader);
      } else {
        const int at[4] = {0, (int)blockIdx.z * EB, j0 / kGroup, 0};
        tma_load(tb, &maps.sig, landed, at, leader);
      }
    }
  }

  // The warp's 16 rows of a staged x chunk as wgmma A fragments (and their
  // TF32 lo parts in 3xTF32), through ldmatrix from the swizzled box: row
  // R's 16-byte piece c lies at piece c ^ (R % 8).
  static __device__ __forceinline__ void load_a(unsigned x, unsigned (&ah)[kSteps][4],
                                                unsigned (&al)[kSteps][4], int wrow, int lane) {
    const int r8 = lane % 8, q = lane / 8;
    const unsigned row = x + (wrow + (q % 2) * 8 + r8) * 128;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      // Matrices: rows 0-7 / 8-15 (q % 2) of words 0-3 / 4-7 (q / 2).
      const int piece = (ks * 2 + q / 2) ^ r8;
      unsigned v[4];
      ldmatrix_x4(v, row + piece * 16);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ah[ks][k] = kBf16 ? v[k] : tf32_hi(v[k]);
        if constexpr (!kBf16) al[ks][k] = tf32_lo(v[k], ah[ks][k]);
      }
    }
  }

  // Issue a chunk's 64 x 128 block of <x, y> for the warpgroup: bf16, one
  // wgmma group, a tile's FIRST chunk into `part_bf16` from zero (zeroed
  // here, so it lives only until settle) and the others into acc.
  // 3xTF32, the chunk's source columns 0-63 into `part` from zero, as one
  // group; settle adds it on the FP32 units and does columns 64-127 the
  // same way (a half-width product keeps the consumers within their
  // registers: an accumulator of 64 x 128 beside it spilled).
  template <bool FIRST>
  static __device__ __forceinline__ void multiply(unsigned y, unsigned (&ah)[kSteps][4],
                                                  unsigned (&al)[kSteps][4], float (&acc)[16][4],
                                                  float (&part)[8][4], float (&part_bf16)[16][4]) {
    if constexpr (kBf16 && !FIRST) {
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
        wgmma_rs<kCols, true>(acc, ah[ks], sw128_desc(y, kCols, ks), 1);
    } else if constexpr (kBf16) {
      zero(part_bf16);
      fence_acc(part_bf16);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
        wgmma_rs<kCols, true>(part_bf16, ah[ks], sw128_desc(y, kCols, ks), ks > 0);
    } else {
      tf32_half(y, 0, ah, al, part);
    }
    wgmma_commit();
  }

  // 3xTF32: the 64 x 64 block of source columns [64 h, 64 h + 64) of a
  // chunk into `part`, from zero (its first product does not add: no
  // instruction but the wgmma defines `part`, which ptxas needs to keep the
  // groups unserialised; lo.hi + hi.lo + hi.hi; y's lo plane is kBoxBytes
  // after its hi plane).
  static __device__ __forceinline__ void tf32_half(unsigned y, int h, unsigned (&ah)[kSteps][4],
                                                   unsigned (&al)[kSteps][4],
                                                   float (&part)[8][4]) {
    const unsigned hi = y + h * 64 * 128, lo = hi + kBoxBytes;
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      wgmma_rs<64, false>(part, al[ks], sw128_desc(hi, 64, ks), ks > 0);
      wgmma_rs<64, false>(part, ah[ks], sw128_desc(lo, 64, ks), 1);
      wgmma_rs<64, false>(part, ah[ks], sw128_desc(hi, 64, ks), 1);
    }
  }

  // acc's columns [64 h, 64 h + 64) (3xTF32) = part, or += part.
  template <bool FIRST>
  static __device__ __forceinline__ void add_half(int h, float (&acc)[16][4],
                                                  float (&part)[8][4]) {
    fence_acc(part);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (FIRST) {
          acc[8 * h + j][k] = part[j][k];
        } else {
          acc[8 * h + j][k] += part[j][k];
        }
      }
  }

  // Wait for the chunk's group; then the chunk is in acc (a tile's FIRST
  // chunk sets it, the others add), and its stage and A registers are
  // free.  3xTF32: the second half of the chunk, issued and waited here.
  template <bool FIRST>
  static __device__ __forceinline__ void settle(unsigned y, unsigned (&ah)[kSteps][4],
                                                unsigned (&al)[kSteps][4], float (&acc)[16][4],
                                                float (&part)[8][4], float (&part_bf16)[16][4]) {
    wgmma_wait<0>();
    if constexpr (kBf16) {
      fence_regs(ah);
      if constexpr (FIRST) {
        fence_acc(part_bf16);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[j][k] = part_bf16[j][k];
      } else {
        fence_acc(acc);
      }
    } else {
      add_half<FIRST>(0, acc, part);
      tf32_half(y, 1, ah, al, part);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(ah);
      fence_regs(al);
      add_half<FIRST>(1, acc, part);
    }
  }

  // bf16 flash, first pass: each row's max over this tile's logits (from
  // the fragment and two quad shuffles) into the row state's m.
  template <bool MASKED>
  static __device__ __forceinline__ void row_max(const float (&acc)[16][4], WideRows<NB, FLASH>& st,
                                                 const float (&xq)[2], const float* ysq, int j0,
                                                 int end, const int (&diag_col)[2], int t) {
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c0 = j * 8 + 2 * t;
      float yq[2] = {0.f, 0.f};
      if constexpr (!Map::kDot) load_vec<2>(ysq + c0, yq);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j0 + c0 + e;
          const bool off = MASKED && (col >= end || col == diag_col[h]);
          if (!off) {
            const float v = expanded_form<Map>(acc[j][2 * h + e], xq[h], yq[e]);
            mx[h] = fmaxf(mx[h], Map::logit(v));
          }
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 2));
      st.m[h] = fmaxf(st.m[h], mx[h]);
    }
  }

  // One tile into the running state: the forms (flash: logits) in place,
  // the masks, the flash rescale, the weights in place (rounded to bf16 in
  // the bf16 tier; their unrounded row sums kept), then the signal product
  // from the fragments.  MASKED: the tile holds the split's ragged end or
  // the diagonal.
  template <bool MASKED>
  static __device__ __forceinline__ void fold(float (&acc)[16][4], WideRows<NB, FLASH>& st,
                                              const float (&xq)[2], int tb, int j0, int end,
                                              const int (&diag_col)[2], int t) {
    const float* ysq = reinterpret_cast<const float*>(wide_smem + tb + TB::kSigBytes);
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
          v = expanded_form<Map>(v, xq[h], yq[e]);
          if constexpr (FLASH) {
            v = Map::logit(v);
            if (MASKED && (j0 + c0 + e >= end || j0 + c0 + e == diag_col[h])) v = kNegInf;
          }
        }
    }
    if constexpr (FLASH) st.rescale(acc);
    float tsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int h = k / 2, col = j0 + j * 8 + 2 * t + k % 2;
        const float v = acc[j][k];
        float p;
        if constexpr (FLASH) {
          p = ex2(v - st.m[h]);
          // A masked logit of a row with no valid column yet would give
          // exp2(0) = 1.
          if (MASKED && v == kNegInf) p = 0.f;
        } else {
          p = Map::value(v);
          if (MASKED && (col >= end || col == diag_col[h])) p = 0.f;
        }
        tsum[h] += p;
        acc[j][k] = kBf16 ? round_bf16(p) : p;
      }
    auto weights = [&](int j, float (&w)[4]) {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = acc[j][k];
    };
    Sig::contract(st.grp, reinterpret_cast<const unsigned*>(wide_smem + tb), weights);
    st.end_tile(tsum, kCols);
  }

  // The epilogue of tile qt (over both passes of the bf16 flash kernel),
  // then its tile buffer is given back.  `diag`: the block's diagonal, the
  // source columns [dlo, dlo + kRows), may cross the split.
  static __device__ __forceinline__ void tile_epilogue(int qt, float (&acc)[16][4],
                                                       WideRows<NB, FLASH>& st,
                                                       const float (&xq)[2],
                                                       const int (&diag_col)[2], bool diag,
                                                       long long dlo, const Ring& r,
                                                       const Split<kCols>& split, int t,
                                                       int lane) {
    const int j0 = split.begin + (qt % r.tiles_per_pass) * kCols;
    const int tb = r.tile_buf(qt, TB::kBytes, TB::kCount);
    const bool masked = j0 + kCols > split.end || (diag && j0 < dlo + kRows && j0 + kCols > dlo);
    if (kNoEpilogue) {
    } else if (kPasses == 2 && qt < r.tiles_per_pass) {
      const float* ysq = reinterpret_cast<const float*>(wide_smem + tb + TB::kSigBytes);
      if (masked) {
        row_max<true>(acc, st, xq, ysq, j0, split.end, diag_col, t);
      } else {
        row_max<false>(acc, st, xq, ysq, j0, split.end, diag_col, t);
      }
    } else if (masked) {
      fold<true>(acc, st, xq, tb, j0, split.end, diag_col, t);
    } else {
      fold<false>(acc, st, xq, tb, j0, split.end, diag_col, t);
    }
    __syncwarp();
    mbar_arrive_one(r.tempty(qt % TB::kCount), lane == 0);
  }

  // The consumers: two warpgroups of 64 target rows each.
  static __device__ __forceinline__ void consume(const Args& a, const Maps& maps, const Ring& r,
                                                 const Split<kCols>& split) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;  // consumer warp 0..7
    const int wrow = warp * 16;  // the warp's rows in the block
    const int g = lane / 4, t = lane % 4;
    const int row0 = blockIdx.y * kRows;
    float xq[2];
    int diag_col[2];  // local source column on the global diagonal, or -1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + wrow + h * 8 + g;
      xq[h] = (!Map::kDot && i < a.n) ? a.xsq[i] : 0.f;
      const long long jd = (long long)i + a.shift;
      diag_col[h] = (a.diag && jd >= 0 && jd < a.m_eff) ? (int)jd : -1;
    }
    // The block's diagonal runs through source columns [dlo, dlo + kRows).
    const long long dlo = (long long)row0 + a.shift;

    float acc[16][4];       // a tile's forms
    float part[8][4];       // 3xTF32: half a chunk's product
    float part_bf16[16][4];  // bf16: a tile's first chunk's product
    zero(part);
    WideRows<NB, FLASH> st;
    unsigned ah[kSteps][4], al[kSteps][4];


    // Warpgroup 0 walks the loads' control flow and thread 0 (the leader)
    // issues them, before each chunk of its own: each step as soon as its
    // stage is given back by both warpgroups (warpgroup 0 waits for the
    // other, never for itself), up to a ring ahead of the last step it
    // released; a tile's last chunk only once it has done the epilogue that
    // last used the tile buffer.  Warpgroup 1 only waits for the data.
    const bool loader = __shfl_sync(kFullMask, threadIdx.x / 128, 0) == 0;
    const bool leader = threadIdx.x == 0;
    int next = 0, released = -1, epilogues = 0;
    auto load_ahead = [&]() {
#pragma unroll 1
      for (; next < r.steps && next <= released + r.stages; ++next) {
        const bool last = next % r.chunks == r.chunks - 1;
        if (last && next / r.chunks - TB::kCount >= epilogues) break;
        load(next, maps, r, split.begin, leader);
      }
    };
    // Chunk q of the walk: wait for its stage, load its x fragments, issue
    // its form product (a tile's first chunk, or a later one).
    auto wait_and_load = [&](int q) {
      if (loader) load_ahead();
      mbar_wait(r.landed(q), r.parity(q));
      load_a(r.at(r.x_chunk(q)), ah, al, wrow, lane);
    };
    auto issue_first = [&](int q) {
      wait_and_load(q);
      multiply<true>(r.at(r.stage(q)), ah, al, acc, part, part_bf16);
    };
    auto issue_later = [&](int q) {
      wait_and_load(q);
      multiply<false>(r.at(r.stage(q)), ah, al, acc, part, part_bf16);
    };
    // Give chunk q's stage back once its group has been settled.
    auto release = [&](int q) {
      __syncwarp();
      mbar_arrive_one(r.empty(q), lane == 0);
      released = q;
    };

    if (loader && r.resident && r.steps > 0) load_x(maps, r, leader);
    if (r.steps > 0 && r.resident) mbar_wait(r.xfull(), 0);
    // The walk, one chunk's wgmma group in flight at a time (not unrolled:
    // each chunk's registers are the accumulators and x fragments).
    const int tiles = r.steps / r.chunks;  // over both passes of the bf16 flash kernel
#pragma unroll 1
    for (int qt = 0; qt < tiles; ++qt) {
      const int q0 = qt * r.chunks;
      if (qt > 0) {  // the previous tile's last chunk
        const unsigned y = r.at(r.stage(q0 - 1));
        if (r.chunks == 1) {
          settle<true>(y, ah, al, acc, part, part_bf16);
        } else {
          settle<false>(y, ah, al, acc, part, part_bf16);
        }
        release(q0 - 1);
        if (!kOverlap) {
          tile_epilogue(qt - 1, acc, st, xq, diag_col, a.diag != 0, dlo, r, split, t, lane);
          ++epilogues;
        }
      }
      issue_first(q0);
      if (kOverlap && qt > 0) {
        tile_epilogue(qt - 1, acc, st, xq, diag_col, a.diag != 0, dlo, r, split, t, lane);
        ++epilogues;
      }
      if (r.chunks > 1) {
        settle<true>(r.at(r.stage(q0)), ah, al, acc, part, part_bf16);
        release(q0);
        issue_later(q0 + 1);
#pragma unroll 1
        for (int c = 2; c < r.chunks; ++c) {
          settle<false>(r.at(r.stage(q0 + c - 1)), ah, al, acc, part, part_bf16);
          release(q0 + c - 1);
          issue_later(q0 + c);
        }
      }
    }
    if (tiles > 0) {
      const unsigned y = r.at(r.stage(r.steps - 1));
      if (r.chunks == 1) {
        settle<true>(y, ah, al, acc, part, part_bf16);
      } else {
        settle<false>(y, ah, al, acc, part, part_bf16);
      }
      tile_epilogue(tiles - 1, acc, st, xq, diag_col, a.diag != 0, dlo, r, split, t, lane);
    }
    st.store(a, row0 + wrow + g, t);
  }
};

template <int K, bool FLASH, int EB>
__global__ void __launch_bounds__(kThreads, 1)
    large_d_wide_kernel(const Args a, const __grid_constant__ Maps maps) {
  using W = LargeDWide<K, FLASH, EB>;
  using TB = typename W::TB;
  const Split<kCols> split(a);
  Ring r;
  r.stages = maps.stages;
  r.resident = maps.resident;
  r.chunks = (a.words + kChunkWords - 1) / kChunkWords;
  r.tiles_per_pass = (split.end - split.begin + kCols - 1) / kCols;
  r.steps = W::kPasses * r.tiles_per_pass * r.chunks;
  r.stage_bytes = kBoxBytes * (kBf16 ? (r.resident ? 1 : 2) : 3);
  r.sbase = smem_addr(wide_smem);
  r.xres = r.stages * r.stage_bytes;
  r.tiles = r.xres + (r.resident ? r.chunks * kBoxBytes : 0);
  r.bars = r.tiles + TB::kCount * TB::kBytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < r.stages; ++s) {
      mbar_init(r.landed(s), 1);   // the issuing thread's expect_tx
      mbar_init(r.empty(s), 8);    // the consumer warps
    }
    for (int b = 0; b < TB::kCount; ++b) mbar_init(r.tempty(b), 8);
    mbar_init(r.xfull(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  W::consume(a, maps, r, split);
}

// ---- host side ------------------------------------------------------------------

// The bytes a launch's TMA loads move, as their boxes count them: per block
// (a split, a row block, an E block) and tile, the chunks of y (3xTF32: of
// both planes) and of x unless resident, the signal tile and |y|^2, over
// both passes of the bf16 flash kernel; resident x once a block.
template <int K, bool FLASH, int EB>
long long staged_bytes(const Args& a, dim3 grid, const Plan& p) {
  const long long chunks = (a.words + kChunkWords - 1) / kChunkWords;
  const long long per_tile = chunks * kBoxBytes * ((kBf16 ? 1 : 2) + (p.resident ? 0 : 1)) +
                             TileBuf<EB>::kSigBytes + (KernelMap<K>::kDot ? 0 : kCols * 4);
  long long per_row_block = 0;
  for (unsigned s = 0; s < grid.x; ++s) {
    const Split<kCols> split(a.m_eff, grid.x, s);
    const long long tiles = (split.end - split.begin + kCols - 1) / kCols;
    if (tiles > 0) {
      per_row_block += LargeDWide<K, FLASH, EB>::kPasses * tiles * per_tile +
                       (p.resident ? chunks * kBoxBytes : 0);
    }
  }
  return per_row_block * grid.y * grid.z;
}

// Encode the call's tensor maps and launch (the launch timer starts after
// the encoding); the launch's staging goes to last_staging.  A map that does
// not encode fails the call.
template <int K, bool FLASH, int EB>
cudaError_t run(const Shape&, const Launch& l, const Args& a, dim3 grid, cudaStream_t stream) {
  const Plan p = plan<EB>(a.words);
  Maps maps;
  maps.stages = p.stages;
  maps.resident = p.resident;
  const auto words = CU_TENSOR_MAP_DATA_TYPE_UINT32;  // f32 values or bf16 pairs
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const long long row = a.words * 4;  // bytes of a point row
  bool ok = encode<2>(&maps.x, words, 4, a.x, {a.words, a.n}, {4, row}, {kChunkWords, kRows}, sw);
  // With no source column the kernel loads nothing: x stands in for the rest.
  if (a.m_eff == 0) {
    maps.y = maps.ysq = maps.sig = maps.x;
  } else {
    const long long m = a.m_eff, width = (long long)grid.z * EB;
    // 3xTF32: y is the wrapper's TF32 planes (2, m_eff, words), hi then lo.
    if (kBf16) {
      ok = ok && encode<2>(&maps.y, words, 4, a.y, {a.words, m}, {4, row}, {kChunkWords, kCols},
                           sw);
    } else {
      ok = ok && encode<3>(&maps.y, words, 4, a.y, {a.words, m, 2}, {4, row, m * row},
                           {kChunkWords, kCols, 2}, sw);
    }
    if (KernelMap<K>::kDot) {
      maps.ysq = maps.x;  // not read
    } else {
      ok = ok && encode<1>(&maps.ysq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.ysq, {m}, {4},
                           {kCols}, CU_TENSOR_MAP_SWIZZLE_NONE);
    }
    // The signal in groups of 128 bytes of source columns (product.py,
    // tma_signal): (groups, width, 64) bf16, or (2, groups, width, 32) f32.
    const long long ldb = a.ldb;
    if (kBf16) {
      ok = ok && ldb % 64 == 0 &&
           encode<3>(&maps.sig, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.bt, {64, width, ldb / 64},
                     {2, 128, width * 128}, {64, EB, kCols / 64}, sw);
    } else {
      ok = ok && ldb % 32 == 0 &&
           encode<4>(&maps.sig, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.bt,
                     {32, width, ldb / 32, 2}, {4, 128, width * 128, ldb * width * 4},
                     {32, EB, kCols / 32, 2}, sw);
    }
  }
  if (!ok) return cudaErrorInvalidValue;
  last_staging = Staging{p.stages, p.resident, staged_bytes<K, FLASH, EB>(a, grid, p)};
  Args args = a;
  void* params[] = {&args, &maps};
  return launch_kernel(l.fn, grid, dim3(kThreads), params, l.smem, stream);
}

template <int K, bool FLASH, int EB>
void fill(const Shape& s, Launch* out) {
  out->fn = reinterpret_cast<const void*>(&large_d_wide_kernel<K, FLASH, EB>);
  out->threads = kThreads;
  out->smem = plan<EB>(s.d).smem;
  out->rows = kRows;
  out->run = &run<K, FLASH, EB>;
}

template <int K, bool FLASH>
bool pick_eb(const Shape& s, Launch* out) {
  switch (s.nc) {
    case 16: fill<K, FLASH, 16>(s, out); return true;
    case 32: fill<K, FLASH, 32>(s, out); return true;
    case 64:
      if constexpr (supported_eb(64)) {
        fill<K, FLASH, 64>(s, out);
        return true;
      }
      return false;
    default: return false;  // the wrapper's E blocks (product.py, signal_plan)
  }
}

template <int K>
bool pick_wide(const Shape& s, Launch* out) {
  if (s.flash) {
    if constexpr (K == kInverseDistance) {
      return false;  // only kernels with a log form run the flash scheme
    } else {
      return pick_eb<K, true>(s, out);
    }
  }
  return pick_eb<K, false>(s, out);
}

}  // namespace

#if KMB_BF16
bool large_d_wide_bf16_launch(const Shape& s, Launch* out) {
#else
bool large_d_wide_tf32_launch(const Shape& s, Launch* out) {
#endif
  if (!s.large || s.d <= 0 || s.d % 4 != 0) return false;  // rows of whole 16 bytes
  switch (s.kernel) {
    case kGaussian: return pick_wide<kGaussian>(s, out);
    case kAbsExp: return pick_wide<kAbsExp>(s, out);
    case kInverseDistance: return pick_wide<kInverseDistance>(s, out);
    case kExponential: return pick_wide<kExponential>(s, out);
    default: return false;
  }
}

}  // namespace kmb
