// The one-chunk large-D kernel: the narrow mode (E <= 8) of the tensor-core
// form for points whose padded row is one chunk of at most 32 words (8 < D
// <= 32), in the float32 tiers (3xTF32).  It replaces, for those shapes,
// kmb_tpu/ops/product.py::_flash_kernel_body (:260, through
// kmb_flash_matvec) and ::_direct_kernel_body (:230, through
// kmb_direct_matvec); large_d.cuh takes longer rows and the bfloat16 tier.
//
// What bounds it on an H100: the tensor cores.  A block-tile of 128 x 128
// pairs is 12 wgmma m64n128k8 a warpgroup (4 k steps x 3 TF32 passes),
// 3 x 2 x 128 x 128 x 32 flops, about 1,540 clocks of the SM's TF32 rate.
// Its epilogue is one exp2 a pair on the special-function units (16 a clock
// an SM: 1,024 clocks) and about 6 other instructions a pair.  At D25 the
// frozen least time (portbench/roofline.py, 25 of the 32 padded words)
// puts the SFU at about 0.8 of the tensor cores; serialised, the two add.
//
// The design, for that: the next tile's form product runs on the tensor
// cores while the same warps fold the current tile on the SFU and FP32
// units.
//   - Two accumulators a warpgroup.  Tile s + 1's 12 wgmma go into one while
//     tile s's epilogue (large_d_epilogue.cuh: the form, the map, masks,
//     the flash rescale and the signal FMAs) runs on the other after
//     wgmma.wait_group 1.  The loop handles tiles in pairs, so each
//     accumulator is a fixed set of registers, with no branch around a
//     group: without that, ptxas serialised the groups (C7515).  As in
//     large_d.cuh, each tile's product starts from zero (no instruction but
//     the wgmma defines it) in the order lo.hi + hi.lo + hi.hi per k step.
//   - Targets resident.  The block's 128 x rows are loaded once and split
//     into TF32 hi and lo parts in shared memory (32 KiB), in the layout of
//     TMA's 128-byte swizzle.  For signals of 1 or 2 columns each warp also
//     holds its rows as wgmma A fragments in registers, loaded once; wider
//     signals' wgmma read A from shared memory through descriptors.  Either
//     way the loop redefines no input register.
//   - Sources by TMA.  The wrapper splits y into TF32 planes once per source
//     tensor (product.py, tf32_planes; `_staged_source`); one 3-D box a tile
//     loads both planes (32 KiB), with the tile's |y|^2 and signal, into a
//     ring of stages guarded by mbarriers "full" (the TMA's bytes) and
//     "empty" (the eight warps, after their epilogue); no block barrier in
//     the loop.  Thread 0 issues the loads; every thread walks their control
//     flow, each TMA instruction predicated on it, and the waits that fall
//     while a wgmma group is in flight keep their loop inside one asm
//     statement (tma.cuh), so no C++ branch diverges between groups.
//   - 256 threads, one block an SM: two warpgroups of 64 rows (ptxas holds
//     288- and 384-thread blocks to 168 registers a thread, as
//     large_d_wide.cuh found).
//
// Measured on an H100 80GB HBM3 at 700 W, at 10^4 x 1,183,514 (D25, E1,
// flash): 7.45 ms.  Alone, the epilogue takes 5.1 ms (its instruction
// stream at two warps a scheduler, more than the SFU), the products 4.9
// and the L2 stream of y's planes 4.6: the overlap is partial.

#include "large_d_epilogue.cuh"
#include "tma.cuh"

namespace kmb {

// The block's dynamic shared memory (1024-byte aligned for the swizzle).
extern __shared__ __align__(1024) unsigned char one_chunk_smem[];

namespace {

constexpr int kThreads = 256;        // two warpgroups
constexpr int kRows = 128;           // target rows per block, 64 per warpgroup
constexpr int kCols = 128;           // source points per tile (the form's wgmma N)
constexpr int kWords = 32;           // 32-bit words of a row, at most: one 128-byte chunk
constexpr int kSteps = kWords / 8;   // wgmma k steps of 8 TF32 values
constexpr int kBox = kRows * 128;    // 128 rows of one chunk (x, or a y plane): 16 KiB
constexpr int kMaxStages = 8;
constexpr int kSmemBudget = 232448;  // bytes of shared memory a block may use
constexpr int kBarrierBytes = 16 * kMaxStages;

// Shared memory: resident x (hi, lo), the ring's stages, the barriers.
template <int NC>
struct Layout {
  // A tile's buffer: |y|^2 then the signal, as TileEpilogue reads it.
  static constexpr int kTileBytes = (kCols * (1 + NC) * 4 + 1023) / 1024 * 1024;
  // A stage: y's TF32 hi and lo planes (one 3-D box), then the tile buffer.
  static constexpr int kStageBytes = 2 * kBox + kTileBytes;
  static constexpr int kFit = (kSmemBudget - 2 * kBox - kBarrierBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 2 * kBox + kStages * kStageBytes + kBarrierBytes;
  // The signal's 1-D TMA boxes a tile (a box holds at most 256 values).
  static constexpr int kSigBox = kCols * NC < 256 ? kCols * NC : 256;
  static constexpr int kSigLoads = kCols * NC / kSigBox;
};

// y (the TF32 planes), |y|^2 and the (m, NC) signal.
struct Maps {
  CUtensorMap y, ysq, sig;
};

// The bytes one tile's TMA loads move: both y planes, |y|^2 (not for the
// dot-product form) and the signal.
template <int K, int NC>
__host__ __device__ constexpr unsigned tile_bytes() {
  return 2 * kBox + (KernelMap<K>::kDot ? 0 : kCols * 4) + kCols * NC * 4;
}

// wgmma's A (x) from registers, where they hold it beside the two
// accumulators and the epilogue: a third fewer shared-memory reads a
// product (about 9% of the kernel's time at D25 E1).  Wider signals' row
// states need those registers, and read A from shared memory.
__host__ __device__ constexpr bool a_in_registers(int nc) { return nc <= 2; }

// The tiles a block walks for `tiles` of its split: whole pairs and one.
__host__ __device__ constexpr int walk_tiles(int tiles) { return (tiles + 1) / 2 * 2 + 1; }

template <int K, int NC, bool FLASH, bool DEN>
__global__ void __launch_bounds__(kThreads, 1)
    one_chunk_large_d_kernel(const Args a, const __grid_constant__ Maps maps) {
  using E = TileEpilogue<K, NC, FLASH, DEN, false>;
  using L = Layout<NC>;
  constexpr int S = L::kStages;
  static_assert(E::kTile == kCols, "one tile width");

  const Split<kCols> split(a);
  const int tiles = (split.end - split.begin + kCols - 1) / kCols;
  const int row0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = warp * 16;  // the warp's rows: warpgroup warp / 4, 16 each
  const int g = lane / 4, t = lane % 4;
  const bool leader = threadIdx.x == 0;

  // A split with no source column (every split when m_eff is 0, and then
  // the tensor maps are not encoded) stores the empty state, loading
  // nothing.
  if (tiles == 0) {
    const typename E::State empty_state[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + wrow + h * 8 + g;
      if (t == 0 && i < a.n) empty_state[h].store(a, i, i < a.n_ok);
    }
    return;
  }

  const unsigned base = smem_addr(one_chunk_smem);
  const unsigned bars = base + 2 * kBox + S * L::kStageBytes;
  // Tile q: its stage (a byte offset), barriers and phase.
  auto stage = [&](int q) { return 2 * kBox + (q % S) * L::kStageBytes; };
  auto full = [&](int q) { return bars + 8 * (q % S); };
  auto empty = [&](int q) { return bars + 8 * (kMaxStages + q % S); };
  auto parity = [&](int q) { return (unsigned)(q / S) & 1u; };

  if (leader) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);   // the leader's expect_tx
      mbar_init(empty(s), 8);  // the eight warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The block's targets, split once: row r's 16-byte piece c at piece
  // c ^ (r % 8) of its 128 bytes (TMA's 128-byte swizzle, which the
  // descriptors name); rows past n and words past the row are zero.
  {
    const unsigned* x = static_cast<const unsigned*>(a.x);
    unsigned* x_hi = reinterpret_cast<unsigned*>(one_chunk_smem);
    unsigned* x_lo = x_hi + kBox / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < kRows * kWords; i += kThreads) {
      const int r = i / kWords, w = i % kWords;
      const bool valid = row0 + r < a.n && w < a.words;
      const unsigned v = valid ? x[(size_t)(row0 + r) * a.words + w] : 0u;
      const unsigned hi = tf32_hi(v);
      const int at = r * kWords + ((w / 4) ^ (r % 8)) * 4 + w % 4;
      x_hi[at] = hi;
      x_lo[at] = tf32_lo(v, hi);
    }
    fence_async_shared();
  }
  __syncthreads();

  float xq[2];
  int diag_col[2];  // local source column on the global diagonal, or -1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + wrow + h * 8 + g;
    xq[h] = (!E::Map::kDot && i < a.n) ? a.xsq[i] : 0.f;
    const long long jd = (long long)i + a.shift;
    diag_col[h] = (a.diag && jd >= 0 && jd < a.m_eff) ? (int)jd : -1;
  }
  // The block's diagonal runs through source columns [dlo, dhi).
  const long long dlo = (long long)row0 + a.shift, dhi = dlo + kRows;

  typename E::State st[2];
  float acc0[16][4], acc1[16][4];
  // The warpgroup's 64 rows of x (A), hi and lo: in shared memory, and for
  // narrow signals also the warp's 16 rows as wgmma A fragments, loaded
  // once (ldmatrix from the swizzled rows: row R's piece c at c ^ (R % 8)).
  const unsigned a_hi = base + (warp / 4) * 64 * 128, a_lo = a_hi + kBox;
  unsigned ah[kSteps][4], al[kSteps][4];
  if constexpr (a_in_registers(NC)) {
    const int r8 = lane % 8, q = lane / 8;
    const unsigned row = base + (wrow + (q % 2) * 8 + r8) * 128;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      // Matrices: rows 0-7 / 8-15 (q % 2) of words 0-3 / 4-7 (q / 2).
      const int piece = (ks * 2 + q / 2) ^ r8;
      ldmatrix_x4(ah[ks], row + piece * 16);
      ldmatrix_x4(al[ks], row + kBox + piece * 16);
    }
  }

  // Load tiles [next, min(end, limit)): each once its stage is given back.
  int next = 0;
  auto load_until = [&](int end, int limit) {
#pragma unroll 1
    for (; next < end && next < limit; ++next) {
      if (next >= S) mbar_wait_in_flight(empty(next), parity(next) ^ 1u);
      const unsigned dst = base + stage(next), bar = full(next);
      const int j0 = split.begin + next * kCols;
      mbar_expect_tx(bar, tile_bytes<K, NC>(), leader);
      const int yat[3] = {0, j0, 0};
      tma_load(dst, &maps.y, bar, yat, leader);
      const unsigned tb = dst + 2 * kBox;
      if constexpr (!E::Map::kDot) {
        const int at[1] = {j0};
        tma_load(tb, &maps.ysq, bar, at, leader);
      }
#pragma unroll
      for (int c = 0; c < L::kSigLoads; ++c) {
        const int at[1] = {j0 * NC + c * L::kSigBox};
        tma_load(tb + kCols * 4 + c * L::kSigBox * 4, &maps.sig, bar, at, leader);
      }
    }
  };
  // Issue tile q's form product into acc, from zero, as one wgmma group.
  auto issue = [&](int q, float (&acc)[16][4]) {
    mbar_wait_in_flight(full(q), parity(q));
    const unsigned y_hi = base + stage(q), y_lo = y_hi + kBox;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if constexpr (a_in_registers(NC)) {
        wgmma_rs<kCols, false>(acc, al[ks], sw128_desc(y_hi, kCols, ks), ks > 0);
        wgmma_rs<kCols, false>(acc, ah[ks], sw128_desc(y_lo, kCols, ks), 1);
        wgmma_rs<kCols, false>(acc, ah[ks], sw128_desc(y_hi, kCols, ks), 1);
      } else {
        wgmma_ss_tf32(acc, sw128_desc(a_lo, 64, ks), sw128_desc(y_hi, kCols, ks), ks > 0);
        wgmma_ss_tf32(acc, sw128_desc(a_hi, 64, ks), sw128_desc(y_lo, kCols, ks), 1);
        wgmma_ss_tf32(acc, sw128_desc(a_hi, 64, ks), sw128_desc(y_hi, kCols, ks), 1);
      }
    }
    wgmma_commit();
  };
  // Fold tile q (its group has retired) and give its stage back.
  auto finish = [&](int q, float (&acc)[16][4]) {
    fence_acc(acc);
    const int j0 = split.begin + q * kCols;
    const float* tb = reinterpret_cast<const float*>(one_chunk_smem + stage(q) + 2 * kBox);
    const bool masked = j0 + kCols > split.end || (a.diag && j0 < dhi && j0 + kCols > dlo);
    if (masked) {
      E::template epilogue<true>(acc, st, xq, tb, j0, split.end, diag_col, t);
    } else {
      E::template epilogue<false>(acc, st, xq, tb, j0, split.end, diag_col, t);
    }
    __syncwarp();
    mbar_arrive_one(empty(q), lane == 0);
  };

  // Tiles in pairs, each accumulator a fixed set of registers, in one loop
  // with no branch around a wgmma group (ptxas serialises the groups where
  // a path it cannot rule out reaches an accumulator in flight).  The walk
  // is padded past the split's end to whole pairs and one more issue: the
  // padding's columns lie past the split's end, so the masked epilogue
  // gives them no weight (past the tensor's end their loads fill zeros),
  // and the last issue is never folded.  At the top of the loop, tile q's
  // group runs into acc0.  Loads stay a ring ahead of the last tile that
  // both warpgroups can have given back.
  const int walk = walk_tiles(tiles);
  load_until(walk, S);
  issue(0, acc0);
#pragma unroll 1
  for (int q = 0; q + 1 < walk; q += 2) {
    load_until(walk, q + S - 1);
    issue(q + 1, acc1);
    wgmma_wait<1>();
    finish(q, acc0);
    load_until(walk, q + S);
    issue(q + 2, acc0);
    wgmma_wait<1>();
    finish(q + 1, acc1);
  }
  wgmma_wait<0>();

  // Merge the quad (the lanes of a row) and store.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st[h].sum_lanes(4);
    const int i = row0 + wrow + h * 8 + g;
    if (t == 0 && i < a.n) st[h].store(a, i, i < a.n_ok);
  }
}

// ---- host side ------------------------------------------------------------------

// The bytes a launch's TMA loads move: every tile every block walks (none
// for an empty split).  (The resident targets are read once a block by
// plain loads.)
template <int K, int NC>
long long staged_bytes(const Args& a, dim3 grid) {
  long long tiles = 0;
  for (unsigned s = 0; s < grid.x; ++s) {
    const Split<kCols> split(a.m_eff, grid.x, s);
    const int own = (split.end - split.begin + kCols - 1) / kCols;
    tiles += own > 0 ? walk_tiles(own) : 0;
  }
  return tiles * tile_bytes<K, NC>() * grid.y;
}

// Encode the call's tensor maps and launch (the launch timer starts after
// the encoding); the launch's staging goes to last_staging.  A map that does
// not encode fails the call.
template <int K, int NC, bool FLASH, bool DEN>
cudaError_t run(const Shape&, const Launch& l, const Args& a, dim3 grid, cudaStream_t stream) {
  using L = Layout<NC>;
  Maps maps = {};
  // With no source column no block loads anything (the kernel's empty
  // splits).
  if (a.m_eff > 0) {
    const long long m = a.m_eff, row = a.words * 4;
    // y is the wrapper's TF32 planes (2, m_eff, words), hi then lo.
    bool ok = encode<3>(&maps.y, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, a.y, {a.words, m, 2},
                        {4, row, m * row}, {kWords, kCols, 2}, CU_TENSOR_MAP_SWIZZLE_128B);
    if (!KernelMap<K>::kDot) {
      ok = ok && encode<1>(&maps.ysq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.ysq, {m}, {4},
                           {kCols}, CU_TENSOR_MAP_SWIZZLE_NONE);
    }
    ok = ok && encode<1>(&maps.sig, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.b, {m * NC}, {4},
                         {L::kSigBox}, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (!ok) return cudaErrorInvalidValue;
  }
  last_staging = Staging{L::kStages, 1, staged_bytes<K, NC>(a, grid)};
  Args args = a;
  void* params[] = {&args, &maps};
  return launch_kernel(l.fn, grid, dim3(kThreads), params, l.smem, stream);
}

template <int K, int NC, bool FLASH, bool DEN>
void fill(Launch* out) {
  out->fn = reinterpret_cast<const void*>(&one_chunk_large_d_kernel<K, NC, FLASH, DEN>);
  out->threads = kThreads;
  out->smem = Layout<NC>::kSmem;
  out->rows = kRows;
  out->run = &run<K, NC, FLASH, DEN>;
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

bool large_d_one_chunk_launch(const Shape& s, Launch* out) {
  // Rows of whole 16 bytes, one chunk; the float32 tiers.
  if (!s.large || s.bf16 || s.d <= 0 || s.d > kWords || s.d % 4 != 0) return false;
  switch (s.kernel) {
    case kGaussian: return pick_nc<kGaussian>(s, out);
    case kAbsExp: return pick_nc<kAbsExp>(s, out);
    case kInverseDistance: return pick_nc<kInverseDistance>(s, out);
    case kExponential: return pick_nc<kExponential>(s, out);
    default: return false;
  }
}

}  // namespace kmb
