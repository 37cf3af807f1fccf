// Small-D loop (D <= 8) in the wide-signal mode (E > 8): the port of the
// MXU accumulation mode of kmb_tpu/ops/product.py::_direct_kernel_body and
// ::_flash_kernel_body at D <= 8 (their VPU form with acc_mode="mxu"),
// e.g. the Nystrom sketch of the exact solvers (E = rank = 256).  As in
// the Pallas kernel, which forms `k_tile` once and multiplies it by the
// whole e_pad-wide signal block (product.py:244-253, b_spec at :577), each
// kernel value is computed once per launch for E <= 256: one block of the
// grid's z dimension holds up to 256 signal columns (16, 64 or 256; more
// than 256 take ceil(E / 256) blocks).
//
// A block owns kRows target rows (64 in the float32 tiers, 128 in bf16)
// and walks its split's source points in tiles of 32.  Every thread has
// two jobs, interleaved so that the elementwise work runs while the
// tensor cores multiply:
//   - consumer: warpgroup w takes row group w / 2 (64 rows) and column half
//     w % 2 (EB / 2 signal columns), and multiplies the tile's kernel
//     values (an A tile in shared memory, read with ldmatrix; the float32
//     tiers split each value into TF32 parts as they load it) by its half
//     of the staged signal tile with wgmma, A from registers;
//   - producer: thread (warp p, lane l) computes the kernel values of row
//     8p + l / 4 at columns 8i + 2(l % 4) + e of the NEXT tile (the
//     difference form and the map on the FP32 and special-function units,
//     as small_d.cuh; bf16 rounded), and writes them into the next A tile
//     between the start of this tile's wgmma groups and their waits.  The
//     flash scheme first forms the tile's logits, takes each row's tile max
//     over its quad and hands the rescale factor of the running state to
//     the consumers through shared memory.
// Staging: the wrapper lays out each tile of the signal contiguously in
// the shared order (ops/product.py, tile_wide_signal; in the float32 tiers
// each group of 8 source columns in WIDE_TF32_ORDER, so the producer
// writes column 2c + e of a group at A position c + 4e), and cp.async
// copies it as it lies, two tiles ahead of its product: a ring of three
// signal tiles, each with the next tile's source records.  One barrier a
// tile.
//
// Arithmetic and summation (wide.cuh):
//   float32 / float32x3 tiers, 3xTF32: each k step's hi.hi product starts
//     from zero (the tensor cores truncate as they accumulate) as one
//     wgmma group, its small terms lo.hi + hi.lo, chained over the tile in
//     an accumulator of their own, as another; the step waits for the first
//     only and adds it into the group sums on the FP32 units while the
//     small terms run.
//   bfloat16 tier: one bf16 pass per k step, chained in the group sums (the
//     weights' bf16 rounding, 2^-9, dominates the accumulator's
//     truncation).
// Groups of kGroupColumns source columns fold into the running sums, kept
// in the output rows (a read-modify-write per group; flash: rescaled
// lazily by the product of the factors since the last fold).  Row sums and
// the flash normaliser are f32 sums of the unrounded weights, per tile,
// group and run, kept by the producer.
//
// What bounds it on an H100 at E = 256: the signal product, 2 N M E flops
// in three TF32 passes at 495 TFLOP/s (bf16: one pass at 989); and the
// staged signal, which every block of kRows rows reads through L2 (8 bytes
// a value in the float32 tiers: 131072^2 at E = 256 moves 550 GB with 64
// rows a block; bf16, 2 bytes with 128 rows: 69 GB).  The float32 tiers'
// accumulators (three sets of 64 x 128 per warpgroup) leave room for 64
// rows a block only.

// Included by small_d_wide_{3,8}_{tf32,bf16}.cu, one object file each (the
// coordinate count KMB_DP and the tier KMB_BF16), so they build in parallel.
// Two switches, off in the package's build, take work out for
// tools/wide_breakdown.py (which times what is left, and discards the
// answers): KMB_NO_SIGNAL_LOADS stages the first two signal tiles only (the
// others reuse them), KMB_NO_KERNEL_VALUES forms tile 0's kernel values
// only.

#include "wide.cuh"

#if !defined(KMB_DP) || !defined(KMB_BF16)
#error "define KMB_DP (3 or 8) and KMB_BF16 (0 or 1)"
#endif

namespace kmb {
namespace {

constexpr bool kBf16 = KMB_BF16;
constexpr int kDp = KMB_DP;
constexpr int kRowGroups = kBf16 ? 2 : 1;       // groups of 64 target rows
constexpr int kRows = 64 * kRowGroups;          // target rows per block
constexpr int kThreads = 256 * kRowGroups;      // two warpgroups per row group
constexpr int kTile = 32;                       // source columns per tile (the product's K)
constexpr int kRec = kDp == 3 ? 4 : 8;          // words per staged source record
constexpr int kSteps = kBf16 ? kTile / 16 : kTile / 8;  // k steps per tile
constexpr int kPairs = kRows * kTile / kThreads;        // pairs a thread computes per tile
static_assert(kPairs == 8, "four blocks of two columns a thread");
// An A tile: kRows rows of kTile kernel values (f32, split into TF32 parts
// by the consumers as they load them; or bf16 pairs), padded to 36 / 20
// words a row so that ldmatrix is conflict-free.
constexpr int kAStride = (kBf16 ? kTile / 2 : kTile) + 4;
constexpr int kAWords = kRows * kAStride;
constexpr int kGroupTiles = kGroupColumns / kTile;
// Tiles in flight: the one multiplied, the next (its records being formed
// into kernel values), the one after it landing.
constexpr int kRing = 3;

template <int EB>
using Signal = WideSignal<kTile, EB, kBf16>;

// A ring of kRing signal tiles and source records; two A tiles and flash
// rescale factors.
template <int EB>
__host__ __device__ constexpr int smem_bytes() {
  return (kRing * (Signal<EB>::kWords + kTile * kRec) + 2 * (kAWords + kRows)) * 4;
}

// Stage signal tile `tile` of this block's E block (blockIdx.z): the
// wrapper lays out each tile of each part contiguously in the shared
// order (ops/product.py, tile_wide_signal), so it is copied as it lies.
template <int EB>
__device__ __forceinline__ void load_signal(unsigned* dst, const Args& a, int tile) {
  using Sig = Signal<EB>;
  constexpr int kPieces = Sig::kPartWords / 4;  // 16-byte pieces a part
  const size_t base = ((size_t)blockIdx.z * (a.ldb / kTile) + tile) * Sig::kPartWords;
  const unsigned* hi = static_cast<const unsigned*>(a.bt) + base;
  const unsigned* lo = static_cast<const unsigned*>(a.bt_lo) + base;
#pragma unroll
  for (int h = 0; h < (kPieces + kThreads - 1) / kThreads; ++h) {
    const int i = h * kThreads + threadIdx.x;
    if (kPieces % kThreads == 0 || i < kPieces) {
      cp_async16(dst + 4 * i, hi + 4 * i, true);
      if constexpr (!kBf16) cp_async16(dst + Sig::kPartWords + 4 * i, lo + 4 * i, true);
    }
  }
}

// The producer side of a thread: one target row, eight pairs per tile.
template <int K, bool FLASH>
struct Producer {
  using Map = KernelMap<K>;
  static constexpr bool kFlash = FLASH;
  float xr[kDp];
  int lrow, row, c4, diag_col;  // the row in the block and in all; its quad lane;
                                // its diagonal's local column, or -1
  float f[kPairs];        // the tile's logits (flash) or kernel values
  float tsum = 0.f, gsum = 0.f, sum = 0.f;  // row sums: tile, group, run
  float m = kNegInf;                        // flash: running base-2 max
  int in_group = 0;

  __device__ Producer(const Args& a, int row0, int r, int lane4)
      : lrow(r), row(row0 + r), c4(lane4) {
    const float* x = static_cast<const float*>(a.x);
#pragma unroll
    for (int k = 0; k < kDp; ++k) xr[k] = row < a.n ? x[(size_t)row * kDp + k] : 0.f;
    const long long jd = (long long)row + a.shift;
    diag_col = (a.diag && jd >= 0 && jd < a.m_eff) ? (int)jd : -1;
  }

  // The signed, scaled form of the row against a source record.
  __device__ __forceinline__ float form(const float* v) const {
    float g;
    if constexpr (Map::kDot) {
      g = xr[0] * v[0];
#pragma unroll
      for (int k = 1; k < kDp; ++k) g = fmaf(xr[k], v[k], g);
    } else {
      float t = xr[0] - v[0];
      g = Map::kNegate ? -t * t : t * t;
#pragma unroll
      for (int k = 1; k < kDp; ++k) {
        t = xr[k] - v[k];
        g = fmaf(Map::kNegate ? -t : t, t, g);
      }
    }
    return g;
  }

  // Pairs [P0, P1) of the tile at j0: pair p is column 8(p / 2) + 2 c4 +
  // p % 2.  MASKED: the tile holds the split's ragged end or the diagonal.
  template <bool MASKED, int P0, int P1>
  __device__ __forceinline__ void forms(const float* recs, int j0, int end) {
#pragma unroll
    for (int p = P0; p < P1; ++p) {
      const int c = 8 * (p / 2) + 2 * c4 + p % 2;
      float v[kRec];
      load_vec<kRec>(recs + c * kRec, v);
      const float g = form(v);
      float s = FLASH ? Map::logit(g) : Map::value(g);
      if (MASKED && (j0 + c >= end || j0 + c == diag_col)) s = FLASH ? kNegInf : 0.f;
      f[p] = s;
    }
  }

  // Flash: the tile's row max over the quad, one rescale of the row's sums;
  // returns the factor for the consumers' sums.
  __device__ __forceinline__ float rescale() {
    float mx = kNegInf;
#pragma unroll
    for (int p = 0; p < kPairs; ++p) mx = fmaxf(mx, f[p]);
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
    float alpha = 1.f;
    if (mx > m) {
      alpha = ex2(m - mx);
      sum *= alpha;
      gsum *= alpha;
      m = mx;
    }
    return alpha;
  }

  // The weights of pairs [P0, P1) into the A tile, and their row sums.
  template <bool MASKED, int P0, int P1>
  __device__ __forceinline__ void emit(unsigned* a_tile) {
#pragma unroll
    for (int p = P0; p < P1; p += 2) {
      float w[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = f[p + e];
        if constexpr (FLASH) {
          const float logit = v;
          v = ex2(logit - m);
          // A masked logit of a row with no valid column yet would give
          // exp2(0) = 1.
          if (MASKED && logit == kNegInf) v = 0.f;
        }
        tsum += v;
        w[e] = v;
      }
      unsigned* r = a_tile + lrow * kAStride;
      if constexpr (kBf16) {
        r[4 * (p / 2) + c4] = pack_bf16(round_bf16(w[0]), round_bf16(w[1]));
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) r[8 * (p / 2) + c4 + 4 * e] = __float_as_uint(w[e]);
      }
    }
  }

  __device__ __forceinline__ void end_tile() {
    gsum += tsum;
    tsum = 0.f;
    if (++in_group == kGroupTiles) {
      sum += gsum;
      gsum = 0.f;
      in_group = 0;
    }
  }

  // Row sums (direct, when read) or the flash state (m, l) of E block 0,
  // merged over the quad; rows past n_ok get the empty state.
  __device__ __forceinline__ void store(const Args& a) {
    sum += gsum;
    sum += __shfl_xor_sync(kFullMask, sum, 1);
    sum += __shfl_xor_sync(kFullMask, sum, 2);
    if (c4 != 0 || blockIdx.z != 0 || row >= a.n) return;
    const bool ok = row < a.n_ok;
    const size_t i = (size_t)blockIdx.x * a.n + row;
    if constexpr (FLASH) {
      a.aux0[i] = ok ? m : kNegInf;
      a.aux1[i] = ok ? sum : 0.f;
    } else if (a.aux0 != nullptr) {
      a.aux0[i] = ok ? sum : 0.f;
    }
  }
};

// The consumer side of a thread: rows g and g + 8 of its warp's 16, the
// warpgroup's EB / 2 signal columns.
template <int EB, bool FLASH>
struct Consumer {
  static constexpr int N = EB / 2;   // signal columns of the warpgroup (wgmma N)
  static constexpr int NB = N / 8;   // accumulator blocks
  using Sig = Signal<EB>;
  float grp[NB][4];                  // the group's sums
  float big[kBf16 ? 1 : NB][4];      // 3xTF32: a k step's hi.hi product
  float small[kBf16 ? 1 : NB][4];    // 3xTF32: the tile's small terms
  float scale[2] = {1.f, 1.f};       // flash: the factor since the last fold
  int arow, half, g, t;              // the warp's first row; column half; lane
  int in_group = 0;
  bool folded = false;

  __device__ Consumer(int warp, int lane) {
    const int wg = warp / 4;
    arow = (wg / 2) * 64 + (warp % 4) * 16;
    half = wg % 2;
    g = lane / 4;
    t = lane % 4;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) grp[n][k] = 0.f;
  }

  // The A fragments of k step s (float32 tiers: split into TF32 hi and lo
  // parts).
  __device__ __forceinline__ void load_a(const unsigned* a_tile, int s, unsigned (&ah)[4],
                                         unsigned (&al)[4]) const {
    const int lane = 4 * g + t, r8 = lane % 8, q = lane / 8;
    const int off = (arow + (q % 2) * 8 + r8) * kAStride + s * 8 + (q / 2) * 4;
    ldmatrix_x4(ah, a_tile + off);
    if constexpr (!kBf16) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned v = ah[k];
        ah[k] = tf32_hi(v);
        al[k] = tf32_lo(v, ah[k]);
      }
    }
  }

  // The warpgroup's half of a staged signal part.
  __device__ __forceinline__ const unsigned* part(const unsigned* p) const {
    return p + half * NB * 8 * Sig::kRowWords;
  }

  // Flash: rescale the group's sums by this tile's factors.
  __device__ __forceinline__ void rescale(const float* alpha) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float al = alpha[arow + g + 8 * h];
      if (al != 1.f) {
        scale[h] *= al;
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) grp[n][2 * h + e] *= al;
      }
    }
  }

  static __device__ __forceinline__ void add(float (&dst)[NB][4], float (&p)[NB][4]) {
    fence_acc(p);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[n][k] += p[n][k];
  }

  // 3xTF32, k step S of the tile and the rest: start its hi.hi product as
  // one group and its small terms as another, run work.at<S>(), wait for
  // the first group only (the small terms run on the tensor cores while
  // the hi.hi product is added on the FP32 units), add it.  The A
  // registers alternate between two sets: step S's small terms may still
  // read its set while step S + 1 loads the other.
  template <int S, class Work>
  __device__ __forceinline__ void tf32_steps(const unsigned* a_tile, const unsigned* sig,
                                             Work& work, unsigned (&ah)[2][4],
                                             unsigned (&al)[2][4]) {
    if constexpr (S < kSteps) {
      const unsigned* hi = part(sig);
      const unsigned* lo = part(sig + Sig::kPartWords);
      load_a(a_tile, S, ah[S % 2], al[S % 2]);
      fence_acc(big);
      fence_acc(small);
      wgmma_fence();
      wgmma_rs<N, false>(big, ah[S % 2], Sig::desc(hi, S), 0);
      wgmma_commit();
      wgmma_rs<N, false>(small, al[S % 2], Sig::desc(hi, S), S > 0);
      wgmma_rs<N, false>(small, ah[S % 2], Sig::desc(lo, S), 1);
      wgmma_commit();
      work.template at<S>();
      wgmma_wait<1>();  // this step's hi.hi product (and all before it)
      fence_regs(ah[(S + 1) % 2]);
      fence_regs(al[(S + 1) % 2]);
      add(grp, big);
      tf32_steps<S + 1>(a_tile, sig, work, ah, al);
    }
  }

  // One tile: its signal product into the group's sums, with the work of
  // the next tile's kernel values inside (work.at<s>() for each k step s
  // in the float32 tiers, work.at<0>() once in bf16).
  template <class Work>
  __device__ __forceinline__ void tile(const unsigned* a_tile, const unsigned* sig, Work& work) {
    if constexpr (kBf16) {
      unsigned a[kSteps][4], unused[4];
#pragma unroll
      for (int s = 0; s < kSteps; ++s) load_a(a_tile, s, a[s], unused);
      fence_acc(grp);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSteps; ++s) wgmma_rs<N, true>(grp, a[s], Sig::desc(part(sig), s), 1);
      wgmma_commit();
      work.template at<0>();
      wgmma_wait<0>();
      fence_regs(a);
      fence_acc(grp);
    } else {
      unsigned ah[2][4], al[2][4];
      tf32_steps<0>(a_tile, sig, work, ah, al);
      wgmma_wait<0>();
      fence_regs(ah);
      fence_regs(al);
      add(grp, small);
    }
  }

  // Fold the group's sums into the running sums in the output rows (flash:
  // those rescaled by the factors since the last fold); `last`: the final
  // fold, rows past n_ok get zeros.
  __device__ __forceinline__ void fold(const Args& a, int row0, bool last) {
    const size_t ep = (size_t)gridDim.z * EB;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + arow + g + 8 * h;
      if (i < a.n) {
        const bool ok = !last || i < a.n_ok;
        float* out = a.out + ((size_t)blockIdx.x * a.n + i) * ep + blockIdx.z * EB + half * N +
                     2 * t;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          float2 v = make_float2(grp[n][2 * h], grp[n][2 * h + 1]);
          if (folded) {
            const float2 o = *reinterpret_cast<const float2*>(out + 8 * n);
            v.x = fmaf(o.x, scale[h], v.x);
            v.y = fmaf(o.y, scale[h], v.y);
          }
          *reinterpret_cast<float2*>(out + 8 * n) = ok ? v : make_float2(0.f, 0.f);
        }
      }
      scale[h] = 1.f;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) grp[n][k] = 0.f;
    folded = true;
  }

  __device__ __forceinline__ void end_tile(const Args& a, int row0) {
    if (++in_group == kGroupTiles) {
      fold(a, row0, false);
      in_group = 0;
    }
  }
};

// The kernel values of the next tile into its A buffer, spread over the
// k steps of this tile: float32 tiers, the forms in steps 0-1, the flash
// rescale and the weights in steps 2-3; bf16, all at step 0.  MASKED: the
// next tile holds the split's ragged end or the diagonal.
template <class P, bool MASKED>
struct NextTile {
  P& pr;
  const float* recs;
  unsigned* a_tile;
  float* alpha;  // flash: the rescale factor of each row
  int j0, end;

  __device__ __forceinline__ void publish() {
    if constexpr (P::kFlash) {
      const float al = pr.rescale();
      if (pr.c4 == 0) alpha[pr.lrow] = al;
    }
  }

  template <int S>
  __device__ __forceinline__ void at() {
#ifdef KMB_NO_KERNEL_VALUES
    if (j0 > 0) return;
#endif
    constexpr int kHalf = kPairs / 2;
    if constexpr (kBf16) {
      pr.template forms<MASKED, 0, kPairs>(recs, j0, end);
      publish();
      pr.template emit<MASKED, 0, kPairs>(a_tile);
      pr.end_tile();
    } else if constexpr (S == 0) {
      pr.template forms<MASKED, 0, kHalf>(recs, j0, end);
    } else if constexpr (S == 1) {
      pr.template forms<MASKED, kHalf, kPairs>(recs, j0, end);
    } else if constexpr (S == 2) {
      publish();
      pr.template emit<MASKED, 0, kHalf>(a_tile);
    } else {
      pr.template emit<MASKED, kHalf, kPairs>(a_tile);
      pr.end_tile();
    }
  }

  // All of it, with no tile to multiply beside it (the first tile).
  __device__ __forceinline__ void all() {
    at<0>();
    if constexpr (!kBf16) {
      at<1>();
      at<2>();
      at<3>();
    }
  }
};

// Tile q's NextTile: its records from ring slot q % kRing, into A buffer
// q % 2.
template <bool MASKED, class P>
__device__ __forceinline__ NextTile<P, MASKED> next_tile(P& pr, float* rec_buf, unsigned* a_buf,
                                                         float* alpha_buf, int q, int j0,
                                                         int end) {
  return {pr, rec_buf + q % kRing * kTile * kRec, a_buf + q % 2 * kAWords,
          alpha_buf + q % 2 * kRows, j0, end};
}

// The last tile has no next one.
struct NoTile {
  template <int S>
  __device__ __forceinline__ void at() {}
};

template <int K, int EB, bool FLASH>
__global__ void __launch_bounds__(kThreads, 1) small_d_wide_kernel(const Args a) {
  using Sig = Signal<EB>;
  using P = Producer<K, FLASH>;
  using C = Consumer<EB, FLASH>;
  constexpr int kSig = Sig::kWords;
  extern __shared__ __align__(128) unsigned smem[];
  unsigned* sig_buf = smem;                       // [kRing][kSig]
  float* rec_buf = reinterpret_cast<float*>(sig_buf + kRing * kSig);  // [kRing][kTile * kRec]
  unsigned* a_buf = reinterpret_cast<unsigned*>(rec_buf + kRing * kTile * kRec);  // [2][kAWords]
  float* alpha_buf = reinterpret_cast<float*>(a_buf + 2 * kAWords);  // [2][kRows]

  const Split<kTile> split(a);
  const int row0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  P pr(a, row0, 8 * warp + lane / 4, lane % 4);
  C co(warp, lane);
  const float* y = static_cast<const float*>(a.y);
  // The block's diagonal runs through source columns [dlo, dhi).
  const long long dlo = (long long)row0 + a.shift, dhi = dlo + kRows;
  const int tiles = (split.end - split.begin + kTile - 1) / kTile;

  auto first = [&](int q) { return split.begin + q * kTile; };
  auto masked = [&](int q) {
    const int j0 = first(q);
    return j0 + kTile > split.end || (a.diag && j0 < dhi && j0 + kTile > dlo);
  };
  // Tile q's source records (zero past the split's end) into ring slot
  // q % kRing.
  auto load_records = [&](int q) {
    if (q >= tiles) return;
    float* recs = rec_buf + q % kRing * kTile * kRec;
    const int j0 = first(q);
    if constexpr (kDp == 8) {
      const int c = threadIdx.x / 2, p = threadIdx.x % 2;  // record, 16-byte piece
      if (c < kTile) {
        const int j = j0 + c;
        const bool valid = j < split.end;
        cp_async16(recs + c * kRec + 4 * p, y + (size_t)(valid ? j : 0) * kDp + 4 * p, valid);
      }
    } else if (threadIdx.x < kTile * kDp) {
      const int c = threadIdx.x / kDp, k = threadIdx.x % kDp;
      const int j = j0 + c;
      const bool valid = j < split.end;
      cp_async_small<4>(recs + c * kRec + k, y + (size_t)(valid ? j : 0) * kDp + k, valid);
    }
  };
  // One cp.async group: tile q's signal (ring slot q % kRing) and tile
  // q + 1's records, both read in iteration q.  A group past the end is
  // empty and keeps the count.
  auto load_group = [&](int q) {
#ifdef KMB_NO_SIGNAL_LOADS
    if (q < 2 && q < tiles) load_signal<EB>(sig_buf + q % kRing * kSig, a, first(q) / kTile);
#else
    if (q < tiles) load_signal<EB>(sig_buf + q % kRing * kSig, a, first(q) / kTile);
#endif
    load_records(q + 1);
    cp_async_commit();
  };

  if (tiles > 0) {
    load_records(0);
    cp_async_commit();
    load_group(0);
    load_group(1);
    cp_async_wait<2>();  // tile 0's records have landed (for this thread)
    __syncthreads();     // ... for all
    // Tile 0's kernel values, with no tile to multiply beside them.
    if (masked(0)) {
      auto work = next_tile<true>(pr, rec_buf, a_buf, alpha_buf, 0, first(0), split.end);
      work.all();
    } else {
      auto work = next_tile<false>(pr, rec_buf, a_buf, alpha_buf, 0, first(0), split.end);
      work.all();
    }
    cp_async_wait<1>();    // group 0 has landed (for this thread)
    fence_async_shared();  // ... for wgmma's reads too
    __syncthreads();       // ... for all; and A tile 0 is written
  }
  for (int q = 0; q < tiles; ++q) {
    load_group(q + 2);
    if constexpr (FLASH) co.rescale(alpha_buf + q % 2 * kRows);
    const unsigned* a_tile = a_buf + q % 2 * kAWords;
    const unsigned* sig = sig_buf + q % kRing * kSig;
    // This tile's product, the next tile's kernel values beside it.
    const int qn = q + 1;
    if (qn >= tiles) {
      NoTile work;
      co.tile(a_tile, sig, work);
    } else if (masked(qn)) {
      auto work = next_tile<true>(pr, rec_buf, a_buf, alpha_buf, qn, first(qn), split.end);
      co.tile(a_tile, sig, work);
    } else {
      auto work = next_tile<false>(pr, rec_buf, a_buf, alpha_buf, qn, first(qn), split.end);
      co.tile(a_tile, sig, work);
    }
    co.end_tile(a, row0);
    cp_async_wait<1>();    // group q + 1 has landed (for this thread)
    fence_async_shared();  // ... for wgmma's reads too
    __syncthreads();       // ... for all; and every thread is done with tile q
  }
  co.fold(a, row0, true);
  pr.store(a);
}

// Runtime shape -> instantiation, for this file's KMB_DP and KMB_BF16.
template <int K, int EB, bool FLASH>
void fill(Launch* out) {
  out->fn = reinterpret_cast<const void*>(&small_d_wide_kernel<K, EB, FLASH>);
  out->threads = kThreads;
  out->smem = smem_bytes<EB>();
  out->rows = kRows;
}

template <int K, int EB>
bool pick_scheme(const Shape& s, Launch* out) {
  if (s.flash) {
    if constexpr (K == kInverseDistance) {
      return false;  // only kernels with a log form run the flash scheme
    } else {
      fill<K, EB, true>(out);
      return true;
    }
  }
  fill<K, EB, false>(out);
  return true;
}

template <int K>
bool pick_eb(const Shape& s, Launch* out) {
  switch (s.nc) {
    case 16: return pick_scheme<K, 16>(s, out);
    case 64: return pick_scheme<K, 64>(s, out);
    case 256: return pick_scheme<K, 256>(s, out);
    default: return false;  // the wrapper takes E blocks of 16, 64 or 256
  }
}

}  // namespace

bool KMB_SMALL_D_WIDE_LAUNCH(const Shape& s, Launch* out) {
  if (s.large || s.d != kDp || s.bf16 != kBf16 || s.nc <= 8) return false;
  switch (s.kernel) {
    case kGaussian: return pick_eb<kGaussian>(s, out);
    case kAbsExp: return pick_eb<kAbsExp>(s, out);
    case kInverseDistance: return pick_eb<kInverseDistance>(s, out);
    case kExponential: return pick_eb<kExponential>(s, out);
    default: return false;
  }
}

}  // namespace kmb
