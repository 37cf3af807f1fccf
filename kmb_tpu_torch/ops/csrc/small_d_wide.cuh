// Small-D loop (D <= 8) in the wide-signal mode (E > 8): the difference
// form and the map on the FP32 and special-function units, as in
// small_d.cuh, and the signal product of each tile on the tensor cores
// (wide.cuh: 3xTF32 in the float32 tiers, one bf16 pass in the bfloat16
// tier).  The port of the MXU accumulation mode of
// kmb_tpu/ops/product.py::_direct_kernel_body and ::_flash_kernel_body at
// D <= 8 (their VPU form with acc_mode="mxu"), e.g. the Nystrom sketch of
// the exact solvers (E = rank).
//
// A block owns 128 target rows, two warpgroups of 64, and walks its
// split's source points in tiles of 64, double-buffered with cp.async:
// the points (D coordinates a record) and the signal tile (64 source
// columns x EB signal columns).  Thread (g, t) of warp w computes the
// kernel values of rows 16w + g and 16w + g + 8 at columns 8j + 2t and
// 8j + 2t + 1, the accumulator layout wide.cuh multiplies from registers,
// one 8-column block (bf16: two) per k step, while the previous step's
// wgmma group runs.  The flash scheme first forms the tile's logits (32
// registers), takes the tile's row max and rescales each row once, then
// exponentiates per step.
//
// What bounds it on an H100: at E = 256 the signal product, 2 N M E flops
// in three TF32 passes at 495 TFLOP/s (bf16: one pass at 989), against
// one transcendental per pair and EB block on the special-function units;
// the kernel values are computed once per block of EB signal columns.

// Included by small_d_wide_{3,8}_{tf32,bf16}.cu, one object file each (the
// coordinate count KMB_DP and the tier KMB_BF16), so they build in parallel.

#include "wide.cuh"

#if !defined(KMB_DP) || !defined(KMB_BF16)
#error "define KMB_DP (3 or 8) and KMB_BF16 (0 or 1)"
#endif

namespace kmb {
namespace {

constexpr bool kBf16 = KMB_BF16;
constexpr int kDp = KMB_DP;
constexpr int kThreads = kWideThreads;
constexpr int kRows = 128;                // target rows per block, 16 a warp
constexpr int kTile = 64;                 // source columns per tile (the product's K)
constexpr int kRec = kDp == 3 ? 4 : 8;    // words per staged source record

template <int EB>
using Signal = WideSignal<kTile, EB, kBf16>;

// A buffer: the signal tile, then the tile's source records.
template <int EB>
__host__ __device__ constexpr int buf_words() { return Signal<EB>::kWords + kTile * kRec; }

template <int EB>
__host__ __device__ constexpr int smem_bytes() { return 2 * buf_words<EB>() * 4; }

template <int K, int EB, bool FLASH>
struct SmallDWide {
  using Map = KernelMap<K>;
  using Sig = Signal<EB>;
  static constexpr int NB = Sig::kBlocks;

  // The signed, scaled form of row coordinates xr against a source record.
  static __device__ __forceinline__ float form(const float (&xr)[kDp], const float* v) {
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

  // One tile: its signal product and row sums (direct) or flash state into
  // the rows' state.  MASKED: the tile holds the split's ragged end or the
  // diagonal.
  template <bool MASKED>
  static __device__ __forceinline__ void tile(const float (&xr)[2][kDp], const float* recs,
                                              const unsigned* sig, int j0, int end,
                                              const int (&diag_col)[2], int t,
                                              WideRows<NB, FLASH>& st) {
    float tsum[2] = {0.f, 0.f};
    if constexpr (FLASH) {
      float f[kTile / 8][4];  // logits, accumulator layout
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          float v[kRec];
          load_vec<kRec>(recs + c * kRec, v);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float s = Map::logit(form(xr[h], v));
            if (MASKED && (j0 + c >= end || j0 + c == diag_col[h])) s = kNegInf;
            f[j][2 * h + e] = s;
          }
        }
      st.rescale(f);
      auto weights = [&](int j, float (&w)[4]) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int h = k / 2;
          float p = ex2(f[j][k] - st.m[h]);
          // A masked logit of a row with no valid column yet would give
          // exp2(0) = 1.
          if (MASKED && f[j][k] == kNegInf) p = 0.f;
          tsum[h] += p;
          w[k] = kBf16 ? round_bf16(p) : p;
        }
      };
      Sig::contract(st.grp, sig, weights);
    } else {
      auto weights = [&](int j, float (&w)[4]) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          float v[kRec];
          load_vec<kRec>(recs + c * kRec, v);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float k = Map::value(form(xr[h], v));
            if (MASKED && (j0 + c >= end || j0 + c == diag_col[h])) k = 0.f;
            tsum[h] += k;
            w[2 * h + e] = kBf16 ? round_bf16(k) : k;
          }
        }
      };
      Sig::contract(st.grp, sig, weights);
    }
    st.end_tile(tsum, kTile);
  }
};

template <int K, int EB, bool FLASH>
__global__ void __launch_bounds__(kThreads, 1) small_d_wide_kernel(const Args a) {
  using S = SmallDWide<K, EB, FLASH>;
  using Sig = typename S::Sig;
  constexpr int NB = S::NB;
  constexpr int kBuf = buf_words<EB>();
  extern __shared__ __align__(128) unsigned smem[];

  const Split<kTile> split(a);
  const int row0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rbase = row0 + warp * 16 + g;  // the thread's rows: rbase, rbase + 8
  const float* x = static_cast<const float*>(a.x);
  const float* y = static_cast<const float*>(a.y);

  float xr[2][kDp];
  int diag_col[2];  // local source column on the global diagonal, or -1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = rbase + 8 * h;
#pragma unroll
    for (int k = 0; k < kDp; ++k) xr[h][k] = i < a.n ? x[(size_t)i * kDp + k] : 0.f;
    const long long jd = (long long)i + a.shift;
    diag_col[h] = (a.diag && jd >= 0 && jd < a.m_eff) ? (int)jd : -1;
  }
  // The block's diagonal runs through source columns [dlo, dhi).
  const long long dlo = (long long)row0 + a.shift, dhi = dlo + kRows;

  WideRows<NB, FLASH> st;

  const int tiles = (split.end - split.begin + kTile - 1) / kTile;
  // Stage tile q in buffer q % 2: the signal tile and the records (zero
  // past the split's end).
  auto load = [&](int q) {
    if (q < tiles) {
      unsigned* buf = smem + (q % 2) * kBuf;
      const int j0 = split.begin + q * kTile;
      Sig::template load<kThreads>(buf, a, j0);
      float* recs = reinterpret_cast<float*>(buf + Sig::kWords);
      if constexpr (kDp == 8) {
        const int c = threadIdx.x / 2, p = threadIdx.x % 2;  // record, 16-byte piece
        if (c < kTile) {
          const int j = j0 + c;
          const bool valid = j < split.end;
          cp_async16(recs + c * kRec + 4 * p, y + (size_t)(valid ? j : 0) * kDp + 4 * p, valid);
        }
      } else {
#pragma unroll
        for (int h = 0; h < (kTile * kDp + kThreads - 1) / kThreads; ++h) {
          const int idx = h * kThreads + threadIdx.x;
          if (idx < kTile * kDp) {
            const int c = idx / kDp, k = idx % kDp;
            const int j = j0 + c;
            const bool valid = j < split.end;
            cp_async_small<4>(recs + c * kRec + k, y + (size_t)(valid ? j : 0) * kDp + k, valid);
          }
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  load(0);
  for (int q = 0; q < tiles; ++q) {
    cp_async_wait<0>();  // tile q has landed (for this thread)
    fence_async_shared();
    __syncthreads();     // ... for all; and every thread is done with tile q - 1
    load(q + 1);
    const unsigned* buf = smem + (q % 2) * kBuf;
    const float* recs = reinterpret_cast<const float*>(buf + Sig::kWords);
    const int j0 = split.begin + q * kTile;
    const bool masked = j0 + kTile > split.end || (a.diag && j0 < dhi && j0 + kTile > dlo);
    if (masked) {
      S::template tile<true>(xr, recs, buf, j0, split.end, diag_col, t, st);
    } else {
      S::template tile<false>(xr, recs, buf, j0, split.end, diag_col, t, st);
    }
  }
  cp_async_wait<0>();
  st.store(a, rbase, t);
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
    case 32: return pick_scheme<K, 32>(s, out);
    case 64: return pick_scheme<K, 64>(s, out);
    default: return false;  // the wrapper takes E blocks of 16, 32 or 64
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
