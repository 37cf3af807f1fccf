// Small-D loop (D <= 8) of the streaming kernel product: the difference form
// on the FP32 units, one special-function op per pair.
//
// What bounds it: one MUFU op (exp2 or rsqrt) per pair, at 16 per clock per
// SM, against 128 issue slots per clock per SM.  So the loop stays bound by
// the special-function units only while it issues at most about 7 other
// instructions per pair.  As designed, for D = 3 and one signal column, the
// direct scheme issues per pair:
//   3 FADD (coordinate differences) + 1 FMUL + 2 FFMA (signed sum of
//   squares) + 1 MUFU + 1 FFMA (signal) = 7 FP32 ops and the MUFU op,
// plus 1/4 of an LDS.128 (one source record (y0, y1, y2, b0) serves the four
// rows of a thread) and 1/16 of a loop branch.  The row sum, when it is read,
// adds one FADD; bf16 rounding adds four integer ops (round_bf16 keeps
// the conversion instruction off the special-function units).  Everything else is
// moved out of the pair loop:
//   - DEN (row sums read) and RND (bf16 tier) are template parameters;
//   - the tiles that hold a block's diagonal or its ragged end are peeled
//     into a masked loop, so full tiles have no compare per pair, and their
//     trip count is a constant, unrolled by 16;
//   - rows past n_ok are computed like the others and stored as the empty
//     state, so no row test runs in the loop;
//   - exp2 and rsqrt are the single-instruction approximations (ex2.approx,
//     rsqrt.approx; relative error below 2^-22);
//   - the form is a sum of squares, so it needs no clamp before rsqrt.
// The difference form is kept for its accuracy: the expanded form
// |x|^2 + |y|^2 - 2<x, y> would cancel for near points, which is why
// kmb_tpu's kernel uses the VPU difference form at D <= 8
// (kmb_tpu/ops/product.py:531-535).

// Included by small_d_{3,8}_{direct,flash}.cu, one object file each (the
// coordinate count KMB_DP and the scheme KMB_FLASH), so they build in
// parallel.

#include "common.cuh"

#if !defined(KMB_DP) || !defined(KMB_FLASH)
#error "define KMB_DP (3 or 8) and KMB_FLASH (0 or 1)"
#endif

namespace kmb {
namespace {

constexpr int kThreads = 128;                 // threads per block
constexpr int kRowsPerThread = 4;
constexpr int kBlockRows = kThreads * kRowsPerThread;  // target rows per block
constexpr int kTile = 128;                    // source records staged per tile

// A staged source record: DP coordinates, then NC signal values, padded to a
// whole number of float4 so one LDS.128 reads four of its values.
template <int DP, int NC>
__host__ __device__ constexpr int record_width() { return (DP + NC + 3) / 4 * 4; }

template <int K, int DP, int NC, bool FLASH, bool DEN, bool RND>
struct SmallD {
  using Map = KernelMap<K>;
  using State = RowState<NC, FLASH, DEN, RND>;
  static constexpr int W = record_width<DP, NC>();

  // The signed, scaled form of row coordinates xr against a source record.
  static __device__ __forceinline__ float form(const float (&xr)[DP], const float* v) {
    float g;
    if constexpr (Map::kDot) {
      g = xr[0] * v[0];
#pragma unroll
      for (int k = 1; k < DP; ++k) g = fmaf(xr[k], v[k], g);
    } else {
      float t = xr[0] - v[0];
      g = Map::kNegate ? -t * t : t * t;
#pragma unroll
      for (int k = 1; k < DP; ++k) {
        t = xr[k] - v[k];
        g = fmaf(Map::kNegate ? -t : t, t, g);
      }
    }
    return g;
  }

  static __device__ __forceinline__ void add(State& st, float g, const float* bj) {
    if constexpr (FLASH) {
      st.add_logit(Map::logit(g), bj);
    } else {
      st.add_value(Map::value(g), bj);
    }
  }

  // One source record against every row of the thread; MASKED: skip column
  // j where it is a row's diagonal (skip[r]).
  template <bool MASKED>
  static __device__ __forceinline__ void visit(const float* rec, const float (&xr)[kRowsPerThread][DP],
                                               State (&st)[kRowsPerThread], int j,
                                               const int (&skip)[kRowsPerThread]) {
    float v[W];
    load_vec<W>(rec, v);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float g = form(xr[r], v);
      if (!MASKED || j != skip[r]) add(st[r], g, v + DP);
    }
  }
};

template <int K, int DP, int NC, bool FLASH, bool DEN, bool RND>
__global__ void __launch_bounds__(kThreads) small_d_kernel(const Args a) {
  using S = SmallD<K, DP, NC, FLASH, DEN, RND>;
  constexpr int W = S::W;
  __shared__ __align__(16) float recs[kTile][W];

  const Split<kTile> split(a);
  const int row0 = blockIdx.y * kBlockRows;
  const float* x = static_cast<const float*>(a.x);
  const float* y = static_cast<const float*>(a.y);

  float xr[kRowsPerThread][DP];
  int skip[kRowsPerThread];  // local column on the global diagonal, or -1
  typename S::State st[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = row0 + r * kThreads + threadIdx.x;
#pragma unroll
    for (int k = 0; k < DP; ++k) xr[r][k] = i < a.n ? x[(size_t)i * DP + k] : 0.f;
    const long long jd = (long long)i + a.shift;
    skip[r] = (a.diag && jd >= 0 && jd < a.m_eff) ? (int)jd : -1;
  }
  // The block's diagonal runs through source columns [dlo, dhi).
  const long long dlo = (long long)row0 + a.shift, dhi = dlo + kBlockRows;

  for (int j0 = split.begin; j0 < split.end; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    {
      const int j = j0 + threadIdx.x;
      const bool in = j < split.end;
      float* rec = recs[threadIdx.x];
#pragma unroll
      for (int k = 0; k < DP; ++k) rec[k] = in ? y[(size_t)j * DP + k] : 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) rec[DP + c] = in ? a.b[(size_t)j * NC + c] : 0.f;
#pragma unroll
      for (int k = DP + NC; k < W; ++k) rec[k] = 0.f;
    }
    __syncthreads();

    const bool ragged = j0 + kTile > split.end;
    const bool on_diagonal = a.diag && j0 < dhi && j0 + kTile > dlo;
    if (!ragged && !on_diagonal) {
#pragma unroll 16
      for (int jj = 0; jj < kTile; ++jj) S::template visit<false>(recs[jj], xr, st, 0, skip);
    } else {
      const int jn = split.end - j0 < kTile ? split.end - j0 : kTile;
      for (int jj = 0; jj < jn; ++jj) S::template visit<true>(recs[jj], xr, st, j0 + jj, skip);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = row0 + r * kThreads + threadIdx.x;
    if (i < a.n) st[r].store(a, i, i < a.n_ok);
  }
}

// Runtime shape -> instantiation, for this file's KMB_DP and KMB_FLASH.
template <int K, int NC, bool DEN, bool RND>
void fill(Launch* out) {
  out->fn = reinterpret_cast<const void*>(&small_d_kernel<K, KMB_DP, NC, KMB_FLASH, DEN, RND>);
  out->threads = kThreads;
  out->smem = 0;
  out->rows = kBlockRows;
}

template <int K, int NC>
void pick_den_rnd(bool den, bool rnd, Launch* out) {
#if KMB_FLASH
  (void)den;  // the flash scheme keeps its normaliser, never row sums
  if (rnd) fill<K, NC, false, true>(out); else fill<K, NC, false, false>(out);
#else
  if (den) {
    if (rnd) fill<K, NC, true, true>(out); else fill<K, NC, true, false>(out);
  } else {
    if (rnd) fill<K, NC, false, true>(out); else fill<K, NC, false, false>(out);
  }
#endif
}

template <int K>
bool pick_nc(const Shape& s, Launch* out) {
  switch (s.nc) {
    case 1: pick_den_rnd<K, 1>(s.den, s.bf16, out); return true;
    case 2: pick_den_rnd<K, 2>(s.den, s.bf16, out); return true;
    case 4: pick_den_rnd<K, 4>(s.den, s.bf16, out); return true;
    case 8: pick_den_rnd<K, 8>(s.den, s.bf16, out); return true;
    default: return false;  // the wrapper pads the signal to 1, 2, 4 or 8
  }
}

}  // namespace

bool KMB_SMALL_D_LAUNCH(const Shape& s, Launch* out) {
  if (s.d != KMB_DP || s.flash != (KMB_FLASH != 0)) return false;
  switch (s.kernel) {
    case kGaussian: return pick_nc<kGaussian>(s, out);
    case kAbsExp: return pick_nc<kAbsExp>(s, out);
#if !KMB_FLASH  // only kernels with a log form run the flash scheme
    case kInverseDistance: return pick_nc<kInverseDistance>(s, out);
#endif
    case kExponential: return pick_nc<kExponential>(s, out);
    default: return false;
  }
}

}  // namespace kmb
