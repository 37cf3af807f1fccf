// The epilogue of a large-D tile (D > 8, E <= 8) on the form product's
// wgmma accumulator fragments: a warpgroup's 64 target rows x 128 source
// points, each thread's rows g and g + 8 of its warp's 16 and columns
// 8j + 2t + e.  Shared by large_d.cuh (rows of any length, in chunks) and
// large_d_one_chunk.cu (rows of at most 32 words), which stage each tile's
// |y|^2 and signal in one buffer: kTile floats of |y|^2, then kTile
// records of NC signal values.
#pragma once

#include "common.cuh"

namespace kmb {
namespace {

template <int K, int NC, bool FLASH, bool DEN, bool RND>
struct TileEpilogue {
  using Map = KernelMap<K>;
  using State = RowState<NC, FLASH, DEN, RND>;
  static constexpr int kTile = 128;  // source points per tile (wgmma N)

  // The signed, scaled form from <x, y> and the norms; clamped where the
  // map takes only g >= 0.
  static __device__ __forceinline__ float form(float dot, float xq, float yq) {
    return expanded_form<Map>(dot, xq, yq);
  }

  // bf16 flash, first pass: each row's max over this tile's logits (from
  // the fragment and two quad shuffles) into the row state's m.
  template <bool MASKED>
  static __device__ __forceinline__ void row_max(float (&acc)[16][4], State (&st)[2],
                                                 const float (&xq)[2], const float* tile_buf,
                                                 int j0, int end, const int (&diag_col)[2], int t) {
    const float* ysq = tile_buf;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c0 = j * 8 + 2 * t;
        float yq[2] = {0.f, 0.f};
        if constexpr (!Map::kDot) load_vec<2>(ysq + c0, yq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j0 + c0 + e;
          const bool off = MASKED && (col >= end || col == diag_col[h]);
          if (!off) mx = fmaxf(mx, Map::logit(form(acc[j][2 * h + e], xq[h], yq[e])));
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
      st[h].m = fmaxf(st[h].m, mx);
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
    const float* bt = tile_buf + kTile;
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

}  // namespace
}  // namespace kmb
