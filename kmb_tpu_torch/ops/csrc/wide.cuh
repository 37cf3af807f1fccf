// The wide-signal mode of both kernels (E > 8 columns): the port of the
// Pallas kernels' MXU accumulation mode (kmb_tpu/ops/product.py,
// `_accumulate` with acc_mode="mxu", chosen at :560), where a tile of
// kernel values times the signal tile is one matrix-unit product for any E.
// Shared by the large-D wide kernel (large_d_wide.cuh: WideSignal's product
// on a TMA-staged, 128-byte-swizzled signal tile, WideRows) and the small-D
// kernel (small_d_wide.cuh: WideSignal's shared layout, kGroupColumns).
//
// In the large-D tile each warpgroup holds its 64 target rows' kernel
// values of a tile of T source columns in registers, in the layout of an
// f32 wgmma accumulator (thread (g, t) of warp w: rows 16w + g and
// 16w + g + 8, columns 8j + 2t and 8j + 2t + 1 of block j), and multiplies
// them by the staged signal tile (T source columns x EB signal columns, in
// shared memory) with wgmma, A from registers:
//   float32 / float32x3 tiers: 3xTF32.  Each weight and each signal value
//     is split into TF32 parts, v = hi + lo, and wgmma m64nEBk8.tf32 sums
//     lo.hi + hi.lo + hi.hi in f32; the products of TF32 parts are exact,
//     so no weight is rounded below f32 accuracy.  The A fragment of a k8
//     step holds columns k = t and t + 4; the accumulator layout gives a
//     thread columns 2t and 2t + 1 of a block, so logical k = t carries
//     column 2t and k = t + 4 column 2t + 1, and the wrapper stages the
//     signal's source columns in that order within each group of 8
//     (kmb_tpu_torch/ops/product.py, WIDE_TF32_ORDER).  The sum over k does
//     not depend on its order.
//   bfloat16 tier: each weight rounded to bf16 (as the narrow mode and
//     Pallas's DEFAULT pass do), one wgmma m64nEBk16.bf16 pass with f32
//     accumulation; the accumulator layout of blocks 2s and 2s + 1 is the
//     A layout of k16 step s, so no order changes.
// The signal product is summed in three levels (WideRows): each k step's
// product (3xTF32: its hi.hi part; the small terms per tile) into groups
// of 2048 source columns, groups into the running sums, as
// RowState::end_tile sums the narrow mode in two (one f32 chain over a
// split's 10^5 columns stalls a Krylov solve).  Row sums
// and the flash normaliser stay f32 sums of the unrounded weights on the
// FP32 units.  A block of the grid's z dimension takes EB of the signal's
// columns; the wrapper pads E to whole blocks.
#pragma once

#include "mma.cuh"

namespace kmb {

// Two bf16 values (exact bf16 already, as f32) in one register, lo in the
// low half: the k order of a bf16 A fragment's register.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The signal tile of the wide mode and its product with a tile of kernel
// values.  T source columns (the product's K) by EB signal columns (its
// N), staged from the wrapper's transposed signal (a.bt, and a.bt_lo for
// the TF32 lo parts: EB rows of this block's E block, a.ldb source columns
// each) in wgmma's no-swizzle K-major layout: 8-row x 16-byte core
// matrices, side by side along K (128 bytes apart, the descriptor's
// leading byte offset), row groups 8 x the row's bytes apart (its stride
// byte offset).  SW128: staged instead by TMA as the large-D wide kernel
// does (large_d_wide.cuh), in boxes of EB signal columns x 128 bytes of
// source columns with the 128-byte swizzle, the boxes side by side along
// the source columns (sw128_desc).
template <int T, int EB, bool BF16, bool SW128 = false>
struct WideSignal {
  static_assert(T % 16 == 0 && EB % 8 == 0, "whole k steps and n blocks");
  static constexpr int kRowWords = BF16 ? T / 2 : T;  // 32-bit words per signal column
  static constexpr int kPartWords = EB * kRowWords;   // one part (hi, or TF32 lo)
  static constexpr int kWords = (BF16 ? 1 : 2) * kPartWords;
  static constexpr int kSteps = BF16 ? T / 16 : T / 8;  // k steps per tile
  static constexpr int kBlocks = EB / 8;               // accumulator blocks

  // Word of signal column n and 32-bit word k of the tile's source columns
  // in the no-swizzle layout (the small-D kernel's tiles,
  // product.py's tile_wide_signal).
  static __device__ __forceinline__ int word(int n, int k) {
    return (n / 8) * (8 * kRowWords) + (k / 4) * 32 + (n % 8) * 4 + k % 4;
  }

  // Descriptor of k step s of a staged part: two core matrices along K.
  static __device__ __forceinline__ unsigned long long desc(const unsigned* part, int s) {
    if constexpr (SW128) return sw128_desc(part, EB, s);
    const unsigned addr = smem_addr(part + s * 64);
    return (unsigned long long)((addr & 0x3FFFF) >> 4) | (8ull << 16) |
           ((unsigned long long)(2 * kRowWords) << 32);
  }

  // dst += this tile's kernel values times the staged signal tile.
  // weights(j, w) gives block j's four values w[2h + e] (row g + 8h,
  // column 8j + 2t + e), rounded to bf16 in the bf16 tier.  Each k step's
  // A fragment is built while the previous step's wgmma group runs (two
  // register sets).  3xTF32: the tensor cores add into their f32
  // accumulator with truncation, so each step's hi.hi product starts from
  // zero (`big`) and is added into dst on the FP32 units (round to
  // nearest) once its group is done, while the small terms lo.hi + hi.lo,
  // about 2^-11 of it, chain over the tile in an accumulator of their own
  // (`small`).  bf16: the tile's product in one accumulator (the bf16
  // weights' rounding dominates).  The last group is waited for before
  // returning.
  template <class Weights>
  static __device__ __forceinline__ void contract(float (&dst)[kBlocks][4], const unsigned* tile,
                                                  Weights& weights) {
    unsigned ah[2][4], al[2][4];
    float big[kBlocks][4], small[BF16 ? 1 : kBlocks][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      unsigned(&h)[4] = ah[s % 2];
      unsigned(&l)[4] = al[s % 2];
      if constexpr (BF16) {
        float w0[4], w1[4];
        weights(2 * s, w0);
        weights(2 * s + 1, w1);
        h[0] = pack_bf16(w0[0], w0[1]);
        h[1] = pack_bf16(w0[2], w0[3]);
        h[2] = pack_bf16(w1[0], w1[1]);
        h[3] = pack_bf16(w1[2], w1[3]);
        fence_acc(big);
        wgmma_fence();
        wgmma_rs<EB, true>(big, h, desc(tile, s), s > 0);
        wgmma_commit();
        if (s > 0) {  // step s - 1 is done: its A registers are free
          wgmma_wait<1>();
          fence_regs(ah[(s + 1) % 2]);
        }
      } else {
        float w[4];
        weights(s, w);
        // (g, k = t), (g + 8, t), (g, t + 4), (g + 8, t + 4) <- columns
        // 2t, 2t, 2t + 1, 2t + 1 of the block.
        const float v[4] = {w[0], w[2], w[1], w[3]};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          h[k] = tf32_hi(__float_as_uint(v[k]));
          l[k] = tf32_lo(__float_as_uint(v[k]), h[k]);
        }
        if (s > 0) {  // step s - 1 is done: add its hi.hi product
          wgmma_wait<0>();
          fence_regs(ah[(s + 1) % 2]);
          fence_regs(al[(s + 1) % 2]);
          add_to(dst, big);
        }
        fence_acc(big);
        fence_acc(small);
        wgmma_fence();
        wgmma_rs<EB, false>(big, h, desc(tile, s), 0);
        wgmma_rs<EB, false>(small, l, desc(tile, s), s > 0);
        wgmma_rs<EB, false>(small, h, desc(tile + kPartWords, s), 1);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_regs(ah);
    add_to(dst, big);
    if constexpr (!BF16) {
      fence_regs(al);
      add_to(dst, small);
    }
  }

  // dst += p, a finished accumulator.
  static __device__ __forceinline__ void add_to(float (&dst)[kBlocks][4], float (&p)[kBlocks][4]) {
    fence_acc(p);
#pragma unroll
    for (int n = 0; n < kBlocks; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[n][k] += p[n][k];
  }
};

// The running state of a thread's two rows (g and g + 8 of its warp) in
// the wide mode: the signal sums `acc` (accumulator layout) and the row
// sums (direct) or the flash state (m, and the normaliser in `sum`).
// Sums in three levels: each k step's product (3xTF32: its hi.hi part;
// WideSignal::contract), added into a group of kGroupColumns source
// columns, groups into the running sums.  The narrow mode's column splits
// keep its second level near 200 tile partials at 131072 columns; the
// wide grid has few splits, and one chain of 2048 tile partials there had
// 1.7x the narrow mode's error against float64.
constexpr int kGroupColumns = 2048;

template <int NB, bool FLASH>
struct WideRows {
  float acc[NB][4], grp[NB][4];
  float m[2] = {kNegInf, kNegInf};
  float sum[2] = {0.f, 0.f}, gsum[2] = {0.f, 0.f};
  int in_group = 0;

  __device__ WideRows() {
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[n][k] = grp[n][k] = 0.f;
  }

  // Flash scheme: the tile's row max from the logits f (accumulator
  // layout) over the quad (the four lanes of a row), then one rescale of
  // each row's state per tile, the FlashAttention-2 order.
  template <int NT>
  __device__ __forceinline__ void rescale(const float (&f)[NT][4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(f[j][2 * h], f[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
      if (mx > m[h]) {
        const float alpha = ex2(m[h] - mx);
        sum[h] *= alpha;
        gsum[h] *= alpha;
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            acc[n][2 * h + e] *= alpha;
            grp[n][2 * h + e] *= alpha;
          }
        m[h] = mx;
      }
    }
  }

  // After a tile of `cols` source columns, whose product went into grp:
  // add its row sums, and fold the group when it is whole.
  __device__ __forceinline__ void end_tile(const float (&tsum)[2], int cols) {
#pragma unroll
    for (int h = 0; h < 2; ++h) gsum[h] += tsum[h];
    if (++in_group == kGroupColumns / cols) fold();
  }

  __device__ __forceinline__ void fold() {
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[n][k] += grp[n][k];
        grp[n][k] = 0.f;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += gsum[h];
      gsum[h] = 0.f;
    }
    in_group = 0;
  }

  // Write rows rbase and rbase + 8 of this split and E block: the thread's
  // signal columns of each block, and (E block 0, lane t = 0) the row sums
  // or the flash state, merged over the quad.  Rows past n_ok get the
  // empty state.
  __device__ __forceinline__ void store(const Args& a, int rbase, int t) {
    fold();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(kFullMask, sum[h], 1);
      sum[h] += __shfl_xor_sync(kFullMask, sum[h], 2);
    }
    const int ep = gridDim.z * NB * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = rbase + 8 * h;
      if (i >= a.n) continue;
      const bool ok = i < a.n_ok;
      const size_t row = (size_t)blockIdx.x * a.n + i;
      float* out = a.out + row * ep + blockIdx.z * NB * 8 + 2 * t;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        *reinterpret_cast<float2*>(out + 8 * n) =
            ok ? make_float2(acc[n][2 * h], acc[n][2 * h + 1]) : make_float2(0.f, 0.f);
      }
      if (t == 0 && blockIdx.z == 0) {
        if constexpr (FLASH) {
          a.aux0[row] = ok ? m[h] : kNegInf;
          a.aux1[row] = ok ? sum[h] : 0.f;
        } else if (a.aux0 != nullptr) {
          a.aux0[row] = ok ? sum[h] : 0.f;
        }
      }
    }
  }
};

}  // namespace kmb
