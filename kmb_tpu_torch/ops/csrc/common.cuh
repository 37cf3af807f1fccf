// Shared pieces of the streaming kernel-matrix product kernels (sm_90a):
// the kernel maps, the argument block, the column split, the per-row
// accumulation state and the compile-time dispatch helpers.  See product.cu
// for what the kernels replace and how they are reached.
#pragma once

#include <cuda_runtime.h>


namespace kmb {

constexpr float kNegInf = -1e30f;  // masked logit, as FLASH_NEG_INF upstream
constexpr unsigned kFullMask = 0xffffffffu;

enum KernelId { kGaussian = 0, kAbsExp = 1, kInverseDistance = 2, kExponential = 3 };

// The special-function unit's approximations, flushing subnormals: one MUFU
// instruction each (the library exp2f / rsqrtf add range handling around it).
// ex2.approx: relative error below 2^-22; rsqrt.approx and sqrt.approx:
// below 2^-22.9.
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float rsqrt_approx(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float sqrt_approx(float v) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// v rounded to bf16 (nearest, ties to even), as an f32 value, in integer
// ops: the conversion instruction would share the special-function units'
// 16 per clock per SM with the pair's exp2.  (A NaN may come back as inf;
// the kernels round only kernel values and exp2 weights.)
__device__ __forceinline__ float round_bf16(float v) {
  const unsigned u = __float_as_uint(v);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// Maps from the signed, scaled form g (KernelSpec.scaled_fn / scaled_log2_fn).
// kNegate is KernelSpec.form_sign == -1.  value() and logit() take g >= 0 for
// the sqdist maps that need it (kClamp): the difference form is a sum of
// squares, and the expanded form clamps first.
template <int K> struct KernelMap;
template <> struct KernelMap<kGaussian> {
  static constexpr bool kDot = false, kNegate = true, kClamp = false;
  __device__ static float value(float g) { return ex2(g); }
  __device__ static float logit(float g) { return g; }
};
template <> struct KernelMap<kAbsExp> {
  static constexpr bool kDot = false, kNegate = false, kClamp = true;
  __device__ static float value(float g) { return ex2(-sqrt_approx(g)); }
  __device__ static float logit(float g) { return -sqrt_approx(g); }
};
template <> struct KernelMap<kInverseDistance> {
  static constexpr bool kDot = false, kNegate = false, kClamp = true;
  __device__ static float value(float g) { return rsqrt_approx(g); }
  __device__ static float logit(float g) { return g; }  // no log form: never flash
};
template <> struct KernelMap<kExponential> {
  static constexpr bool kDot = true, kNegate = false, kClamp = false;
  __device__ static float value(float g) { return ex2(g); }
  __device__ static float logit(float g) { return g; }
};

// The large-D form from <x, y> and the norms |x|^2, |y|^2 the wrapper
// computed: the signed, scaled squared distance 2<x, y> - |x|^2 - |y|^2 (or
// its negation, clamped at 0 where the map takes only g >= 0), or the dot
// product itself.
template <class Map>
__device__ __forceinline__ float expanded_form(float dot, float xq, float yq) {
  if constexpr (Map::kDot) {
    return dot;
  } else if constexpr (Map::kNegate) {
    return fmaf(2.f, dot, -(xq + yq));
  } else {
    const float g = fmaf(-2.f, dot, xq + yq);
    return Map::kClamp ? fmaxf(g, 0.f) : g;
  }
}

struct Args {
  const void* x;     // (n, d) target points: f32, or bf16 in the large-D bf16 form
  const void* y;     // (m, d) source points, as x
  const float* b;    // (m, nc) signal (narrow mode, nc <= 8)
  const void* bt;    // wide mode: (E blocks x nc, ldb) transposed signal, f32 TF32 hi
                     // parts or bf16 values (see wide.cuh); at small D in whole
                     // tiles, each contiguous (small_d_wide.cuh)
  const void* bt_lo; // wide mode, f32 tiers: the TF32 lo parts
  const float* xsq;  // (n,) |x|^2, large-D squared-distance kernels only
  const float* ysq;  // (m,) |y|^2
  float* out;        // (splits, n, nc) num, or acc for the flash kernel
  float* aux0;       // (splits, n) den (null when unread), or the flash max m
  float* aux1;       // (splits, n) the flash normaliser l
  int n, n_ok, m_eff;
  int words;         // 32-bit words per point row (padded coordinates)
  int diag, shift;
  int ldb;           // wide mode: source columns per row of bt (m padded to 8; at
                     // small D to whole tiles of 32)
};

// The source columns [begin, end) of split blockIdx.x: equal shares rounded
// up to whole tiles of TILE columns; split s writes its partial state at
// out + s * n * NC and aux + s * n.  Row blocks run along blockIdx.y.
template <int TILE>
struct Split {
  int begin, end;
  // Split s of `splits` over m_eff columns (also the host's view, for counts).
  __host__ __device__ Split(int m_eff, unsigned splits, unsigned s) {
    long long per = (m_eff + splits - 1) / splits;
    per = (per + TILE - 1) / TILE * TILE;
    const long long b0 = s * per;
    begin = (int)(b0 < m_eff ? b0 : m_eff);
    end = (int)(b0 + per < m_eff ? b0 + per : m_eff);
  }
  __device__ explicit Split(const Args& a) : Split(a.m_eff, gridDim.x, blockIdx.x) {}
};

// Per-row accumulation state, in registers.  DEN: accumulate the row sum of
// kernel values (only when something reads it).  RND: round each kernel
// value (flash: each exp2 weight) to bf16 before its product with the
// signal; row sums and the flash normaliser keep the f32 values, as
// kmb_tpu's kernel_matvec_xla does.
//
// The direct scheme sums in two levels: the pairs of one tile into a
// partial that starts at zero, and each tile's partial into the running
// sum (end_tile).  One float32 chain over a split's 10^5 columns loses
// about 45x more than the kernel values' own rounding (1.6e-6 against
// 3.5e-8 relative at M = 131072, solver_accuracy.py), enough to stall a
// Krylov solve; two levels of at most a few hundred terms each cost one
// add per tile and row.
template <int NC, bool FLASH, bool DEN, bool RND>
struct RowState {
  float acc[NC];
  float den = 0.f;    // direct: row sum of kernel values
  float m = kNegInf;  // flash: running base-2 max
  float l = 0.f;      // flash: normaliser
  float tile_acc[NC];     // direct: this tile's partial sums
  float tile_den = 0.f;

  __device__ RowState() {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = tile_acc[c] = 0.f;
  }

  // Direct scheme: add the kernel value w of one valid pair.
  __device__ __forceinline__ void add_value(float w, const float* bj) {
    if constexpr (DEN) tile_den += w;
    if constexpr (RND) w = round_bf16(w);
#pragma unroll
    for (int c = 0; c < NC; ++c) tile_acc[c] = fmaf(w, bj[c], tile_acc[c]);
  }

  // Direct scheme: fold this tile's partial sums into the running sums.
  // Called after every tile that add_value touched.
  __device__ __forceinline__ void end_tile() {
    if constexpr (!FLASH) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[c] += tile_acc[c];
        tile_acc[c] = 0.f;
      }
      if constexpr (DEN) {
        den += tile_den;
        tile_den = 0.f;
      }
    }
  }

  // Flash scheme: move the running max to m_new >= m (one rescale).
  __device__ __forceinline__ void rescale(float m_new) {
    const float alpha = ex2(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= alpha;
    m = m_new;
  }

  // Flash scheme, one pair at a time: rescale only when the max moves.
  __device__ __forceinline__ void add_logit(float s, const float* bj) {
    if (s > m) rescale(s);
    add_weight(ex2(s - m), bj);
  }

  // Flash scheme: add the weight p = exp2(s - m) of one valid pair.
  __device__ __forceinline__ void add_weight(float p, const float* bj) {
    l += p;
    if constexpr (RND) p = round_bf16(p);
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = fmaf(p, bj[c], acc[c]);
  }

  // Sum the partial states of `lanes` neighbouring lanes of one row (a
  // power of 2); in the flash scheme they already share the running max.
  __device__ __forceinline__ void sum_lanes(int lanes) {
    for (int off = 1; off < lanes; off <<= 1) {
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] += __shfl_xor_sync(kFullMask, acc[c], off);
      if constexpr (DEN) den += __shfl_xor_sync(kFullMask, den, off);
      if constexpr (FLASH) l += __shfl_xor_sync(kFullMask, l, off);
    }
  }

  // Write row i of this split; rows past n_ok (ok false) are masked whole
  // and get the empty state.
  __device__ __forceinline__ void store(const Args& a, int i, bool ok) const {
    const size_t row = (size_t)blockIdx.x * a.n + i;
#pragma unroll
    for (int c = 0; c < NC; ++c) a.out[row * NC + c] = ok ? acc[c] : 0.f;
    if constexpr (FLASH) {
      a.aux0[row] = ok ? m : kNegInf;
      a.aux1[row] = ok ? l : 0.f;
    } else if constexpr (DEN) {
      a.aux0[row] = ok ? den : 0.f;
    }
  }
};

// Reads N consecutive floats (N = 1, 2 or a multiple of 4) with the widest
// aligned loads.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N == 1) {
    v[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
    }
  }
}

// ---- host side -------------------------------------------------------------


// What selects an instantiation.
struct Shape {
  int d;       // small D: padded coordinates (3 or 8); large D: words per row
  int nc;      // signal columns: 1, 2, 4 or 8; above 8 the wide mode's
               // columns per block of the grid's z dimension (16, 64 or 256
               // at small D; 16, 32, and in bf16 64, at large D)
  int kernel;  // KernelId
  bool flash, den, bf16;
  bool large;  // D > 8: the tensor-core form
};

// One kernel instantiation, chosen at run time: the kernel function, its
// block, dynamic shared memory and target rows per block, and for kernels
// that take more than the Args (the large-D wide kernel's tensor maps) the
// function that prepares them and launches.
struct Launch {
  const void* fn = nullptr;
  int threads = 0;
  int smem = 0;
  int rows = 0;
  cudaError_t (*run)(const Shape&, const Launch&, const Args&, dim3, cudaStream_t) = nullptr;
};

// Launch a kernel (product.cu).  While the launch timer is on
// (kmb_timer_begin / kmb_timer_end), CUDA events are recorded on the stream
// just before and just after cudaLaunchKernel, so nothing the host does
// before a launch (the large-D wide kernel's tensor maps) is timed.
cudaError_t launch_kernel(const void* fn, dim3 grid, dim3 block, void** params, size_t smem,
                          cudaStream_t stream);

// What the last launch staged through TMA (the large-D wide and one-chunk
// kernels set it, the others leave it zero): its ring's stages, whether x stayed resident,
// and the bytes all its blocks' loads moved, as their boxes count them.
struct Staging {
  int stages, resident;
  long long bytes;
};
extern Staging last_staging;

// Defined in small_d_{3,8}_{direct,flash}.cu, large_d_{tf32,bf16}.cu and
// large_d_one_chunk.cu (signals of 1, 2, 4 or 8 columns; the last with a
// `run`), small_d_wide_{3,8}_{tf32,bf16}.cu and
// large_d_wide_{tf32,bf16}.cu (the wide mode, nc > 8; the latter with a
// `run`); each returns false for a shape it has no instantiation of.
bool small_d_3_direct_launch(const Shape& s, Launch* out);
bool small_d_3_flash_launch(const Shape& s, Launch* out);
bool small_d_8_direct_launch(const Shape& s, Launch* out);
bool small_d_8_flash_launch(const Shape& s, Launch* out);
bool large_d_tf32_launch(const Shape& s, Launch* out);
bool large_d_bf16_launch(const Shape& s, Launch* out);
bool large_d_one_chunk_launch(const Shape& s, Launch* out);
bool small_d_wide_3_tf32_launch(const Shape& s, Launch* out);
bool small_d_wide_3_bf16_launch(const Shape& s, Launch* out);
bool small_d_wide_8_tf32_launch(const Shape& s, Launch* out);
bool small_d_wide_8_bf16_launch(const Shape& s, Launch* out);
bool large_d_wide_tf32_launch(const Shape& s, Launch* out);
bool large_d_wide_bf16_launch(const Shape& s, Launch* out);

}  // namespace kmb
