// Streaming kernel-matrix product on Hopper (sm_90a): out = K(x, y) @ b
// without ever storing K.  Two kernels, each reached through a plain C
// entry point that kmb_tpu_torch/ops/_build.py loads with ctypes:
//
//   kmb_direct_matvec  replaces kmb_tpu/ops/product.py::_direct_kernel_body
//                      (launched by _kernel_matvec_pallas).  Accumulates
//                      out_i = sum_j k(x_i, y_j) b_j and, when asked, the
//                      row sums den_i = sum_j k(x_i, y_j).
//   kmb_flash_matvec   replaces kmb_tpu/ops/product.py::_flash_kernel_body.
//                      Base-2 online softmax: per row a running max m, a
//                      normaliser l and an exp2-rescaled accumulator acc;
//                      emits (acc, m, l), and acc / l is taken outside.
//
// Both share the form (signed, scaled squared distance or dot product, as
// KernelSpec.point_scale / form_sign define it upstream), the masks and the
// kernel maps of kmb_tpu_torch/ops/kernels.py:
//   - local columns j >= m_eff (ragged edge, and col_offset + j >= col_limit,
//     folded into m_eff by the wrapper) contribute nothing;
//   - rows i >= n_ok (row_offset + i >= row_limit) contribute nothing;
//   - with diag set, the global diagonal row_offset + i == col_offset + j,
//     i.e. j == i + shift, is skipped.
//
// The work is N*M pairs, each one form (D multiply-adds), one
// transcendental and E multiply-adds (on the FP32 units up to 8 columns, on
// the tensor cores above); the bytes moved are only
// (N + M) * D + M * E + N * E values, so both kernels are bound by
// operations.  Each comes in two forms, chosen by D:
//
//   small D (D <= 8, padded to 3 or 8 with zero coordinates by the wrapper):
//     small_d.cuh, the difference form on the FP32 units, four target rows
//     per thread; bound by the special-function units when it issues about
//     7 other instructions per pair.
//   large D (D > 8, padded to whole 16 bytes): the form product on the
//     tensor cores (3xTF32 in the float32 tiers, bf16 in the bfloat16 tier)
//     with the map, masks and signal product applied to the accumulator
//     fragments in registers.  Rows of at most 32 words in the float32 tiers
//     (D <= 32): large_d_one_chunk.cu, x resident, y's TF32 planes by TMA,
//     the next tile's product under the current tile's epilogue; longer rows
//     and the bfloat16 tier: large_d.cuh, in chunks of 32 words.
//
// and in two modes, chosen by E:
//
//   E <= 8 (padded to 1, 2, 4 or 8 columns): the E multiply-adds of a pair
//     run on the FP32 units, from a staged signal record per source column.
//   E > 8, the wide mode (wide.cuh; small_d_wide.cuh and large_d_wide.cuh):
//     the kernel values of a tile are the A operand of wgmma products with
//     a staged signal tile, on the tensor cores (3xTF32 in the float32
//     tiers, one bf16 pass in the bfloat16 tier), for blocks of signal
//     columns along the grid's z dimension: at small D of 16, 64 or 256,
//     the kernel values computed once per launch up to E = 256; at large D
//     of 16 or 32 (and 64 in bf16), a warp-specialised kernel fed by TMA,
//     the kernel values computed once per block.  The wrapper stages the
//     signal transposed, padded to whole blocks, TF32-split or rounded to
//     bf16 (at small D in whole tiles, each contiguous).

// Both: when the row blocks alone would leave SMs idle (N = 10^4 gives 79
// blocks of 128 rows for 132 SMs), the wrapper splits the source range over
// the grid's x dimension; each split writes its own partial state and the
// wrapper merges them (a sum, or the flash merge).
//
// Precision tiers: "float32" and "float32x3" run f32 arithmetic, with the
// large-D form product in 3xTF32 (f32-accurate; each f32 value split into
// TF32 parts, by the kernel or, for TMA-fed sources, once by the wrapper).  "bfloat16": the wrapper
// rounds the signal to bf16, and the points only at D > 8 (the small-D loop
// takes f32 points, as the Pallas kernel's VPU form does); the kernel rounds
// each kernel value (the flash kernel: each exp2 weight) to bf16 before its
// product with the signal, and accumulates in f32.  Row sums and the flash normaliser use
// the unrounded f32 values, as kmb_tpu's kernel_matvec_xla does.

#include <utility>
#include <vector>

#include "common.cuh"

namespace kmb {

Staging last_staging{0, 0, 0};

namespace {

// The launch timer: while `timing`, each launch's (start, stop) events.
bool timing = false;
std::vector<std::pair<cudaEvent_t, cudaEvent_t>> timed;

void release_timed() {
  for (auto& ev : timed) {
    cudaEventDestroy(ev.first);
    cudaEventDestroy(ev.second);
  }
  timed.clear();
}

}  // namespace

cudaError_t launch_kernel(const void* fn, dim3 grid, dim3 block, void** params, size_t smem,
                          cudaStream_t stream) {
  if (!timing) return cudaLaunchKernel(fn, grid, block, params, smem, stream);
  cudaEvent_t start, stop;
  cudaError_t err = cudaEventCreate(&start);
  if (err != cudaSuccess) return err;
  err = cudaEventCreate(&stop);
  if (err != cudaSuccess) {
    cudaEventDestroy(start);
    return err;
  }
  timed.emplace_back(start, stop);
  err = cudaEventRecord(start, stream);
  if (err == cudaSuccess) err = cudaLaunchKernel(fn, grid, block, params, smem, stream);
  if (err == cudaSuccess) err = cudaEventRecord(stop, stream);
  return err;
}

namespace {

// The instantiation for a shape, its shared memory raised above the 48 KB
// default where it needs more.
cudaError_t select(const Shape& s, Launch* l) {
  bool found;
  if (s.nc > 8) {
    found = s.large ? (s.bf16 ? large_d_wide_bf16_launch(s, l) : large_d_wide_tf32_launch(s, l))
                    : (small_d_wide_3_tf32_launch(s, l) || small_d_wide_3_bf16_launch(s, l) ||
                       small_d_wide_8_tf32_launch(s, l) || small_d_wide_8_bf16_launch(s, l));
  } else {
    // Large D in the float32 tiers: rows of one chunk (at most 32 words) take
    // the one-chunk kernel, longer rows large_d.cuh's.
    found = s.large ? (s.bf16 ? large_d_bf16_launch(s, l)
                              : (large_d_one_chunk_launch(s, l) || large_d_tf32_launch(s, l)))
                    : (small_d_3_direct_launch(s, l) || small_d_3_flash_launch(s, l) ||
                       small_d_8_direct_launch(s, l) || small_d_8_flash_launch(s, l));
  }
  if (!found) return cudaErrorInvalidValue;
  if (l->smem > 48 * 1024) {
    return cudaFuncSetAttribute(l->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, l->smem);
  }
  return cudaSuccess;
}

// d: padded coordinates per point; large D counts 32-bit words, so bf16
// points (two per word) need an even d.
Shape make_shape(int d, int nc, int kernel, bool flash, bool den, bool bf16) {
  Shape s{d, nc, kernel, flash, den, bf16, d > 8};
  if (s.large && bf16) s.d = d % 2 == 0 ? d / 2 : -1;
  return s;
}

// eblocks: blocks of s.nc signal columns along the grid's z dimension (the
// wide mode; 1 otherwise).
int launch(const Shape& s, const Args& a, int splits, int eblocks, cudaStream_t stream) {
  if (a.n <= 0) return cudaSuccess;
  Launch l;
  cudaError_t err = select(s, &l);
  if (err != cudaSuccess) return err;
  const long long row_blocks = (a.n + l.rows - 1) / l.rows;
  if (splits < 1 || row_blocks > 65535 || eblocks < 1 || eblocks > 65535 ||
      (s.nc <= 8 && eblocks != 1) || (s.nc > 8 && (a.ldb < a.m_eff || a.ldb % 8 != 0))) {
    return cudaErrorInvalidValue;
  }
  Args args = a;
  args.words = s.d;
  const dim3 grid(splits, (unsigned)row_blocks, eblocks);
  last_staging = Staging{0, 0, 0};
  if (l.run != nullptr) {
    err = l.run(s, l, args, grid, stream);
  } else {
    void* params[] = {&args};
    err = launch_kernel(l.fn, grid, dim3(l.threads), params, l.smem, stream);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

// b: the signal, (m, nc) f32 in the narrow mode; in the wide mode the
// transposed signal's hi parts (f32) or values (bf16), with b_lo its TF32
// lo parts (f32 tiers) and ldb its row length.
Args make_args(const void* x, const void* y, const void* b, const void* b_lo,
               const float* xsq, const float* ysq, float* out, float* aux0, float* aux1,
               int n, int n_ok, int m_eff, int diag, int shift, int ldb) {
  Args a;
  a.x = x; a.y = y; a.xsq = xsq; a.ysq = ysq;
  a.b = static_cast<const float*>(b); a.bt = b; a.bt_lo = b_lo;
  a.out = out; a.aux0 = aux0; a.aux1 = aux1;
  a.n = n; a.n_ok = n_ok; a.m_eff = m_eff; a.words = 0; a.diag = diag; a.shift = shift;
  a.ldb = ldb;
  return a;
}

}  // namespace
}  // namespace kmb

extern "C" {

// The launch plan for a shape: target rows per block, and how many blocks
// of it one SM holds at once, so the wrapper can choose the column splits.
// Returns a cudaError_t.
int kmb_plan(int d, int nc, int kernel, int flash, int den, int bf16, int* rows,
             int* blocks_per_sm) {
  kmb::Launch l;
  const kmb::Shape s = kmb::make_shape(d, nc, kernel, flash, den, bf16);
  cudaError_t err = kmb::select(s, &l);
  if (err != cudaSuccess) return err;
  *rows = l.rows;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, l.fn, l.threads, l.smem);
}

// Both return a cudaError_t: 0 when the launch was accepted (or n == 0).
// x, y: the staged points (f32; bf16 at large D in the bfloat16 tier); d is
// their padded width.  nc <= 8: b is the (m, nc) signal, b_lo null, ldb 0
// and eblocks 1.  nc > 8 (the wide mode): b and b_lo the transposed signal
// (eblocks * nc, ldb) as the wrapper stages it.  out / acc is
// (splits, n, eblocks * nc); den (may be null), mx and l are (splits, n).
int kmb_direct_matvec(const void* x, const void* y, const void* b, const void* b_lo,
                      const float* xsq, const float* ysq, float* out, float* den, int n,
                      int n_ok, int m_eff, int d, int nc, int kernel, int diag, int shift,
                      int splits, int bf16, int ldb, int eblocks, void* stream) {
  const kmb::Args a = kmb::make_args(x, y, b, b_lo, xsq, ysq, out, den, nullptr, n, n_ok,
                                     m_eff, diag, shift, ldb);
  return kmb::launch(kmb::make_shape(d, nc, kernel, false, den != nullptr, bf16), a, splits,
                     eblocks, static_cast<cudaStream_t>(stream));
}

int kmb_flash_matvec(const void* x, const void* y, const void* b, const void* b_lo,
                     const float* xsq, const float* ysq, float* acc, float* mx, float* l,
                     int n, int n_ok, int m_eff, int d, int nc, int kernel, int diag, int shift,
                     int splits, int bf16, int ldb, int eblocks, void* stream) {
  const kmb::Args a = kmb::make_args(x, y, b, b_lo, xsq, ysq, acc, mx, l, n, n_ok, m_eff,
                                     diag, shift, ldb);
  return kmb::launch(kmb::make_shape(d, nc, kernel, true, false, bf16), a, splits, eblocks,
                     static_cast<cudaStream_t>(stream));
}

// The launch timer.  kmb_timer_begin starts bracketing every launch with
// CUDA events; kmb_timer_end stops, waits for the timed launches, writes
// their number to `count` and the device time (ms) of the first `cap` to
// `ms`, and frees the events.  Both return a cudaError_t.
int kmb_timer_begin() {
  kmb::release_timed();
  kmb::timing = true;
  return cudaSuccess;
}

int kmb_timer_end(float* ms, int cap, int* count) {
  kmb::timing = false;
  cudaError_t err = cudaSuccess;
  *count = static_cast<int>(kmb::timed.size());
  for (int i = 0; i < *count; ++i) {
    float t = 0.f;
    if (err == cudaSuccess) err = cudaEventSynchronize(kmb::timed[i].second);
    if (err == cudaSuccess) err = cudaEventElapsedTime(&t, kmb::timed[i].first, kmb::timed[i].second);
    if (i < cap) ms[i] = t;
  }
  kmb::release_timed();
  return err;
}

// What the last launch staged (kmb::Staging; zeros but for the large-D
// wide and one-chunk kernels).
void kmb_last_staging(int* stages, int* resident, long long* bytes) {
  *stages = kmb::last_staging.stages;
  *resident = kmb::last_staging.resident;
  *bytes = kmb::last_staging.bytes;
}

const char* kmb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
