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
// transcendental and E multiply-adds; the bytes moved are only
// (N + M) * D + M * E + N * E values, so both kernels are bound by
// operations.  Each comes in two forms, chosen by D:
//
//   small D (D <= 8, padded to 3 or 8 with zero coordinates by the wrapper):
//     small_d.cuh, the difference form on the FP32 units, four target rows
//     per thread; bound by the special-function units when it issues about
//     7 other instructions per pair.
//   large D (D > 8, padded to whole 64-byte chunks): large_d.cuh, the form
//     product on the tensor cores (3xTF32 in the float32 tiers, bf16 in the
//     bfloat16 tier) with the map, masks and signal product applied to the
//     accumulator fragments in registers.
//
// Both: when the row blocks alone would leave SMs idle (N = 10^4 gives 79
// blocks of 128 rows for 132 SMs), the wrapper splits the source range over
// the grid's x dimension; each split writes its own partial state and the
// wrapper merges them (a sum, or the flash merge).
//
// Precision tiers: "float32" and "float32x3" run f32 arithmetic, with the
// large-D form product in 3xTF32 (f32-accurate; the kernel splits each
// staged f32 value into TF32 parts in registers).  "bfloat16": the wrapper
// rounds the signal to bf16, and the points only at D > 8 (the small-D loop
// takes f32 points, as the Pallas kernel's VPU form does); the kernel rounds
// each kernel value (the flash kernel: each exp2 weight) to bf16 before its
// product with the signal, and accumulates in f32.  Row sums and the flash normaliser use
// the unrounded f32 values, as kmb_tpu's kernel_matvec_xla does.

#include "common.cuh"

namespace kmb {
namespace {

// The instantiation for a shape, its shared memory raised above the 48 KB
// default where it needs more.
cudaError_t select(const Shape& s, Launch* l) {
  const bool found =
      s.large ? (s.bf16 ? large_d_bf16_launch(s, l) : large_d_tf32_launch(s, l))
              : (small_d_3_direct_launch(s, l) || small_d_3_flash_launch(s, l) ||
                 small_d_8_direct_launch(s, l) || small_d_8_flash_launch(s, l));
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

int launch(const Shape& s, const Args& a, int splits, cudaStream_t stream) {
  if (a.n <= 0) return cudaSuccess;
  Launch l;
  cudaError_t err = select(s, &l);
  if (err != cudaSuccess) return err;
  const long long row_blocks = (a.n + l.rows - 1) / l.rows;
  if (splits < 1 || row_blocks > 65535) return cudaErrorInvalidValue;
  Args args = a;
  args.words = s.d;
  void* params[] = {&args};
  err = cudaLaunchKernel(l.fn, dim3(splits, (unsigned)row_blocks), dim3(l.threads), params,
                         l.smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

Args make_args(const void* x, const void* y, const float* b, const float* xsq,
               const float* ysq, float* out, float* aux0, float* aux1, int n, int n_ok,
               int m_eff, int diag, int shift) {
  Args a;
  a.x = x; a.y = y; a.b = b; a.xsq = xsq; a.ysq = ysq;
  a.out = out; a.aux0 = aux0; a.aux1 = aux1;
  a.n = n; a.n_ok = n_ok; a.m_eff = m_eff; a.words = 0; a.diag = diag; a.shift = shift;
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
// their padded width.  out / acc is (splits, n, nc); den (may be null), mx and l
// are (splits, n).
int kmb_direct_matvec(const void* x, const void* y, const float* b, const float* xsq,
                      const float* ysq, float* out, float* den, int n, int n_ok, int m_eff,
                      int d, int nc, int kernel, int diag, int shift, int splits, int bf16,
                      void* stream) {
  const kmb::Args a =
      kmb::make_args(x, y, b, xsq, ysq, out, den, nullptr, n, n_ok, m_eff, diag, shift);
  return kmb::launch(kmb::make_shape(d, nc, kernel, false, den != nullptr, bf16), a, splits,
                     static_cast<cudaStream_t>(stream));
}

int kmb_flash_matvec(const void* x, const void* y, const float* b, const float* xsq,
                     const float* ysq, float* acc, float* mx, float* l, int n, int n_ok,
                     int m_eff, int d, int nc, int kernel, int diag, int shift, int splits,
                     int bf16, void* stream) {
  const kmb::Args a =
      kmb::make_args(x, y, b, xsq, ysq, acc, mx, l, n, n_ok, m_eff, diag, shift);
  return kmb::launch(kmb::make_shape(d, nc, kernel, true, false, bf16), a, splits,
                     static_cast<cudaStream_t>(stream));
}

const char* kmb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
