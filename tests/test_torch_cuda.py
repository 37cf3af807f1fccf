"""Card-only tests of the CUDA kernels (marked `cuda`; skip without a card).

This file imports neither jax nor kmb_tpu, so it also runs on a machine
with the card and no JAX, without the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Each kernel is held against the plain PyTorch version on the same card and
inputs: 1e-4 of the largest output in the f32 tiers (different summation
orders; the large-D form is 3xTF32), 2e-2 in the bfloat16 tier (the kernel
rounds each flash weight against the running max, the plain version
against the final max), 1e-3 for logits above 100 (tests/test_ops.py:82).
"""

import numpy as np
import pytest
import torch

from kmb_tpu_torch.ops import _build
from kmb_tpu_torch.ops.product import kernel_matvec, kernel_matvec_torch

ALL_KERNELS = ["gaussian", "absolute-exponential", "inverse-distance",
               "exponential"]
TOL = {"float32": 1e-4, "float32x3": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda_points():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    def make(n, m, d, e, seed=0):
        rng = np.random.default_rng(seed)
        return tuple(
            torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in (rng.standard_normal((n, d)) / np.sqrt(d),
                      rng.standard_normal((m, d)) / np.sqrt(d),
                      rng.standard_normal((m, e))))

    return make


def _close(got, want, tol=1e-4):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("d", [3, 64, 784])
@pytest.mark.parametrize("normalize", [False, True])
def test_kernels_match_plain_version(kernel, d, normalize, cuda_points):
    # Ragged N and M; M above the split threshold, so partial states merge.
    x, y, b = cuda_points(517, 1203, d, 8)
    kw = dict(kernel_name=kernel, normalize_rows=normalize)
    _close(kernel_matvec(x, y, b, **kw), kernel_matvec_torch(x, y, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("d", [9, 37, 130])
@pytest.mark.parametrize("normalize", [False, True])
def test_tile_edges_match_plain_version(tier, kernel, d, normalize,
                                        cuda_points):
    # D not a multiple of 8 or 32; N and M not multiples of 16, 64 or 128.
    x, y, b = cuda_points(301, 1203, d, 5)
    kw = dict(kernel_name=kernel, normalize_rows=normalize, precision=tier)
    _close(kernel_matvec(x, y, b, **kw), kernel_matvec_torch(x, y, b, **kw),
           TOL[tier])


@pytest.mark.cuda
@pytest.mark.parametrize("e", [1, 2, 4, 8, 13])
@pytest.mark.parametrize("d", [3, 64])
@pytest.mark.parametrize("normalize", [False, True])
def test_signal_widths_match_plain_version(e, d, normalize, cuda_points):
    x, y, b = cuda_points(211, 999, d, e)
    kw = dict(kernel_name="gaussian", normalize_rows=normalize)
    _close(kernel_matvec(x, y, b, **kw), kernel_matvec_torch(x, y, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 64, 130])
@pytest.mark.parametrize("normalize", [False, True])
def test_limits_ending_inside_a_tile(d, normalize, cuda_points):
    # Row and column limits that end inside a 128-wide tile, the diagonal
    # crossing both tile kinds.
    x, y, b = cuda_points(517, 1203, d, 3)
    kw = dict(kernel_name="gaussian", normalize_rows=normalize, deferred=True,
              row_offset=40, col_offset=3, row_limit=40 + 200,
              col_limit=3 + 700, mask_diagonal=True)
    got = kernel_matvec(x, y, b, **kw)
    want = kernel_matvec_torch(x, y, b, **kw)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        masked = w.abs() >= 1e29
        assert torch.equal(g.abs() >= 1e29, masked)
        _close(g[~masked], w[~masked])


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["float32", "bfloat16"])
def test_large_logits_on_the_tensor_cores(tier, cuda_points):
    rng = np.random.default_rng(3)
    x, y, b = (torch.tensor(a, dtype=torch.float32, device="cuda")
               for a in (3.0 * rng.standard_normal((161, 64)),
                         3.0 * rng.standard_normal((243, 64)),
                         rng.standard_normal((243, 1))))
    assert float((x @ y.T).max()) > 100.0
    kw = dict(kernel_name="exponential", normalize_rows=True, precision=tier)
    _close(kernel_matvec(x, y, b, **kw), kernel_matvec_torch(x, y, b, **kw),
           max(1e-3, TOL[tier]))


@pytest.mark.cuda
@pytest.mark.parametrize("normalize,which", [(False, "DIRECT"),
                                             (True, "FLASH")])
def test_each_launch_is_counted(normalize, which, cuda_points):
    x, y, b = cuda_points(300, 700, 3, 11)  # 11 columns: two launches
    kernel = getattr(_build, which)
    before = kernel.launches
    kernel_matvec(x, y, b, kernel_name="gaussian", normalize_rows=normalize)
    assert kernel.launches == before + 2


@pytest.mark.cuda
def test_deferred_flash_state_with_limits(cuda_points):
    x, y, b = cuda_points(517, 1203, 64, 1)
    kw = dict(kernel_name="gaussian", normalize_rows=True, deferred=True,
              row_offset=7, col_offset=2, row_limit=7 + 500,
              col_limit=2 + 1100, mask_diagonal=True)
    got = kernel_matvec(x, y, b, **kw)
    want = kernel_matvec_torch(x, y, b, **kw)
    for g, w in zip(got, want):
        masked = w.abs() >= 1e29   # rows past row_limit keep m = -1e30
        assert torch.equal(g.abs() >= 1e29, masked)
        _close(g[~masked], w[~masked])


@pytest.mark.cuda
def test_float64_on_the_card_raises(cuda_points):
    x, y, b = (t.double() for t in cuda_points(8, 9, 3, 1))
    with pytest.raises(TypeError, match="float32"):
        kernel_matvec(x, y, b, kernel_name="gaussian")
