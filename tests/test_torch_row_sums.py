"""The bfloat16 tier's row sums: the port keeps f32 sums of unrounded
kernel values, on the CPU.

`kernel_matvec_torch` (and the CUDA kernels held against it) sum the
unrounded kernel values into the row sums `den`, as kmb_tpu's
`kernel_matvec_xla` does.  The Pallas kernel it replaces puts a ones
column into the bf16 signal (kmb_tpu/ops/product.py:576), so its row sums
are sums of bf16-rounded values on the matrix unit.  This is a deliberate
departure: the port's `den` is held here to float64 at f32 accuracy, and
its distance to `kernel_matvec_pallas(interpret=True)` is stated and held
within the bfloat16 tier's tolerance (1e-2 of the largest value,
tests/test_torch_wide_signal.py).

Input: 1024 points on the unit sphere, x = y, the diagonal masked,
deferred states, in two cases: inverse-distance with normalize_rows at
D = 3 and D = 8, and Gaussian density estimation with a signal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmb_tpu.ops.product import kernel_matvec_pallas
from kmb_tpu_torch.ops.product import kernel_matvec_torch

N = 1024
BF16_TOL = 1e-2   # the bfloat16 tier against the JAX package
F32_TOL = 1e-6    # f32 sums of 1023 terms against float64


def _sphere(d, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((N, d))
    return (p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32)


CASES = {
    "inverse-distance normalised D3": (3, "inverse-distance",
                                       dict(normalize_rows=True)),
    "inverse-distance normalised D8": (8, "inverse-distance",
                                       dict(normalize_rows=True)),
    "gaussian density with a signal D3": (3, "gaussian",
                                          dict(density_estimation=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_den_is_the_f32_sum_of_unrounded_values(case):
    d, kernel, options = CASES[case]
    y = _sphere(d, seed=d)
    b = np.random.default_rng(7).standard_normal((N, 4)).astype(np.float32)
    kw = dict(kernel_name=kernel, mask_diagonal=True, deferred=True,
              **options)
    t = torch.from_numpy
    _, den = kernel_matvec_torch(t(y), t(y), t(b), precision="bfloat16",
                                 **kw)
    _, den64 = kernel_matvec_torch(t(y).double(), t(y).double(),
                                   t(b).double(), **kw)
    _, den_pallas = kernel_matvec_pallas(
        jnp.asarray(y), jnp.asarray(y), jnp.asarray(b),
        precision="bfloat16", interpret=True, **kw)
    den, den64 = den.double().numpy(), den64.numpy()
    den_pallas = np.asarray(den_pallas, np.float64)
    scale = np.abs(den64).max()
    port = np.abs(den - den64).max() / scale
    pallas = np.abs(den_pallas - den64).max() / scale
    between = np.abs(den - den_pallas).max() / scale
    # The port's den: f32-accurate.  Pallas's: sums of bf16 values, about
    # 2^-9 relative each, as far from float64 as from the port.
    assert port <= F32_TOL, (port, pallas)
    assert pallas > 10 * port, (port, pallas)
    assert between <= BF16_TOL, between
