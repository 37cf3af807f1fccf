"""The tensor-core staging of the large-D kernel, on the CPU.

The large-D CUDA kernel forms <x, y> on the tensor cores: in the float32
tiers as 3xTF32 from TF32 parts that the wrapper splits once per call
(`tf32_split`), in the bfloat16 tier from bf16 points, both with f32
accumulation.  The card is not needed to check that arithmetic: every
product of two TF32 (or bf16) values is exact in f32, so f32 matmuls of
the parts on the CPU reproduce it up to the order of the sums.  The
emulation below follows the kernel's epilogue (the norms, the clamp, the
map, the bf16 rounding of each weight) and is held against kmb_tpu's
`kernel_matvec_xla` and the float64 oracle, with the tolerances of
tests/test_ops.py:41,65 (products, normalised) and the bf16 tier's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmb_tpu.algorithms.bruteforce_numpy import kernel_matrix
from kmb_tpu.ops.product import kernel_matvec_xla
from kmb_tpu_torch.ops.kernels import get_kernel
from kmb_tpu_torch.ops.product import kernel_matvec_torch, tf32_split

ALL_KERNELS = ["gaussian", "absolute-exponential", "inverse-distance",
               "exponential"]
LOW_BITS = 0x1FFF  # the 13 mantissa bits TF32 drops
TINY = np.float32(np.finfo(np.float32).tiny)
TF32_MAX = (2 - 2.0 ** -10) * 2.0 ** 127


def _bits(t):
    return t.view(torch.int32)


# -- tf32_split -----------------------------------------------------------------

SPLIT_CASES = {
    "normal": lambda rng: rng.standard_normal(4096),
    "wide range": lambda rng: rng.standard_normal(4096)
    * 10.0 ** rng.uniform(-30, 30, 4096),
    "negatives": lambda rng: -np.abs(rng.standard_normal(4096)),
    "zeros": lambda rng: np.array([0.0, -0.0, 0.0]),
    "ties": lambda rng: np.array([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11,
                                  -(1 + 2.0 ** -11)]),
    "near TF32's largest": lambda rng: np.array([TF32_MAX, -TF32_MAX,
                                                  0.999 * TF32_MAX]),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_tf32_split_parts(case):
    t = torch.tensor(SPLIT_CASES[case](np.random.default_rng(0)),
                     dtype=torch.float32)
    hi, lo = tf32_split(t)
    assert hi.dtype == lo.dtype == torch.float32
    # Both parts are TF32 values: their low 13 mantissa bits are zero.
    assert torch.all(_bits(hi) & LOW_BITS == 0)
    assert torch.all(_bits(lo) & LOW_BITS == 0)
    # hi is t rounded to nearest, within half a TF32 step (2^-11 relative).
    assert torch.all(torch.isfinite(hi))
    assert torch.all((hi.double() - t.double()).abs()
                     <= 2.0 ** -11 * t.double().abs())
    # hi + lo is t to within 2^-22 relative.
    err = (hi.double() + lo.double() - t.double()).abs()
    assert torch.all(err <= 2.0 ** -22 * t.double().abs())
    # Signs and zeros carry over.
    assert torch.equal(torch.signbit(hi), torch.signbit(t))
    assert torch.all(lo[t == 0] == 0)


def test_tf32_split_ties_round_away_from_zero():
    # As the kernel rounds (an add and a mask on the bits): half-way values
    # go to the larger magnitude.
    t = torch.tensor([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -(1 + 2.0 ** -11)],
                     dtype=torch.float32)
    hi, lo = tf32_split(t)
    assert hi.tolist() == [1 + 2.0 ** -10, 1 + 2.0 ** -9, -(1 + 2.0 ** -10)]
    assert lo.tolist() == [-(2.0 ** -11), -(2.0 ** -11), 2.0 ** -11]


def test_tf32_split_past_the_largest_tf32_value():
    # Finite f32 values above TF32's largest finite value round to inf, as
    # the kernel's split does (no point the wrapper stages comes near).
    big = np.finfo(np.float32).max
    hi, lo = tf32_split(torch.tensor([big, -big], dtype=torch.float32))
    assert hi.tolist() == [np.inf, -np.inf]
    assert lo.tolist() == [0.0, 0.0]


def test_tf32_split_subnormals_keep_what_tf32_holds():
    # TF32 keeps the float32 exponent range, so subnormals split too; below
    # 2^-126 the parts keep 10 bits at a fixed step of 2^-136, and hi + lo
    # lands within half of that step.
    t = torch.tensor(np.float32(TINY) * np.array(
        [0.5, 0.75, 1e-3, -0.3, 0.999], dtype=np.float32), dtype=torch.float32)
    assert torch.all(t.abs() < TINY)
    hi, lo = tf32_split(t)
    assert torch.all(_bits(hi) & LOW_BITS == 0)
    assert torch.all(_bits(lo) & LOW_BITS == 0)
    err = (hi.double() + lo.double() - t.double()).abs()
    assert torch.all(err <= 2.0 ** -137)


@pytest.mark.parametrize("value", [np.inf, -np.inf, np.nan])
def test_tf32_split_non_finite(value):
    t = torch.tensor([value, 1.5], dtype=torch.float32)
    hi, lo = tf32_split(t)
    if np.isnan(value):
        assert torch.isnan(hi[0])
    else:
        assert hi[0].item() == value
    assert lo[0].item() == 0.0
    assert hi[1].item() == 1.5 and lo[1].item() == 0.0


# -- the kernel's arithmetic, emulated --------------------------------------------

def _emulate(x, y, b, kernel, normalize, tier):
    """The large-D kernel's arithmetic, in f32 on the CPU."""
    spec = get_kernel(kernel)
    bf16 = tier == "bfloat16"

    def staged(a):
        t = torch.from_numpy(a).float() * spec.point_scale
        return t.to(torch.bfloat16).float() if bf16 else t

    xs, ys = staged(x), staged(y)
    bs = torch.from_numpy(b).float()
    if bf16:
        bs = bs.to(torch.bfloat16).float()
        dots = xs @ ys.T   # bf16 products are exact in f32
    else:
        (xh, xl), (yh, yl) = tf32_split(xs), tf32_split(ys)
        dots = xl @ yh.T + xh @ yl.T + xh @ yh.T
    if spec.on == "dot":
        g = spec.form_sign * dots
    else:
        xq = torch.sum(xs * xs, dim=1, keepdim=True)
        yq = torch.sum(ys * ys, dim=1, keepdim=True).T
        if spec.form_sign < 0:
            g = 2.0 * dots - xq - yq
        else:
            g = torch.clamp_min(xq + yq - 2.0 * dots, 0.0)
    n, m = g.shape
    mask = torch.zeros((n, m), dtype=torch.bool)
    if spec.zero_diagonal:
        mask = torch.eye(n, m, dtype=torch.bool)

    def rounded(w):
        return w.to(torch.bfloat16).float() if bf16 else w

    if normalize and spec.scaled_log2_fn is not None:
        s = spec.scaled_log2_fn(g).masked_fill(mask, -1e30)
        p = torch.exp2(s - s.amax(dim=1, keepdim=True)).masked_fill(mask, 0)
        return ((rounded(p) @ bs) / p.sum(dim=1, keepdim=True)).numpy()
    k = spec.scaled_fn(g).masked_fill(mask, 0.0)
    out = rounded(k) @ bs
    if normalize:
        out = out / k.sum(dim=1, keepdim=True)
    return out.numpy()


def _points(d, seed):
    # N = M = 300, scaled by 1/sqrt(D) as the normal-cloud datasets are.
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((300, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.standard_normal((300, d)) / np.sqrt(d)).astype(np.float32)
    b = rng.standard_normal((300, 2)).astype(np.float32)
    return x, y, b


def _truth(kernel, x, y, b, normalize):
    k = kernel_matrix(kernel=kernel, source_points=y.astype(np.float64),
                      target_points=x.astype(np.float64))
    out = k @ b.astype(np.float64)
    if normalize:
        out = out / k.sum(axis=1, keepdims=True)
    return out


def _rms(got, want):
    return np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))


@pytest.mark.parametrize("tier", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("d", [9, 64, 784])
@pytest.mark.parametrize("normalize", [False, True])
def test_emulated_kernel_arithmetic(tier, kernel, d, normalize):
    x, y, b = _points(d, seed=d)
    got = _emulate(x, y, b, kernel, normalize, tier)
    xla = np.asarray(kernel_matvec_xla(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(b), kernel_name=kernel,
        normalize_rows=normalize, precision=tier, block_n=64))
    truth = _truth(kernel, x, y, b, normalize)
    assert np.all(np.isfinite(got))
    if tier == "float32":
        tol = dict(rtol=1e-4, atol=1e-5) if normalize else dict(
            rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got, xla, **tol)
        np.testing.assert_allclose(got, truth, **tol)
        # 3xTF32 is f32-accurate: within 10x of the plain f32 product's
        # error (one TF32 pass is 30 to 400 times worse on these inputs).
        plain = kernel_matvec_torch(
            torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(b),
            kernel_name=kernel, normalize_rows=normalize).numpy()
        assert _rms(got, truth) <= 10 * _rms(plain, truth)
    else:
        # The frameworks round bf16 at different places (XLA's bf16 matmul
        # also rounds its output): 1e-2 of the largest output; and the
        # bf16 tier's 5e-2 against the truth (tests/test_ops.py).
        scale = np.abs(xla).max()
        np.testing.assert_allclose(got, xla, rtol=0, atol=1e-2 * scale)
        assert np.abs(got - truth).max() / np.abs(truth).max() < 0.05
