"""The wide-signal mode of the CUDA kernels (E > 8 columns), on the CPU.

Above 8 signal columns both kernels multiply each tile of kernel values by
a staged signal tile on the tensor cores (csrc/wide.cuh), the port of the
Pallas kernels' MXU accumulation mode (`acc_mode="mxu"`,
kmb_tpu/ops/product.py:560).  The card is not needed to check that
arithmetic: every product of two TF32 (or bf16) values is exact in f32, so
f32 matmuls of the parts on the CPU reproduce it up to the order of the
sums.  `emulate` follows the wrapper (`signal_plan`, `stage_wide_signal`,
the split merge) and the kernels (tiles of 32 source columns at D <= 8 and
128 above, the A fragment's column order, the TF32 or bf16 parts of weight
and signal, each k step's hi.hi product added apart from the small terms
into groups of 2048 columns; in bf16 at D <= 8 each k step's product
chained in the group's sums, at D > 8 each tile's; the flash rescale once
per tile), and
is held against kmb_tpu's `kernel_matvec_pallas(..., interpret=True)`
(which takes `acc_mode="mxu"` at these widths), `kernel_matvec_xla` and the
float64 oracle.

Tolerances, per tier: float32, those of tests/test_ops.py:41 (products,
rtol 2e-4, atol 2e-5) and :65 (normalised, rtol 1e-4, atol 1e-5), the
atol times the largest output where that exceeds 1 (test_ops.py's outputs
are of order 1; a few hundred f32 terms of size 40 leave 4e-5 near zero in
any summation order);
float32x3, whose Pallas reference is the bf16x3 pass (about 2^-16),
test_ops.py's 3e-4 of the largest output; bfloat16, 1e-2 of the largest
output against the JAX bf16 tier (the frameworks round bf16 at different
places: Pallas rounds each flash weight against the running max of its
own tiles) and test_ops.py's 5e-2 against float64.  The bfloat16 tier
keeps f32 points at D <= 8, as the Pallas kernel's VPU form does, where
`kernel_matvec_xla` rounds them: there only Pallas is its reference (as in
tests/test_torch_product.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmb_tpu.algorithms.bruteforce_numpy import kernel_matrix
from kmb_tpu.ops.product import kernel_matvec_pallas, kernel_matvec_xla
from kmb_tpu_torch.ops.kernels import get_kernel
from kmb_tpu_torch.ops import product
from kmb_tpu_torch.ops.product import (
    FLASH_NEG_INF, INT32_MAX, WIDE_TF32_ORDER, WIDE_TILE, _finalize_direct,
    _needs_den, kernel_matvec_torch, merge_direct_states,
    TMA_SIGNAL_ALIGN, merge_flash_states, signal_plan, stage_wide_signal,
    tf32_planes, tf32_split, tile_wide_signal, tma_signal)

ALL_KERNELS = ["gaussian", "absolute-exponential", "inverse-distance",
               "exponential"]
TIERS = ["float32", "float32x3", "bfloat16"]
WIDTHS = [9, 16, 64, 256]

# Source columns per tile of the two forms (csrc/small_d_wide.cuh kTile,
# csrc/large_d_wide.cuh kCols), and per group of tiles (csrc/wide.cuh
# kGroupColumns).
TILE = {False: 32, True: 128}
GROUP_COLUMNS = 2048
# The kernel's A fragment of a TF32 k8 step: logical k = t holds the
# kernel value of the step's column 2t and k = t + 4 that of column
# 2t + 1 (the accumulator layout a thread computes, csrc/wide.cuh).
A_COLUMNS = [2 * t for t in range(4)] + [2 * t + 1 for t in range(4)]


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _forms(x, y, spec, bf16):
    """The signed, scaled form of every pair in the kernels' arithmetic."""
    d = x.shape[1]
    xs, ys = x.float() * spec.point_scale, y.float() * spec.point_scale
    if d <= 8:   # the difference form on the FP32 units, f32 points
        if spec.on == "dot":
            return xs @ ys.T
        return spec.form_sign * ((xs[:, None, :] - ys[None]) ** 2).sum(-1)
    if bf16:     # bf16 points, products exact in f32
        xs, ys = _bf16(xs), _bf16(ys)
        dots = xs @ ys.T
    else:        # 3xTF32
        (xh, xl), (yh, yl) = tf32_split(xs), tf32_split(ys)
        dots = xl @ yh.T + xh @ yl.T + xh @ yh.T
    if spec.on == "dot":
        return spec.form_sign * dots
    xq = torch.sum(xs * xs, dim=1, keepdim=True)
    yq = torch.sum(ys * ys, dim=1, keepdim=True).T
    if spec.form_sign < 0:
        return 2.0 * dots - xq - yq
    return torch.clamp_min(xq + yq - 2.0 * dots, 0.0)


def _add_tile_product(grp, w, sig, lo, bf16, large):
    """grp plus w (n, T) kernel values times the staged signal tile (T,
    width): one bf16 pass (at D <= 8 each k step of 16 columns chained in
    grp, at D > 8 the tile's product added), or 3xTF32 in the kernel's A
    column order, each k step's hi.hi product added on its own and the
    small terms of the tile beside them."""
    if bf16:
        if large:
            return grp + _bf16(w) @ sig
        for k in range(0, w.shape[1], 16):
            grp = grp + _bf16(w[:, k:k + 16]) @ sig[k:k + 16]
        return grp
    order = torch.tensor([8 * q + k for q in range(w.shape[1] // 8)
                          for k in A_COLUMNS])
    a_hi, a_lo = tf32_split(w[:, order].contiguous())
    for k in range(0, w.shape[1], 8):
        grp = grp + a_hi[:, k:k + 8] @ sig[k:k + 8]
    return grp + (a_lo @ sig + a_hi @ lo)


def emulate(x, y, b, kernel_name, *, normalize_rows=False,
            mask_diagonal=None, density_estimation=False, deferred=False,
            precision="float32", row_offset=0, col_offset=0,
            col_limit=INT32_MAX, row_limit=INT32_MAX, splits=1):
    """The wide mode of kernel_matvec_cuda, in f32 on the CPU (numpy in,
    the wrapper's contract out)."""
    spec = get_kernel(kernel_name)
    md = spec.zero_diagonal if mask_diagonal is None else mask_diagonal
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    n, d = x.shape
    m = y.shape[0]
    if density_estimation and normalize_rows and not deferred:
        return torch.ones((n, 1))
    b_was_none = b is None
    b = torch.ones((m, 1)) if b_was_none else torch.from_numpy(b)
    e = b.shape[1]
    use_flash = normalize_rows and spec.scaled_log2_fn is not None
    needs_den = _needs_den(spec, normalize_rows, density_estimation,
                           b_was_none)
    bf16 = precision == "bfloat16"
    large = d > 8
    nc, eblocks = signal_plan(e, large, bf16)
    assert nc > 8, "a narrow signal"
    bs = _bf16(b.float()) if bf16 else b.float()
    hi, lo, ldb = stage_wide_signal(bs, nc * eblocks, bf16)
    sig = hi.float().T                      # (ldb, width), staged order
    sig_lo = None if lo is None else lo.T

    g = _forms(x, y, spec, bf16)
    n_ok = max(0, min(n, row_limit - row_offset))
    m_eff = max(0, min(m, col_limit - col_offset))
    rows = torch.arange(n)[:, None]
    # Column splits of whole tiles, as csrc/common.cuh's Split.
    tile = TILE[large]
    per = -(-m_eff // splits)
    per = -(-per // tile) * tile
    outs, dens, ms, ls = [], [], [], []
    for s in range(splits):
        begin, end = min(s * per, m_eff), min((s + 1) * per, m_eff)
        # Three levels: each tile from zero, tiles into a group of
        # GROUP_COLUMNS source columns, groups into the running sums.
        sacc = torch.zeros((n, nc * eblocks))
        grp = torch.zeros_like(sacc)
        run_m = torch.full((n, 1), FLASH_NEG_INF)
        run_sum = torch.zeros((n, 1))
        grp_sum = torch.zeros_like(run_sum)
        for q, j0 in enumerate(range(begin, end, tile)):
            cols = torch.arange(j0, j0 + tile)
            gt = torch.zeros((n, tile))
            inside = cols < m
            gt[:, inside] = g[:, j0:min(j0 + tile, m)]
            masked = (cols >= end)[None, :] | (rows >= n_ok)
            if md:
                masked = masked | (cols[None, :] == rows + row_offset
                                   - col_offset)
            st = sig[j0:j0 + tile]
            st_lo = None if sig_lo is None else sig_lo[j0:j0 + tile]
            if st.shape[0] < tile:   # zero-filled past ldb
                pad = (0, 0, 0, tile - st.shape[0])
                st = torch.nn.functional.pad(st, pad)
                st_lo = None if st_lo is None else torch.nn.functional.pad(
                    st_lo, pad)
            if use_flash:
                logits = spec.scaled_log2_fn(gt).masked_fill(
                    masked, FLASH_NEG_INF)
                m_new = torch.maximum(run_m, logits.amax(1, keepdim=True))
                alpha = torch.exp2(run_m - m_new)
                sacc, grp = sacc * alpha, grp * alpha
                run_sum, grp_sum = run_sum * alpha, grp_sum * alpha
                w = torch.exp2(logits - m_new).masked_fill(masked, 0.0)
                run_m = m_new
            else:
                w = spec.scaled_fn(gt).masked_fill(masked, 0.0)
            grp = _add_tile_product(grp, w, st, st_lo, bf16, large)
            grp_sum = grp_sum + w.sum(1, keepdim=True)
            if (q + 1) % (GROUP_COLUMNS // tile) == 0:
                sacc, grp = sacc + grp, torch.zeros_like(grp)
                run_sum, grp_sum = run_sum + grp_sum, torch.zeros_like(
                    grp_sum)
        sacc, run_sum = sacc + grp, run_sum + grp_sum
        empty = rows >= n_ok
        outs.append(sacc.masked_fill(empty, 0.0))
        dens.append(run_sum.masked_fill(empty, 0.0))
        ms.append(run_m.masked_fill(empty, FLASH_NEG_INF))
        ls.append(run_sum.masked_fill(empty, 0.0))
    if use_flash:
        acc, mx, l = merge_flash_states(torch.stack(outs), torch.stack(ms),
                                        torch.stack(ls))
        acc = acc[:, :e]
        return (acc, mx, l) if deferred else acc / l
    num, den = merge_direct_states(
        torch.stack(outs), torch.stack(dens) if needs_den else None)
    return _finalize_direct(num[:, :e], den, needs_den=needs_den,
                            normalize_rows=normalize_rows,
                            density_estimation=density_estimation,
                            deferred=deferred)


def _points(n, m, d, e, seed):
    # Scaled by 1/sqrt(D), as the normal-cloud datasets are.
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32),
            (rng.standard_normal((m, d)) / np.sqrt(d)).astype(np.float32),
            rng.standard_normal((m, e)).astype(np.float32))


def _truth(kernel, x, y, b, normalize):
    k = kernel_matrix(kernel=kernel, source_points=y.astype(np.float64),
                      target_points=x.astype(np.float64))
    out = k @ b.astype(np.float64)
    if normalize:
        out = out / k.sum(axis=1, keepdims=True)
    return out


def _jax(fn, x, y, b, **kw):
    out = fn(jnp.asarray(x), jnp.asarray(y),
             None if b is None else jnp.asarray(b), **kw)
    if isinstance(out, tuple):
        return tuple(None if o is None else np.asarray(o) for o in out)
    return np.asarray(out)


def _references(x, y, b, **kw):
    """The JAX package's answers on the same inputs: Pallas in interpret
    mode, and XLA where its tier rounds alike (not bf16 at D <= 8)."""
    refs = [_jax(kernel_matvec_pallas, x, y, b, interpret=True, **kw)]
    if kw.get("precision") != "bfloat16" or x.shape[1] > 8:
        refs.append(_jax(kernel_matvec_xla, x, y, b, block_n=64, **kw))
    return refs


def _hold(got, want, tier, normalize):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    scale = np.abs(want).max()
    if tier == "float32":
        rtol, atol = (1e-4, 1e-5) if normalize else (2e-4, 2e-5)
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=atol * max(1.0, scale))
    elif tier == "float32x3":
        assert np.abs(got - want).max() <= 3e-4 * scale
    else:
        assert np.abs(got - want).max() <= 1e-2 * scale


# -- the plan and the staged signal -----------------------------------------------

@pytest.mark.parametrize("e, large, want", [
    (1, False, (1, 1)), (3, False, (4, 1)), (8, True, (8, 1)),
    (9, False, (16, 1)), (16, False, (16, 1)), (17, False, (64, 1)),
    (33, False, (64, 1)), (64, False, (64, 1)), (100, False, (256, 1)),
    (256, False, (256, 1)), (512, False, (256, 2)), (9, True, (16, 1)),
    (16, True, (16, 1)), (100, True, (32, 4)), (512, True, (32, 16))])
def test_signal_plan(e, large, want):
    # One launch at any width: E blocks along the grid, never more
    # columns than the blocks hold, and less than one block of padding;
    # at D <= 8 one block up to E = 256, so each kernel value is computed
    # once per launch; at D > 8 (float32 tiers) blocks of 16 or 32.
    nc, blocks = signal_plan(e, large)
    assert (nc, blocks) == want
    assert nc * blocks >= e > nc * (blocks - 1)


@pytest.mark.parametrize("e, bf16, want", [
    (9, False, (16, 1)), (17, False, (32, 1)), (32, False, (32, 1)),
    (33, False, (32, 2)), (64, False, (32, 2)), (9, True, (16, 1)),
    (17, True, (32, 1)), (33, True, (64, 1)), (64, True, (64, 1)),
    (100, True, (64, 2)), (512, True, (64, 8))])
def test_signal_plan_at_large_d_by_tier(e, bf16, want):
    # At D > 8 the narrowest block of the tier that holds E, else its
    # widest: 16 or 32 columns in the float32 tiers, 16, 32 or 64 in
    # bfloat16 (csrc/large_d_wide.cuh, supported_eb); one E block up to
    # E = 32 (float32) or 64 (bfloat16).
    assert signal_plan(e, True, bf16) == want


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("m, e, width", [(300, 9, 16), (301, 100, 128),
                                         (8, 16, 16)])
def test_stage_wide_signal(tier, m, e, width):
    bf16 = tier == "bfloat16"
    b = torch.from_numpy(_points(1, m, 1, e, seed=m)[2])
    if bf16:
        b = _bf16(b)
    hi, lo, ldb = stage_wide_signal(b, width, bf16)
    assert ldb == -(-m // 8) * 8 and ldb % 8 == 0
    assert hi.shape == (width, ldb) and hi.is_contiguous()
    if bf16:
        assert lo is None and hi.dtype == torch.bfloat16
        assert torch.equal(hi.float()[:e, :m], b.T)
        staged = hi.float()
    else:
        assert hi.dtype == lo.dtype == torch.float32 and lo.is_contiguous()
        # Within each group of 8 source columns, staged position k holds
        # column WIDE_TF32_ORDER[k]: the A fragment's order, A_COLUMNS.
        assert list(WIDE_TF32_ORDER) == A_COLUMNS
        inverse = torch.argsort(torch.tensor(WIDE_TF32_ORDER))
        idx = (torch.arange(0, ldb, 8)[:, None] + inverse).reshape(-1)
        staged = (hi.double() + lo.double())[:, idx]
        assert torch.all((staged[:e, :m] - b.T.double()).abs()
                         <= 2.0 ** -22 * b.T.double().abs())
    # Zero past the signal's columns and rows: no padded column adds.
    assert torch.all(staged[e:] == 0) and torch.all(staged[:, m:] == 0)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("eb, blocks", [(16, 1), (256, 1), (256, 2)])
def test_tiled_signal_is_the_shared_layout(bf16, eb, blocks):
    # Each tile of each E block contiguous, in the order of
    # csrc/wide.cuh's WideSignal::word: word (n // 8) * 8 * row_words +
    # (k // 4) * 32 + (n % 8) * 4 + k % 4 for signal column n and 32-bit
    # word k of the tile's source columns (a bf16 word holds two, the lower
    # column in its low half).
    b = torch.from_numpy(_points(1, 70, 1, eb * blocks - 3, seed=eb)[2])
    if bf16:
        b = _bf16(b)
    hi, lo, ldb = stage_wide_signal(b, eb * blocks, bf16, align=WIDE_TILE)
    assert ldb == 96
    for part in (hi,) if bf16 else (hi, lo):
        tiled = tile_wide_signal(part, eb)
        row_words = WIDE_TILE // 2 if bf16 else WIDE_TILE
        assert tiled.shape == (blocks, ldb // WIDE_TILE, eb * WIDE_TILE)
        assert tiled.is_contiguous() and tiled.dtype == part.dtype
        words = tiled.view(blocks, ldb // WIDE_TILE, -1)
        for z, t, n, col in ((0, 0, 0, 0), (blocks - 1, 2, eb - 1, 31),
                             (0, 1, 9, 13), (blocks - 1, 0, 3, 6)):
            k = col // 2 if bf16 else col
            w = (n // 8) * 8 * row_words + (k // 4) * 32 + (n % 8) * 4 + k % 4
            at = 2 * w + col % 2 if bf16 else w
            assert words[z, t, at] == part[z * eb + n, t * WIDE_TILE + col]
        # Every value lands once.
        assert torch.equal(tiled.flatten().sort().values,
                           part.flatten().sort().values)


@pytest.mark.parametrize("m, d, rows", [(300, 37, 300), (300, 256, 297),
                                        (131, 9, 0)])
def test_tf32_planes_of_the_source_points(m, d, rows):
    # The large-D wide kernel's float32-tier points: the first `rows`
    # staged rows (rows of whole 16 bytes, for the tensor maps) as two
    # contiguous planes, hi then lo, which are tf32_split's parts exactly
    # and add up to the f32 values within 2^-22.
    _, pts, _ = _points(1, m, d, 1, seed=d)
    staged, norms = product._stage_points(torch.from_numpy(pts), 1.7,
                                          large=True, bf16=False)
    assert staged.shape[1] % 4 == 0 and staged.shape[1] >= d
    planes = tf32_planes(staged, rows)
    assert planes.shape == (2, rows, staged.shape[1])
    assert planes.is_contiguous() and planes.dtype == torch.float32
    assert planes.stride(1) * planes.element_size() % 16 == 0
    hi, lo = tf32_split(staged[:rows])
    assert torch.equal(planes[0], hi) and torch.equal(planes[1], lo)
    ref = staged[:rows].double()
    assert torch.all((planes[0].double() + planes[1].double() - ref).abs()
                     <= 2.0 ** -22 * ref.abs())


def test_staged_source_is_reused_until_the_points_change():
    # The wrapper stages an engine's fixed source points once: the same
    # tensor at the same version and key gets the same staged operands;
    # an in-place change, another key or another tensor is staged anew;
    # the entry goes with its tensor; inference tensors (no version
    # counter) are staged every call.
    import gc

    staged = []

    def stage(t):
        def run():
            staged.append(t.shape)
            return product._stage_points(t, 1.0, large=True, bf16=False)
        return run

    _, pts, _ = _points(1, 40, 12, 1, seed=3)
    y = torch.from_numpy(pts)
    first = product._staged_source(y, "key", stage(y))
    assert product._staged_source(y, "key", stage(y)) is first
    assert len(staged) == 1
    product._staged_source(y, "other key", stage(y))
    assert len(staged) == 2
    y.mul_(2.0)
    doubled = product._staged_source(y, "other key", stage(y))
    assert len(staged) == 3
    assert torch.equal(doubled[0][:, :12], y.float())
    z = y.clone()
    product._staged_source(z, "other key", stage(z))
    assert len(staged) == 4
    del z
    gc.collect()
    assert product._source_cache[0] is None
    with torch.inference_mode():
        w = torch.ones((8, 12))
    product._staged_source(w, "key", stage(w))
    product._staged_source(w, "key", stage(w))
    assert len(staged) == 6


def test_fixed_source_changes_nothing_on_the_cpu():
    # `fixed_source` only keeps the kernels' staging of y; the plain
    # version takes and ignores it.
    x, y, b = (torch.from_numpy(a) for a in _points(30, 40, 12, 20, seed=4))
    kw = dict(kernel_name="gaussian", precision="float32")
    assert torch.equal(product.kernel_matvec(x, y, b, fixed_source=True, **kw),
                       product.kernel_matvec(x, y, b, **kw))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m, e, width", [(300, 17, 32), (64, 64, 64),
                                         (129, 100, 128)])
def test_tma_signal_groups(bf16, m, e, width):
    # The large-D wide kernel's signal: padded to whole groups of 128 bytes
    # of source columns (64 in both tiers), each group of every signal
    # column contiguous, the TF32 lo part after the hi part; every staged
    # value lands once, where the kernel's TMA box reads it.
    b = torch.from_numpy(_points(1, m, 1, e, seed=e)[2])
    if bf16:
        b = _bf16(b)
    hi, lo, ldb = stage_wide_signal(b, width, bf16, align=TMA_SIGNAL_ALIGN)
    assert ldb % 64 == 0 and ldb >= m
    grouped = tma_signal(hi, lo)
    assert grouped.is_contiguous()
    if bf16:
        assert grouped.shape == (ldb // 64, width, 64)
        assert grouped.dtype == torch.bfloat16
        for g, n, c in ((0, 0, 0), (ldb // 64 - 1, width - 1, 63), (0, 5, 17)):
            assert grouped[g, n, c] == hi[n, 64 * g + c]
    else:
        assert grouped.shape == (2, ldb // 32, width, 32)
        for p, part in enumerate((hi, lo)):
            for g, n, c in ((0, 0, 0), (ldb // 32 - 1, width - 1, 31),
                            (1, 3, 9)):
                assert grouped[p, g, n, c] == part[n, 32 * g + c]
    flat = grouped.float().flatten().sort().values
    parts = hi if lo is None else torch.stack((hi, lo))
    assert torch.equal(flat, parts.float().flatten().sort().values)


def test_order_index_is_built_once_per_device():
    # The float32 tiers' gather index (WIDE_TF32_ORDER) is built on the
    # signal's device once per power-of-two length and reused, not copied
    # from the host per call.
    product._order_index_of.cache_clear()
    b = torch.from_numpy(_points(1, 300, 1, 16, seed=3)[2])
    first = stage_wide_signal(b, 16, False)
    stage_wide_signal(b[:260], 16, False)    # ldb 304 and 264: one index
    info = product._order_index_of.cache_info()
    assert (info.misses, info.hits, info.currsize) == (1, 1, 1)
    assert product._order_index(304, b.device).data_ptr() == (
        product._order_index(264, b.device).data_ptr())
    again = stage_wide_signal(b, 16, False)
    assert all(torch.equal(u, v) for u, v in zip(first[:2], again[:2]))
    assert product._order_index_of.cache_info().misses == 1


# -- the arithmetic against the JAX package -----------------------------------------

@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("e", WIDTHS)
@pytest.mark.parametrize("normalize", [False, True])
def test_wide_arithmetic_matches_jax(tier, kernel, e, normalize):
    x, y, b = _points(200, 300, 3, e, seed=e)
    kw = dict(kernel_name=kernel, normalize_rows=normalize, precision=tier)
    got = emulate(x, y, b, **kw).numpy()
    for ref in _references(x, y, b, **kw):
        _hold(got, ref, tier, normalize)
    truth = _truth(kernel, x, y, b, normalize)
    if tier == "bfloat16":
        assert np.abs(got - truth).max() <= 5e-2 * np.abs(truth).max()
    else:
        _hold(got, truth, "float32", normalize)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("d, e", [(5, 40), (37, 16), (130, 100), (64, 64),
                                  (256, 33)])
def test_wide_arithmetic_at_other_widths(tier, kernel, d, e):
    # D = 5 pads to 8 coordinates; D > 8 forms on the tensor cores (tiles
    # of 128 columns, E blocks of 16 or 32, and 64 in bfloat16: E = 64 is
    # one block there, two in the float32 tiers; E = 33 a ragged block).
    x, y, b = _points(160, 333, d, e, seed=d)
    for normalize in (False, True):
        kw = dict(kernel_name=kernel, normalize_rows=normalize,
                  precision=tier)
        got = emulate(x, y, b, **kw).numpy()
        for ref in _references(x, y, b, **kw):
            _hold(got, ref, tier, normalize)
        truth = _truth(kernel, x, y, b, normalize)
        if tier == "bfloat16":
            assert np.abs(got - truth).max() <= 5e-2 * np.abs(truth).max()
        else:
            _hold(got, truth, "float32", normalize)


OPTIONS = {
    "diagonal": dict(mask_diagonal=True),
    "density": dict(density_estimation=True),
    "deferred, offsets and limits": dict(
        deferred=True, row_offset=40, col_offset=3, row_limit=40 + 150,
        col_limit=3 + 230, mask_diagonal=True),
    "deferred normalised": dict(deferred=True, normalize_rows=True,
                                row_offset=7, col_offset=2,
                                col_limit=2 + 280, mask_diagonal=True),
}


@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("e", [16, 256])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_wide_masks_and_states_match_jax(kernel, e, option):
    x, y, b = _points(200, 300, 3, e, seed=7)
    if option == "diagonal":
        x = y[:200]
    kw = dict(kernel_name=kernel, **OPTIONS[option])
    got = emulate(x, y, b, **kw)
    normalize = kw.get("normalize_rows", False)
    for ref in _references(x, y, b, **kw):
        got_t = got if isinstance(got, tuple) else (got,)
        ref_t = ref if isinstance(ref, tuple) else (ref,)
        assert len(got_t) == len(ref_t)
        for g, r in zip(got_t, ref_t):
            if r is None:
                assert g is None
                continue
            g = g.numpy()
            sentinel = np.abs(r) >= 1e29   # rows past row_limit: m = -1e30
            assert np.array_equal(np.abs(g) >= 1e29, sentinel)
            _hold(g[~sentinel], r[~sentinel], "float32", normalize)


@pytest.mark.parametrize("kernel", ["gaussian", "inverse-distance"])
@pytest.mark.parametrize("normalize", [False, True])
def test_column_splits_merge_to_one_split(kernel, normalize):
    # Partial states of column splits (direct sums, flash states), merged
    # by the wrapper's merges, give the one-split answer.
    x, y, b = _points(150, 500, 3, 64, seed=11)
    kw = dict(kernel_name=kernel, normalize_rows=normalize, deferred=True)
    one = emulate(x, y, b, **kw)
    for splits in (2, 3):
        many = emulate(x, y, b, splits=splits, **kw)
        for a, c in zip(one, many):
            if a is None:
                assert c is None
            else:   # another order of the f32 sums
                assert float((c - a).abs().max()) <= 1e-5 * float(
                    a.abs().max())


@pytest.mark.parametrize("e", [32, 256])
def test_wide_arithmetic_as_accurate_as_the_plain_version(e):
    # 3xTF32 keeps f32 accuracy: against float64, within 2x of the plain
    # f32 product's error over 8192 columns (a fresh partial per tile, four
    # groups of tiles); E = 256 in one block of the grid.
    x, y, b = _points(64, 8192, 3, e, seed=5)
    truth = _truth("gaussian", x, y, b, False)
    got = emulate(x, y, b, "gaussian").numpy()
    plain = kernel_matvec_torch(torch.from_numpy(x), torch.from_numpy(y),
                                torch.from_numpy(b),
                                kernel_name="gaussian").numpy()

    def rel(v):
        return np.linalg.norm(v - truth) / np.linalg.norm(truth)

    assert rel(got) <= 2.0 * rel(plain), (rel(got), rel(plain))


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("normalize", [False, True])
def test_e256_is_one_block_that_matches_four_of_64(tier, normalize):
    # The Nystrom sketch's width in one E block: the kernel values of each
    # pair formed once, multiplied by all 256 signal columns; the same
    # numbers as four blocks of 64 (each its own kernel values) up to the
    # order of f32 sums, and the JAX package's answer.
    assert signal_plan(256, False) == (256, 1)
    x, y, b = _points(96, 700, 3, 256, seed=17)
    kw = dict(kernel_name="gaussian", normalize_rows=normalize,
              precision=tier)
    one = emulate(x, y, b, **kw).numpy()
    four = np.concatenate([
        emulate(x, y, np.ascontiguousarray(b[:, c:c + 64]), **kw).numpy()
        for c in range(0, 256, 64)], axis=1)
    scale = np.abs(four).max()
    assert np.abs(one - four).max() <= 1e-5 * scale
    for ref in _references(x, y, b, **kw):
        _hold(one, ref, tier, normalize)
