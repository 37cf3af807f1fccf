"""Card-only tests of the CUDA kernels and the solvers on them (marked
`cuda`; skip without a card).

This file imports neither jax nor kmb_tpu, so it also runs on a machine
with the card and no JAX, without the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Each kernel is held against the plain PyTorch version on the same card and
inputs: 1e-4 of the largest output in the f32 tiers (different summation
orders; the large-D form is 3xTF32), 2e-2 in the bfloat16 tier (the
small-D kernels round each flash weight against the running max, the
plain version against the row's max; the large-D kernels take the row's
max in a first pass), 1e-3 for logits above 100 (tests/test_ops.py:82).
The solvers on the kernel are held against the same solve on the plain
version on the card: iteration counts within 5% (at least 2; the plain
version's own spread over orderings on the ill-conditioned cases named at
SOLVES), residuals within 2x or at the tolerance (the roundings of two
float32 products set where a Krylov loop stops, as in
tests/test_torch_solve.py).  The kernel's float32 sum over 131072 columns
is held to within 2x of the plain version's error against float64.
"""

import numpy as np
import pytest
import torch

from kmb_tpu_torch import trace
from kmb_tpu_torch.ops import _build
from kmb_tpu_torch.ops import solve
from kmb_tpu_torch.ops.product import (kernel_matvec, kernel_matvec_torch,
                                       signal_plan)

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
@pytest.mark.parametrize("d", [9, 16, 25, 32, 37, 130])
@pytest.mark.parametrize("normalize", [False, True])
def test_tile_edges_match_plain_version(tier, kernel, d, normalize,
                                        cuda_points):
    # D not a multiple of 8 or 32 (and 16, 25, 32: rows of one chunk, the
    # one-chunk kernel in float32); N and M not multiples of 16, 64 or 128.
    x, y, b = cuda_points(301, 1203, d, 5)
    kw = dict(kernel_name=kernel, normalize_rows=normalize, precision=tier)
    _close(kernel_matvec(x, y, b, **kw), kernel_matvec_torch(x, y, b, **kw),
           TOL[tier])


@pytest.mark.cuda
@pytest.mark.parametrize("e", [1, 2, 4, 8, 13])
@pytest.mark.parametrize("d", [3, 16, 25, 32, 64])
@pytest.mark.parametrize("normalize", [False, True])
def test_signal_widths_match_plain_version(e, d, normalize, cuda_points):
    x, y, b = cuda_points(211, 999, d, e)
    kw = dict(kernel_name="gaussian", normalize_rows=normalize)
    _close(kernel_matvec(x, y, b, **kw), kernel_matvec_torch(x, y, b, **kw))


WIDE_E = [9, 16, 17, 32, 64, 100, 256, 512]
WIDE_D = [3, 8, 9, 37, 64, 256, 784]


def _launched_once(kernel, e, d, tier, before):
    # One launch of the wide mode, with the E blocks signal_plan gives.
    blocks = signal_plan(e, d > 8, tier == "bfloat16")[1]
    assert (kernel.launches - before[0], kernel.wide_launches - before[1],
            kernel.wide_eblocks - before[2]) == (1, 1, blocks)


def _counts(kernel):
    return kernel.launches, kernel.wide_launches, kernel.wide_eblocks


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["float32", "float32x3", "bfloat16"])
@pytest.mark.parametrize("e", WIDE_E)
@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("normalize", [False, True])
def test_wide_signals_match_plain_version(tier, e, d, normalize,
                                          cuda_points):
    # The wide mode (E > 8): one launch, the signal products on the tensor
    # cores.  Gaussian: the flash kernel when normalised.  N and M ragged
    # against the tiles of 128.
    x, y, b = cuda_points(301, 1203, d, e)
    kw = dict(kernel_name="gaussian", normalize_rows=normalize,
              precision=tier)
    kernel = _build.FLASH if normalize else _build.DIRECT
    before = _counts(kernel)
    got = kernel_matvec(x, y, b, **kw)
    _launched_once(kernel, e, d, tier, before)
    _close(got, kernel_matvec_torch(x, y, b, **kw), TOL[tier])


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["float32", "float32x3", "bfloat16"])
@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("d", [3, 9, 37, 64, 130, 256, 784])
@pytest.mark.parametrize("e", [17, 40, 64])
def test_wide_signals_with_limits_and_deferred_states(tier, kernel, d, e,
                                                      cuda_points):
    # Limits ending inside a tile of 128, the diagonal through both tile
    # kinds, deferred states; one launch with signal_plan's E blocks.
    x, y, b = cuda_points(517, 1203, d, e)
    for normalize in (False, True):
        kw = dict(kernel_name=kernel, normalize_rows=normalize,
                  deferred=True, row_offset=40, col_offset=3,
                  row_limit=40 + 200, col_limit=3 + 700, mask_diagonal=True,
                  precision=tier)
        which = (_build.FLASH if normalize and kernel != "inverse-distance"
                 else _build.DIRECT)
        before = _counts(which)
        got = kernel_matvec(x, y, b, **kw)
        _launched_once(which, e, d, tier, before)
        for g, w in zip(got, kernel_matvec_torch(x, y, b, **kw)):
            if w is None:
                assert g is None
                continue
            masked = w.abs() >= 1e29
            assert torch.equal(g.abs() >= 1e29, masked)
            _close(g[~masked], w[~masked], TOL[tier])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 25, 64, 130])
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
@pytest.mark.parametrize("kernel", ALL_KERNELS)
def test_one_chunk_diagonal_of_equal_points_with_limits(kernel, cuda_points):
    # D25, x is y: the diagonal mask of the one-chunk kernel (on the pairs
    # of equal points: equal offsets) through both tile kinds, row and
    # column limits ending inside a tile of 128, and the deferred states
    # (flash where the kernel has a log form).
    _, y, b = cuda_points(1, 1203, 25, 3)
    for normalize in (False, True):
        kw = dict(kernel_name=kernel, normalize_rows=normalize,
                  deferred=True, row_offset=40, col_offset=40,
                  row_limit=40 + 900, col_limit=40 + 700, mask_diagonal=True)
        before = trace.counters().get("one_chunk_launches", 0)
        got = kernel_matvec(y, y, b, **kw)
        assert trace.counters()["one_chunk_launches"] == before + 1
        for g, w in zip(got, kernel_matvec_torch(y, y, b, **kw)):
            if w is None:
                assert g is None
                continue
            masked = w.abs() >= 1e29
            assert torch.equal(g.abs() >= 1e29, masked)
            _close(g[~masked], w[~masked])


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("m, col_limit", [(1203, 10), (60000, 2**31 - 1)])
def test_one_chunk_empty_splits(normalize, m, col_limit, cuda_points):
    # Blocks with no source column: every split when the column limit ends
    # before the first column (no tensor map is encoded then), and the
    # empty splits past the end when one row block gets many splits (N =
    # 100, M = 60000: 117 splits of 640 columns).  Both give the empty
    # state, as the plain version does.
    x, y, b = cuda_points(100, m, 25, 1)
    kw = dict(kernel_name="exponential", normalize_rows=normalize,
              deferred=True, col_offset=10, col_limit=col_limit)
    for g, w in zip(kernel_matvec(x, y, b, **kw),
                    kernel_matvec_torch(x, y, b, **kw)):
        if w is None:
            assert g is None
            continue
        masked = w.abs() >= 1e29
        assert torch.equal(g.abs() >= 1e29, masked)
        if bool((~masked).any()):
            _close(g[~masked], w[~masked])


@pytest.mark.cuda
@pytest.mark.parametrize("d, tier, taken", [(25, "float32", True),
                                            (25, "float32x3", True),
                                            (37, "float32", False),
                                            (64, "float32", False),
                                            (25, "bfloat16", False)])
def test_one_chunk_launches_are_counted_and_report_their_staging(
        d, tier, taken, cuda_points):
    # A float32 flash call whose rows are one chunk (D <= 32) takes the
    # one-chunk kernel: the counter rises by one and the launch reports its
    # TMA ring with x resident and every tile's bytes (both y planes and the
    # signal a tile, per row block).  Longer rows and bf16 keep large_d.cuh,
    # which stages nothing through TMA.
    n, m = 300, 1000
    x, y, b = cuda_points(n, m, d, 1)
    before = trace.counters().get("one_chunk_launches", 0)
    kernel_matvec(x, y, b, kernel_name="exponential", normalize_rows=True,
                  precision=tier)
    torch.cuda.synchronize()
    after = trace.counters().get("one_chunk_launches", 0)
    stages, resident, staged = _build.FLASH.last_staging
    if taken:
        assert after == before + 1
        assert stages >= 4 and resident == 1
        assert staged >= -(-n // 128) * -(-m // 128) * (2 * 128 * 128 + 512)
    else:
        assert after == before
        assert (stages, resident, staged) == (0, 0, 0)


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
    x, y, b = cuda_points(300, 700, 3, 11)  # 11 columns: the wide mode
    kernel = getattr(_build, which)
    before, wide = kernel.launches, kernel.wide_launches
    eblocks = kernel.wide_eblocks
    kernel_matvec(x, y, b, kernel_name="gaussian", normalize_rows=normalize)
    assert kernel.launches == before + 1
    assert kernel.wide_launches == wide + 1
    assert kernel.wide_eblocks == eblocks + 1


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
@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_large_d_form_at_the_diagonal_of_equal_points(mode, cuda_points):
    # x = y at D = 256: the form |x|^2 + |y|^2 - 2<x, y> of the diagonal
    # pairs cancels to about 0, and abs-exp's square root amplifies its
    # error.  The 3xTF32 form product added per chunk on the FP32 units (the
    # tensor cores truncate as they accumulate) keeps the kernel within
    # 1e-4 of the plain version, in the wide mode (E = 16, one launch) and
    # the narrow mode (two launches of 8 columns).
    from kmb_tpu_torch.datasets import make_arrays

    arrays = make_arrays(
        "product-normal-D256-E16-M20000-N20000-absolute-exponential")
    y = torch.tensor(arrays["source_points"], dtype=torch.float32,
                     device="cuda")
    b = torch.tensor(arrays["source_signal"], dtype=torch.float32,
                     device="cuda")
    kw = dict(kernel_name="absolute-exponential")
    if mode == "wide":
        got = kernel_matvec(y, y, b, **kw)
    else:
        got = torch.cat([kernel_matvec(y, y, b[:, c:c + 8].contiguous(), **kw)
                         for c in (0, 8)], dim=1)
    _close(got, kernel_matvec_torch(y, y, b, **kw))


# (D, E) of the bf16 flash draws: the narrow large-D kernel (E = 1), the
# large-D wide kernel (E = 16 and 64, at D = 784 and 64), and the small-D
# kernels, narrow and wide (D = 3 and 8).
FLASH_DRAWS = [(784, 1), (784, 16), (784, 64), (64, 16), (64, 64), (3, 1),
               (8, 1), (3, 16), (8, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gaussian", "absolute-exponential",
                                    "exponential"])
@pytest.mark.parametrize("d, e", FLASH_DRAWS)
def test_bf16_large_d_flash_over_draws(kernel, d, e, cuda_points):
    # N = 300, M = 411, normalised, bfloat16: on draws whose outputs cancel
    # (at D = 784 the largest output near 0.01) a weight rounded to bf16
    # against a running max and against the row's max differ by 2-4% of
    # the largest output, though both are as far from float64.  The large-D
    # kernels' first pass takes the row's max, so each draw is held to the
    # plain version at the bfloat16 limit; the same draws run through every
    # bf16 flash kernel.
    for seed in range(8):
        x, y, b = cuda_points(300, 411, d, e, seed=100 + seed)
        kw = dict(kernel_name=kernel, normalize_rows=True)
        got = kernel_matvec(x, y, b, precision="bfloat16", **kw)
        want = kernel_matvec_torch(x, y, b, precision="bfloat16", **kw)
        exact = kernel_matvec_torch(x.double(), y.double(), b.double(), **kw)
        scale = float(exact.abs().max())
        print(f"{kernel} D={d} E={e} draw {seed}: kernel vs float64 "
              f"{float((got.double() - exact).abs().max()) / scale:.3e}, "
              f"plain vs float64 "
              f"{float((want.double() - exact).abs().max()) / scale:.3e}")
        _close(got, want, TOL["bfloat16"])


@pytest.mark.cuda
def test_profiler_hook_after_many_launches(tmp_path, monkeypatch):
    # The runner's torch.profiler hook traces one query of a process that
    # has launched 10^5 kernels before: the trace holds the query's kernel.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import json
    import os

    from kmb_tpu_torch.datasets import make_arrays
    from kmb_tpu_torch.definitions import Definition
    from kmb_tpu_torch.runner import TRACE_FILE, run_on_arrays

    x = torch.randn((64, 3), device="cuda")
    b = torch.randn((64, 1), device="cuda")
    for _ in range(100_000):
        kernel_matvec(x, x, b, kernel_name="gaussian")
    torch.cuda.synchronize()
    arrays = make_arrays("product-cube-D3-E1-M1000-N1000-gaussian")
    arrays["target_signal"] = arrays["source_signal"]   # any truth
    monkeypatch.setenv("KMB_PROFILE_DIR", str(tmp_path))
    definition = Definition(
        algorithm="torch-product",
        module="kmb_tpu_torch.algorithms.torch_engine",
        constructor="TorchProduct",
        arguments={"kernel": "gaussian", "dimension": 3},
        query_argument_groups=[{}])
    (row,) = run_on_arrays(definition, arrays, runs=1)
    with open(os.path.join(row.attrs["profile_trace"], TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("small_d_kernel" in name for name in kernels), kernels


@pytest.mark.cuda
def test_profiler_hook_never_writes_a_trace_without_the_kernels():
    # The history that loses the hand kernels' profiler records (ROADMAP
    # Queue 3): a profiled query, a pause of 75 s, then more profiled
    # queries, in a fresh process (tools/profiler_sequence.py).  Whether
    # or not CUPTI drops them this time, the hook never writes a trace
    # without them: each session's trace holds them, or the hook refuses.
    import json
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "profiler_sequence.py"),
         "--repeats", "5", "--child", "a 75-second pause"], cwd=root,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    print(counts)
    assert counts["sessions"] == 10 and counts["lost unseen"] == 0
    assert counts["kept"] + counts["refused"] == 10 and counts["kept"] >= 1


@pytest.mark.cuda
def test_launch_timer_after_the_profiler_suspects(tmp_path, monkeypatch,
                                                  cuda_points):
    # The history the profiler's lost records were traced to in long
    # processes: cuSOLVER and a float64 eigh, the float64 plain product,
    # 60 CUDA-only profiler sessions.  Then the runner's hook still traces
    # the query's kernel, and the launch timer (CUDA events around each
    # launch, which replaced the profiler for the kernel-alone times) reads
    # one time per launch, each no longer than the call that made it.
    import json
    import os
    import time

    from torch.profiler import ProfilerActivity, profile

    from kmb_tpu_torch.datasets import make_arrays
    from kmb_tpu_torch.definitions import Definition
    from kmb_tpu_torch.runner import TRACE_FILE, run_on_arrays

    a = torch.randn((2000, 2000), device="cuda")
    lu, piv = torch.linalg.lu_factor(a @ a.T + 2000 * torch.eye(
        2000, device="cuda"))
    torch.linalg.lu_solve(lu, piv, torch.ones((2000, 1), device="cuda"))
    s = torch.randn((256, 256), device="cuda", dtype=torch.float64)
    torch.linalg.eigh(s @ s.T)
    x, y, b = cuda_points(3000, 3000, 3, 1)
    kernel_matvec_torch(x.double(), y.double(), b.double(),
                        kernel_name="gaussian")
    for _ in range(60):
        with profile(activities=[ProfilerActivity.CUDA]):
            kernel_matvec(x, y, b, kernel_name="gaussian")
            torch.cuda.synchronize()

    arrays = make_arrays("product-cube-D3-E1-M1000-N1000-gaussian")
    arrays["target_signal"] = arrays["source_signal"]   # any truth
    monkeypatch.setenv("KMB_PROFILE_DIR", str(tmp_path))
    definition = Definition(
        algorithm="torch-product",
        module="kmb_tpu_torch.algorithms.torch_engine",
        constructor="TorchProduct",
        arguments={"kernel": "gaussian", "dimension": 3},
        query_argument_groups=[{}])
    (row,) = run_on_arrays(definition, arrays, runs=1)
    with open(os.path.join(row.attrs["profile_trace"], TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any("small_d_kernel" in e["name"] for e in events
               if e.get("cat") == "kernel")

    x, y, b = cuda_points(20000, 20000, 3, 1)
    kernel_matvec(x, y, b, kernel_name="gaussian")
    for _ in range(3):
        torch.cuda.synchronize()
        started = time.perf_counter()
        with _build.launch_timer() as times:
            kernel_matvec(x, y, b, kernel_name="gaussian")
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - started) * 1e3
        assert len(times) == 1
        assert 0.0 < times[0] <= call_ms


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [3, 256])
def test_fixed_source_staging_follows_the_points(tier, d, cuda_points):
    # An engine's source points staged once (`fixed_source`): repeated
    # calls, and a call after the points changed in place, match the plain
    # version on the points as they are.
    x, y, b = cuda_points(200, 700, d, 40)
    kw = dict(kernel_name="gaussian", precision=tier)
    for _ in range(2):
        _close(kernel_matvec(x, y, b, fixed_source=True, **kw),
               kernel_matvec_torch(x, y, b, **kw), TOL[tier])
    y.mul_(1.25)
    _close(kernel_matvec(x, y, b, fixed_source=True, **kw),
           kernel_matvec_torch(x, y, b, **kw), TOL[tier])


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_large_d_wide_blocks_are_the_librarys(bf16, cuda_points):
    # The wrapper's E blocks at D > 8 (signal_plan) are the ones the
    # library has instantiations of, and no others.
    from kmb_tpu_torch.ops.product import _WIDE_BLOCKS_LARGE_D

    cuda_points(1, 1, 1, 1)   # skips without a card
    for eb in (16, 32, 64, 128):
        if eb in _WIDE_BLOCKS_LARGE_D[bf16]:
            _build.plan(64, eb, 0, False, False, bf16)
        else:
            with pytest.raises(RuntimeError, match="kmb_plan failed"):
                _build.plan(64, eb, 0, False, False, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize", [False, True])
def test_wide_launch_reports_its_staging(tier, normalize, cuda_points):
    # The large-D wide kernel reports what its launch staged through TMA:
    # a ring of 4 to 8 stages, x resident in bf16 at D = 256, and at least
    # y's bytes once per row block (its TF32 planes in the float32 tiers);
    # the narrow kernels stage nothing through TMA.
    n, m, d = 300, 1000, 256
    x, y, b = cuda_points(n, m, d, 40)
    kw = dict(kernel_name="exponential", normalize_rows=normalize,
              precision=tier)
    kernel = _build.FLASH if normalize else _build.DIRECT
    before = kernel.staged_bytes
    kernel_matvec(x, y, b, **kw)
    stages, resident, staged = kernel.last_staging
    assert 4 <= stages <= 8
    assert resident == (tier == "bfloat16")
    assert kernel.staged_bytes - before == staged
    row_blocks = -(-n // 128)
    assert staged >= row_blocks * m * d * (2 if tier == "bfloat16" else 8)
    kernel_matvec(x, y, b[:, :8], **kw)
    assert kernel.last_staging == (0, 0, 0)


@pytest.mark.cuda
def test_float64_on_the_card_raises(cuda_points):
    x, y, b = (t.double() for t in cuda_points(8, 9, 3, 1))
    with pytest.raises(TypeError, match="float32"):
        kernel_matvec(x, y, b, kernel_name="gaussian")


# -- the solvers on the direct kernel -----------------------------------------

@pytest.fixture
def solver_problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from kmb_tpu_torch.datasets import make_arrays

    def make(name, kernel=None):
        """(kernel, float32 points, float32 rhs = K b in float64) of a
        registry dataset, on the card; `kernel` overrides its kernel."""
        arrays = make_arrays(name)
        kernel = kernel or arrays["kernel"]
        y64 = torch.tensor(arrays["source_points"], device="cuda")
        b64 = torch.tensor(arrays["source_signal"], device="cuda")
        rhs = kernel_matvec_torch(y64, y64, b64, kernel_name=kernel)
        return kernel, y64.float(), rhs.float()

    return make


def _plain_matvec(y, kernel):
    def matvec(v):
        return kernel_matvec_torch(y, y, v, kernel_name=kernel)
    return matvec


# (dataset, preconditioner, indefinite_method, tol, band of iteration
# counts).  The band is how far the plain version's own count moves when
# the same problem is given in another order (other float32 roundings):
# its largest departure from the count in the registry's order, over
# eight orderings (solver_accuracy.py part 3, on an H100): 116 of 284
# for unpreconditioned CG on the Gaussian cube (condition beyond float32);
# 5% where that departure is smaller (at most 3.9%).  CG on the normal
# equations (condition squared, 264 of 489) is held over nine orderings
# below.
SOLVES = [
    ("solver-cube-D3-E1-M2000-N2000-gaussian", None, "auto", 1e-6, 0.41),
    ("solver-cube-D3-E1-M2000-N2000-gaussian", "jacobi", "auto", 1e-6,
     0.05),
    ("solver-sphere-D3-E1-M2000-N2000-inverse-distance", None, "auto", 1e-5,
     0.05),
    ("solver-sphere-D3-E1-M2000-N2000-inverse-distance", "jacobi", "minres",
     1e-5, 0.05),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name, precond, method, tol, band", SOLVES)
def test_krylov_on_the_kernel_matches_plain_version(name, precond, method,
                                                    tol, band,
                                                    solver_problem):
    kernel, y, rhs = solver_problem(name)
    pc = (solve.block_jacobi_preconditioner(y, kernel_name=kernel, leaf=512)
          if precond == "jacobi" else None)
    kw = dict(kernel_name=kernel, tol=tol, max_iters=2000, precond=pc,
              indefinite_method=method)
    before = _build.DIRECT.launches
    b, it, res = solve.cg_solve(y, rhs, **kw)
    launched = _build.DIRECT.launches - before
    pb, pit, pres = solve.cg_solve(y, rhs,
                                   matvec=_plain_matvec(y, kernel), **kw)
    assert _build.DIRECT.launches - before == launched   # plain: none
    assert launched >= it > 0
    assert abs(it - pit) <= max(2, band * pit), (it, pit)
    # Both converge alike: within 2x of the plain solve's residual, or to
    # the tolerance.
    assert res <= max(2.0 * pres, tol), (res, pres)
    assert b.is_cuda and bool(torch.isfinite(b).all())


@pytest.mark.cuda
def test_normal_equations_match_plain_version_over_orderings(solver_problem):
    # CG on K^2 (band 0.54: 264 of 489) stops either near 4e-6 after
    # about 500 iterations or near 2e-5 after about 340, by the roundings:
    # one ordering against one is a draw (the plain version fails that
    # comparison against itself in 5 of 7 orderings), so the medians over
    # nine orderings, the registry's and eight permutations, are compared,
    # to the band and factor of a single solve.  Every solve must launch
    # the kernel twice per iteration, the plain one never.
    name = "solver-sphere-D3-E1-M2000-N2000-inverse-distance"
    kernel, y0, rhs0 = solver_problem(name)
    kw = dict(kernel_name=kernel, tol=1e-6, max_iters=2000,
              indefinite_method="normal")
    runs = []
    for seed in [None, *range(8)]:
        y, rhs = y0, rhs0
        if seed is not None:
            perm = torch.randperm(len(y0), device="cuda", generator=(
                torch.Generator(device="cuda").manual_seed(seed)))
            y, rhs = y0[perm].contiguous(), rhs0[perm].contiguous()
        before = _build.DIRECT.launches
        b, it, res = solve.cg_solve(y, rhs, **kw)
        launched = _build.DIRECT.launches - before
        _, pit, pres = solve.cg_solve(y, rhs,
                                      matvec=_plain_matvec(y, kernel), **kw)
        assert _build.DIRECT.launches - before == launched   # plain: none
        assert launched >= 2 * it > 0
        assert b.is_cuda and bool(torch.isfinite(b).all())
        runs.append((it, res, pit, pres))
    it, res, pit, pres = np.median(np.array(runs), axis=0)
    assert abs(it - pit) <= 0.54 * pit, runs
    assert res <= max(2.0 * pres, 1e-6), runs


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "solver-cube-D3-E1-M131072-N131072-gaussian",
    "solver-sphere-D3-E1-M131072-N131072-inverse-distance"])
def test_direct_sum_as_accurate_as_plain_version(name, solver_problem):
    # A single float32 chain per row over a split's columns is off by
    # 1.6e-6 on the cube, 6.7x the plain version's 2.4e-7
    # (solver_accuracy.py): enough to stall the Krylov solves.  Rows
    # 0:1024 of the whole product (so the kernel splits its columns as the
    # solvers' calls do) against float64 from the same float32 inputs.
    kernel, y, _ = solver_problem(name)
    b = torch.randn((len(y), 1), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    rows = slice(0, 1024)
    exact = kernel_matvec_torch(y[rows].double(), y.double(), b.double(),
                                kernel_name=kernel)
    err = [float(torch.linalg.norm(fn(y, y, b, kernel_name=kernel)[rows]
                                   .double() - exact)
                 / torch.linalg.norm(exact))
           for fn in (kernel_matvec, kernel_matvec_torch)]
    assert err[0] <= 2.0 * err[1], err


@pytest.mark.cuda
def test_nystrom_sketch_on_the_kernel_matches_plain_version(solver_problem):
    kernel, y, _ = solver_problem("solver-cube-D3-E1-M2000-N2000-gaussian")
    omega = torch.randn((2000, 256), generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    before = _build.DIRECT.launches, _build.DIRECT.wide_eblocks
    u, lam = solve.nystrom_factors(
        solve._default_matvec(y, kernel_name=kernel, precision="float32"),
        omega)
    # One launch of one E block: each kernel value computed once.
    assert (_build.DIRECT.launches - before[0],
            _build.DIRECT.wide_eblocks - before[1]) == (1, 1)
    pu, plam = solve.nystrom_factors(_plain_matvec(y, kernel), omega)
    # The factors of two f32 sketches: U diag(lam) U^T within 1e-4 of
    # lam_0 (tests/test_torch_solve.py's bound for two packages).
    _close((u * lam) @ u.T, (pu * plam) @ pu.T)


@pytest.mark.cuda
def test_nystrom_gram_ignores_a_process_wide_tf32(solver_problem):
    kernel, y, _ = solver_problem("solver-cube-D3-E1-M2000-N2000-gaussian")
    omega = torch.randn((2000, 64), generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    op = _plain_matvec(y, kernel)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want = solve.nystrom_factors(op, omega)
        a = torch.randn((512, 512), device="cuda")
        exact = a @ a
        torch.set_float32_matmul_precision("high")
        # The setting is live: a bare matmul now runs on TF32 ...
        assert not torch.allclose(a @ a, exact, rtol=1e-5, atol=1e-5)
        # ... and the solver's Gram and factors do not.
        got = solve.nystrom_factors(op, omega)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6 * float(
            w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["lu", "cholesky", "svd"])
def test_dense_solve_on_the_card_matches_the_cpu(method, solver_problem):
    # Cholesky on an SPD system on which float32 Cholesky does not break.
    kernel, y, rhs = (
        solver_problem("solver-cube-D3-E1-M1000-N1000-gaussian",
                       "absolute-exponential") if method == "cholesky" else
        solver_problem("solver-sphere-D3-E1-M2000-N2000-inverse-distance"))
    kw = dict(kernel_name=kernel, method=method)
    got = solve.dense_solve(y, rhs, **kw)
    want = solve.dense_solve(y.cpu(), rhs.cpu(), **kw)
    res = [float(torch.linalg.norm(kernel_matvec_torch(
        y.cpu().double(), y.cpu().double(), b.cpu().double(),
        kernel_name=kernel) - rhs.cpu().double()) / torch.linalg.norm(
            rhs.cpu().double())) for b in (got, want)]
    # cuSOLVER and LAPACK factor the same f32 matrix: residuals within 10x
    # of each other or at the f32 floor.
    assert res[0] <= max(10 * res[1], 1e-5), res


@pytest.mark.cuda
def test_f64_residual_matvec_on_the_card(solver_problem):
    kernel, y, rhs = solver_problem(
        "solver-sphere-D3-E1-M1000-N1000-inverse-distance")
    from kmb_tpu_torch.algorithms.bruteforce_numpy import (
        blocked_kernel_product)

    v = rhs.double()
    got = solve.f64_residual_matvec(y, kernel_name=kernel)(v)
    want = blocked_kernel_product(kernel=kernel,
                                  source_points=y.double().cpu().numpy(),
                                  source_signal=v.cpu().numpy())
    assert got.is_cuda and got.dtype == torch.float64
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.cuda
def test_solver_cg_lifecycle_on_the_card(solver_problem):
    from kmb_tpu_torch.algorithms.torch_engine import TorchSolverCG

    kernel, y, rhs = solver_problem("solver-cube-D3-E1-M2000-N2000-gaussian")
    algo = TorchSolverCG(kernel=kernel, dimension=3, precond_rank=256,
                         refine_iters=3)
    assert algo.device.type == "cuda"
    algo.prepare_data(source_points=y.cpu().numpy())
    algo.fit()
    algo.set_query_arguments(tol=1e-9, max_iters=2000, inner_tol=1e-5)
    algo.prepare_query(target_signal=rhs.cpu().numpy())
    before = _build.DIRECT.launches
    algo.query()
    extra = algo.get_additional()
    assert _build.DIRECT.launches - before >= extra["cg_iterations"] > 0
    assert extra["ir_outer_iterations"] >= 1
    assert extra["device_name"] == torch.cuda.get_device_name()
    assert algo.get_result().dtype == np.float64
    algo.done()


# The approximate engines on the card (ops/blr.py, ops/lowrank.py,
# algorithms/torch_approx.py): held against the same computation on the
# CPU, with the ranks and matvec tolerances of tests/test_torch_blr.py.
BLR_ARGS = dict(kernel_name="inverse-distance", leaf=64, rank=64, eta=2.0,
                epsilon=1e-4, same_points=True)   # 484 far pairs at M = 2000


@pytest.fixture
def blr_problem(solver_problem):
    _, y, rhs = solver_problem(
        "solver-sphere-D3-E1-M2000-N2000-inverse-distance")
    from kmb_tpu_torch.ops import blr

    omega = blr.draw_test_matrix(64, 64, 0, device="cpu")
    return y.cpu().numpy(), rhs, omega


@pytest.mark.cuda
def test_blr_build_and_matvec_on_the_card_match_the_cpu(blr_problem):
    from kmb_tpu_torch.ops import blr

    y, rhs, omega = blr_problem
    card = blr.BlrOperator(y, y, omega=omega, device="cuda", **BLR_ARGS)
    host = blr.BlrOperator(y, y, omega=omega, device="cpu", **BLR_ARGS)
    assert card.block_ranks.size > 100
    assert np.mean(card.block_ranks == host.block_ranks) >= 0.99
    assert np.abs(card.block_ranks - host.block_ranks).max() <= 1
    got = card.matvec(rhs)
    assert got.is_cuda
    _close(got.cpu(), host.matvec(rhs.cpu()), 5e-4)


@pytest.mark.cuda
def test_blr_matvec_on_the_card_is_bit_identical(blr_problem):
    from kmb_tpu_torch.ops import blr

    y, rhs, omega = blr_problem
    op = blr.BlrOperator(y, y, omega=omega, device="cuda", **BLR_ARGS)
    first = op.matvec(rhs)
    assert all(torch.equal(first, op.matvec(rhs)) for _ in range(3))


@pytest.mark.cuda
def test_blr_build_ignores_a_process_wide_tf32(blr_problem):
    from kmb_tpu_torch.ops import blr

    y, rhs, omega = blr_problem
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want = blr.BlrOperator(y, y, omega=omega, device="cuda", **BLR_ARGS)
        a = torch.randn((512, 512), device="cuda")
        exact = a @ a
        torch.set_float32_matmul_precision("high")
        # The setting is live: a bare matmul now runs on TF32 ...
        assert not torch.allclose(a @ a, exact, rtol=1e-5, atol=1e-5)
        # ... and the build and the matvec do not.
        got = blr.BlrOperator(y, y, omega=omega, device="cuda", **BLR_ARGS)
        np.testing.assert_array_equal(got.block_ranks, want.block_ranks)
        assert torch.equal(got.matvec(rhs), want.matvec(rhs))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)


@pytest.mark.cuda
def test_blr_solver_true_residual_is_one_direct_launch(blr_problem):
    from kmb_tpu_torch.algorithms.torch_approx import BlrSolver

    y, rhs, _ = blr_problem
    algo = BlrSolver(kernel="inverse-distance", dimension=3, rank=64,
                     epsilon=1e-4, tol=1e-5, max_iters=2000)
    assert algo.device.type == "cuda"
    algo.prepare_data(source_points=y)
    algo.fit()
    algo.prepare_query(target_signal=rhs.cpu().numpy())
    before = _build.DIRECT.launches
    algo.query()
    assert _build.DIRECT.launches - before == 1
    extra = algo.get_additional()
    assert extra["cg_iterations"] > 0
    before = _build.DIRECT.launches
    residual = algo._true_residual(algo.res)
    assert _build.DIRECT.launches - before == 1
    assert residual == pytest.approx(extra["true_relative_residual"])
    assert algo.get_result().dtype == np.float64
    algo.done()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gaussian", "exponential"])
def test_streamed_random_features_match_materialised(kernel, cuda_points):
    from kmb_tpu_torch.ops import lowrank

    x, y, b = cuda_points(5000, 7000, 8, 3)
    omega, phase = lowrank.random_feature_params(8, kernel, 512, seed=0,
                                                 device="cuda")
    normalize = kernel == "exponential"
    want = lowrank.feature_apply(lowrank._feature_block(omega, phase, x),
                                 lowrank._feature_block(omega, phase, y), b,
                                 normalize_rows=normalize)
    got = lowrank.feature_apply_streamed(omega, phase, x, y, b,
                                         normalize_rows=normalize,
                                         block=1024)
    assert got.is_cuda
    # tests/test_lowrank.py:237's 2e-5, of the largest output.
    _close(got, want, 2e-5)


# -- the sharded engines' per-shard arithmetic, on one card --------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("d", [3, 64])
@pytest.mark.parametrize("normalize", [False, True])
def test_ring_chunks_at_four_virtual_ranks_match_plain_version(
        kernel, d, normalize, cuda_points):
    # Ragged N and M (padded shards, limits inside the last shard), column
    # offsets on every chunk; for the singular kernel also the same points,
    # its diagonal masked at global positions.  (At the same points the
    # other kernels take a zero distance from a cancelled form: at D = 64
    # the float32 plain version alone is 1.3e-4 off float64 for the
    # absolute-exponential's square root, beyond the 1e-4 held here.)
    from kmb_tpu_torch.parallel import sharded

    x, y, b = cuda_points(1037, 1511, d, 3)
    kw = dict(kernel_name=kernel, normalize_rows=normalize)
    before = _build.DIRECT.launches + _build.FLASH.launches
    got = sharded.virtual_ring_product(x, y, b, p=4, **kw)
    assert _build.DIRECT.launches + _build.FLASH.launches - before >= 16
    _close(got, kernel_matvec_torch(x, y, b, **kw))
    if kernel == "inverse-distance":
        same = sharded.virtual_ring_product(y, y, b, p=4, **kw)
        _close(same, kernel_matvec_torch(y, y, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gaussian", "inverse-distance",
                                    "exponential"])
def test_ring_chunk_states_match_plain_version(kernel, cuda_points):
    # Each chunk's deferred state, kernel against plain version, at the
    # offsets and limits ring step `step` of rank `me` gives it.
    from kmb_tpu_torch.parallel import sharded

    x, y, b = cuda_points(1037, 1511, 64, 2)
    normalize = kernel != "inverse-distance"
    for me, step in ((0, 0), (1, 2), (3, 1)):
        owner = (me - step) % 4
        xs = sharded.shard_rows(x, 4, me, x.device)
        ys = sharded.shard_rows(y, 4, owner, x.device)
        bs = sharded.shard_rows(b, 4, owner, x.device)
        kw = dict(me=me, step=step, p=4, n=len(x), m=len(y),
                  kernel_name=kernel, normalize_rows=normalize)
        got = sharded.ring_chunk(xs, ys, bs, **kw)
        want = kernel_matvec_torch(
            xs, ys, bs, kernel_name=kernel, normalize_rows=normalize,
            deferred=True, row_offset=me * len(xs),
            col_offset=owner * len(ys), col_limit=len(y), row_limit=len(x))
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            # -1e30 marks rows with no valid column (padding): exact.
            sentinel = w <= -1e29
            assert torch.equal(g <= -1e29, sentinel)
            _close(torch.where(sentinel, 0.0, g), torch.where(sentinel, 0.0, w))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gaussian", "inverse-distance",
                                    "exponential"])
def test_allpairs_blocks_on_a_virtual_grid_match_plain_version(kernel,
                                                               cuda_points):
    from kmb_tpu_torch.parallel import sharded

    x, y, b = cuda_points(1037, 1511, 3, 2)
    kw = dict(kernel_name=kernel, normalize_rows=kernel == "exponential")
    _close(sharded.virtual_allpairs_product(x, y, b, pt=2, ps=2, **kw),
           kernel_matvec_torch(x, y, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["_pcg", "_minres"])
def test_allreduce_hook_default_is_bit_identical_on_the_card(loop,
                                                            solver_problem):
    # The hook's default (no collective) and an explicit identity, which
    # takes the batched path (stacked sums, unbound), give the same bits.
    name = ("solver-cube-D3-E1-M2000-N2000-gaussian" if loop == "_pcg"
            else "solver-sphere-D3-E1-M2000-N2000-inverse-distance")
    kernel, y, rhs = solver_problem(name)

    def matvec(v):
        return kernel_matvec(y, y, v, kernel_name=kernel)

    fn = getattr(solve, loop)
    b0, it0, res0 = fn(matvec, rhs, 1e-6, 300)
    b1, it1, res1 = fn(matvec, rhs, 1e-6, 300, allreduce=lambda t: t)
    assert it0 == it1 > 0 and res0 == res1
    assert torch.equal(b0, b1)


@pytest.fixture
def nccl_world_of_one(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs only there")
    import torch.distributed as dist

    from kmb_tpu_torch.parallel import multihost

    assert multihost.initialize(f"file://{tmp_path}/store", num_processes=1,
                                process_id=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "solver-cube-D3-E1-M2000-N2000-gaussian",
    "solver-sphere-D3-E1-M2000-N2000-inverse-distance"])
def test_sharded_solve_in_an_nccl_world_of_one_is_bit_identical(
        name, solver_problem, nccl_world_of_one):
    # Every dot product through a real NCCL all-reduce of one rank, and the
    # ring matvec at p = 1: the single-card solve, bit for bit (M = 2000 is
    # a multiple of 8, so no padding).
    from kmb_tpu_torch.parallel import sharded

    kernel, y, rhs = solver_problem(name)
    mesh = sharded.make_mesh()
    assert mesh.distributed and mesh.device.type == "cuda"
    got, it, res = sharded.sharded_cg_solve(
        y, rhs, mesh=mesh, kernel_name=kernel, tol=1e-6, max_iters=300)
    want, want_it, want_res = solve.cg_solve(y, rhs, kernel_name=kernel,
                                             tol=1e-6, max_iters=300)
    assert it == want_it > 0 and res == want_res
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_ring_chunked_sketch_as_accurate_as_one_launch(cuda_points):
    # The sharded Nystrom build's sketch K @ Q at E = 256 as four ranks
    # compute it (16 chunk launches of the wide mode on the packed (y | b)
    # signal, folded in ring order) against one launch: each column's
    # error against float64 within 1.5x of the one launch's (max and
    # median over the columns; 1.009x and 0.975x at 131072 points,
    # chip_smoke.py phase 7).  A chunk on the packed signal's strided
    # halves is the chunk on contiguous shards, bit for bit.
    from kmb_tpu_torch.parallel import sharded

    _, y, q = cuda_points(1, 32768, 3, 256)
    one = kernel_matvec(y, y, q, kernel_name="gaussian")
    ring = sharded.virtual_ring_product(y, y, q, p=4, kernel_name="gaussian")
    ys, qs = (sharded.shard_rows(t, 4, 1, y.device) for t in (y, q))
    packed = torch.cat([ys, qs], dim=1)
    chunk = dict(me=2, step=1, p=4, n=len(y), m=len(y),
                 kernel_name="gaussian")
    assert torch.equal(
        sharded.ring_chunk(ys, packed[:, :3], packed[:, 3:], **chunk)[0],
        sharded.ring_chunk(ys, ys, qs, **chunk)[0])
    y64 = y.double()
    exact = kernel_matvec_torch(y64, y64, q.double(), kernel_name="gaussian")
    norms = torch.linalg.vector_norm(exact, dim=0)

    def errors(sketch):
        return torch.linalg.vector_norm(sketch.double() - exact,
                                        dim=0) / norms

    got, want = errors(ring), errors(one)
    assert float(got.max()) <= 1.5 * float(want.max())
    assert float(got.median()) <= 1.5 * float(want.median())
