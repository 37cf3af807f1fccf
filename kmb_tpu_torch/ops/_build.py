"""Build and bind the hand-written CUDA kernels.

The sources under `csrc/` are compiled by plain `nvcc`, one process per
source, all started together, into objects that one more `nvcc` links into
a shared library with a C interface (`product.cu` holds the entry points).
The library is loaded with ctypes, at first use, once per process.  This
takes seconds; `torch.utils.cpp_extension.load` compiles against PyTorch's
headers and takes minutes for the same files, which every fresh checkout
would pay again.  The library lands in `kmb_tpu_torch/_build/` (git
ignored), named by a hash of the sources and the commands, so an edited
source is rebuilt and an unchanged one is reused.  Beside it,
`<library>.ptxas.txt` keeps ptxas's report (`-Xptxas -v`: registers, shared
memory and spills of every kernel, and each compile's seconds).

Each kernel is a `CudaKernel`: a callable that launches through ctypes,
raises on a non-zero `cudaError_t`, and counts its launches and the bytes
the large-D wide kernel's launches staged (as the library reports them);
inside `launch_timer()` the library brackets each launch with CUDA events
on its stream, the kernel's device time without the profiler.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "product.cu"   # the C entry points
SOURCES = (SOURCE, *(CSRC / f"small_d_{dp}_{scheme}.cu" for dp in (3, 8)
                     for scheme in ("direct", "flash")),
           CSRC / "large_d_tf32.cu", CSRC / "large_d_bf16.cu",
           # The wide-signal mode (E > 8).
           *(CSRC / f"small_d_wide_{dp}_{tier}.cu" for dp in (3, 8)
             for tier in ("tf32", "bf16")),
           CSRC / "large_d_wide_tf32.cu", CSRC / "large_d_wide_bf16.cu")
HEADERS = (CSRC / "common.cuh", CSRC / "mma.cuh", CSRC / "wide.cuh",
           CSRC / "small_d.cuh", CSRC / "small_d_wide.cuh",
           CSRC / "large_d.cuh", CSRC / "large_d_wide.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# Extra -D switches of the sources, set by `use_defines` (measurement
# tools: tools/wide_breakdown.py); none in the package's own build.
DEFINES = ()

# The kernels' function names (csrc/*.cuh), in a profiler's events'
# names, demangled or not.
KERNEL_NAME = re.compile(r"(?:small|large)_d(?:_wide)?_kernel")

_lock = threading.Lock()
_library = None
_TIMER_CAP = 1 << 16   # launches one launch_timer() block may time


def find_nvcc() -> str | None:
    """nvcc from CUDA_HOME, then PATH, then the toolkit's default prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    return None


def nvcc_command(nvcc: str, source: Path, output: Path) -> list[str]:
    """Compile one source: sm_90a, C++17, -O3, position-independent code,
    with ptxas's register and spill report."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
            *(f"-D{name}" for name in DEFINES), "-Xptxas", "-v", "-c",
            "-o", str(output), str(source)]


def link_command(nvcc: str, objects, output: Path) -> list[str]:
    """Link the objects into the shared library."""
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(output),
            *(str(o) for o in objects)]


def library_path(nvcc: str) -> Path:
    digest = hashlib.sha256()
    for path in (*SOURCES, *HEADERS):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(nvcc_command(nvcc, SOURCE, Path("x"))).encode())
    digest.update(" ".join(link_command(nvcc, [], Path("x"))).encode())
    return BUILD_DIR / f"libkmb_product_{digest.hexdigest()[:16]}.so"


def report_path(library: Path) -> Path:
    """ptxas's report for a built library."""
    return library.with_suffix(".ptxas.txt")


def _run(cmd):
    start = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc, time.perf_counter() - start


def _run_all(commands):
    """Run the commands concurrently; raise with the output of any failure.

    Returns each command's output, headed by its source and seconds.
    """
    with ThreadPoolExecutor(max_workers=len(commands)) as pool:
        results = list(pool.map(_run, commands))
    failed = [f"nvcc failed ({proc.returncode}) on {cmd[-1]}:\n"
              f"{proc.stdout[-4000:]}"
              for cmd, (proc, _) in zip(commands, results)
              if proc.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return [f"== {Path(cmd[-1]).name} ({seconds:.1f} s)\n{proc.stdout}"
            for cmd, (proc, seconds) in zip(commands, results)]


def build() -> Path:
    """Compile the kernels unless an identical build exists; return its path."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "the CUDA kernels need a CUDA device; CPU tensors take the plain "
            "PyTorch path (kernel_matvec_torch)")
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); it is needed "
            f"to build {', '.join(s.name for s in SOURCES)}")
    target = library_path(nvcc)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build in a private directory and rename, so concurrent processes never
    # load a half-written library.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / f"{src.stem}.o" for src in SOURCES]
        logs = _run_all([nvcc_command(nvcc, src, obj)
                         for src, obj in zip(SOURCES, objects)])
        library = Path(tmp) / target.name
        _run_all([link_command(nvcc, objects, library)])
        report = Path(tmp) / report_path(target).name
        report.write_text("".join(logs))
        os.replace(report, report_path(target))
        os.replace(library, target)
    return target


def use_defines(*names: str) -> None:
    """Build (into a library of its own) and load the kernels with these
    -D switches from the next launch on; none restores the package's build.
    For measurement tools: the switches change what the kernels compute."""
    global DEFINES, _library
    with _lock:
        DEFINES = tuple(names)
        _library = None


def load_library() -> ctypes.CDLL:
    """Build (once per process) and load the kernel library."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            # n, n_ok, m_eff, d, nc, kernel, diag, shift, splits, bf16, ldb,
            # eblocks, then the stream.
            ints = [i32] * 12 + [ptr]
            lib.kmb_direct_matvec.argtypes = [ptr] * 8 + ints
            lib.kmb_direct_matvec.restype = i32
            lib.kmb_flash_matvec.argtypes = [ptr] * 9 + ints
            lib.kmb_flash_matvec.restype = i32
            # d, nc, kernel, flash, den, bf16 -> rows, blocks per SM.
            lib.kmb_plan.argtypes = [i32] * 6 + [ctypes.POINTER(i32)] * 2
            lib.kmb_plan.restype = i32
            lib.kmb_timer_begin.argtypes = []
            lib.kmb_timer_begin.restype = i32
            lib.kmb_timer_end.argtypes = [ctypes.POINTER(ctypes.c_float), i32,
                                          ctypes.POINTER(i32)]
            lib.kmb_timer_end.restype = i32
            lib.kmb_last_staging.argtypes = [ctypes.POINTER(i32)] * 2 + [
                ctypes.POINTER(ctypes.c_longlong)]
            lib.kmb_last_staging.restype = None
            lib.kmb_error_string.argtypes = [i32]
            lib.kmb_error_string.restype = ctypes.c_char_p
            _library = lib
    return _library


def _raise(lib, what, code):
    raise RuntimeError(f"{what} failed: CUDA error {code} "
                       f"({lib.kmb_error_string(code).decode()})")


def plan(d, nc, kernel, flash, den, bf16) -> tuple[int, int]:
    """(target rows per block, blocks one SM holds) of an instantiation."""
    lib = load_library()
    rows, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    code = lib.kmb_plan(d, nc, kernel, int(flash), int(den), int(bf16),
                        ctypes.byref(rows), ctypes.byref(per_sm))
    if code != 0:
        _raise(lib, "kmb_plan", code)
    return rows.value, per_sm.value


class CudaKernel:
    """One C entry point of the kernel library, with launch counters:
    `launches` counts every launch, `wide_launches` those of the wide
    mode (a signal of more than 8 columns on the tensor cores), and
    `wide_eblocks` the E blocks of those launches (blocks of signal
    columns on the grid's z dimension, each computing the kernel values
    once).  `staged_bytes` sums the bytes the large-D wide kernel's TMA
    loads moved, and `last_staging` is the last launch's (stages of its
    ring, x resident, bytes), as the library reports them (zeros for the
    other kernels)."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0
        self.wide_launches = 0
        self.wide_eblocks = 0
        self.staged_bytes = 0
        self.last_staging = (0, 0, 0)

    def __call__(self, *args, eblocks: int = 0) -> None:
        """Launch; `eblocks` > 0 marks a launch of the wide mode with that
        many E blocks."""
        lib = load_library()
        code = getattr(lib, self.symbol)(*args)
        if code != 0:
            _raise(lib, f"{self.symbol} launch", code)
        stages, resident = ctypes.c_int(0), ctypes.c_int(0)
        staged = ctypes.c_longlong(0)
        lib.kmb_last_staging(ctypes.byref(stages), ctypes.byref(resident),
                             ctypes.byref(staged))
        self.launches += 1
        self.wide_launches += int(eblocks > 0)
        self.wide_eblocks += eblocks
        self.staged_bytes += staged.value
        self.last_staging = (stages.value, resident.value, staged.value)


DIRECT = CudaKernel("kmb_direct_matvec")
FLASH = CudaKernel("kmb_flash_matvec")
KERNELS = (DIRECT, FLASH)


@contextlib.contextmanager
def launch_timer():
    """Time every kernel launch inside the block on the card.  The library
    records CUDA events on the launch's stream just before and just after
    each `cudaLaunchKernel` (so the host's work before a launch, such as
    encoding tensor maps, is not counted), and needs no profiler.  Yields
    a list that, when the block ends, holds each launch's device time in
    ms, in order; leaving the block waits for the timed launches."""
    lib = load_library()
    code = lib.kmb_timer_begin()
    if code != 0:
        _raise(lib, "kmb_timer_begin", code)
    times = []
    ms = (ctypes.c_float * _TIMER_CAP)()
    count = ctypes.c_int(0)
    try:
        yield times
    finally:   # the timer stops also when the block raises
        code = lib.kmb_timer_end(ms, _TIMER_CAP, ctypes.byref(count))
    if code != 0:
        _raise(lib, "kmb_timer_end", code)
    if count.value > _TIMER_CAP:
        raise RuntimeError(f"launch_timer: {count.value} launches, more "
                           f"than the {_TIMER_CAP} it can time")
    times.extend(ms[:count.value])


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
        kernel.wide_launches = 0
        kernel.wide_eblocks = 0
        kernel.staged_bytes = 0
        kernel.last_staging = (0, 0, 0)
