"""ctypes bindings for the native C++ oracle (native/kmb_native.cpp).

The port's copy of kmb_tpu/native.py.  `native_kernel_product` is a
float64, OpenMP-threaded streaming kernel product with the exact semantics
of `bruteforce_numpy.blocked_kernel_product`.

Unlike kmb_tpu, which loads a library that `make -C native` left in
`native/`, the port builds its own at first use: `build()` compiles
native/kmb_native.cpp with native/Makefile's flags into the git-ignored
kmb_tpu_torch/_build/ (named by a hash of the source and the command) and
never writes into `native/`.  A failed build raises with the compiler's
message; nothing falls back to the NumPy oracle.  The compiler is `g++`
on PATH, as nvcc's host compiler is, not $CXX: an environment may point
CXX at a toolchain without OpenMP's runtime (one that cannot read
libgomp.spec), where `make -C native` fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

KERNEL_IDS = {
    "gaussian": 0,
    "absolute-exponential": 1,
    "inverse-distance": 2,
    "exponential": 3,
}

COMPILER = "g++"
SOURCE = Path(__file__).resolve().parent.parent / "native" / "kmb_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# native/Makefile's CXXFLAGS and libraries: -ffast-math lets gcc call
# libmvec's vector exp (the Makefile says why it is safe here).
CXXFLAGS = ["-O3", "-march=native", "-ffast-math", "-funroll-loops",
            "-fopenmp", "-fPIC", "-std=c++17", "-Wall"]
LIBS = ["-lmvec", "-lm"]

_lib = None
_lock = threading.Lock()


def compile_command(output) -> list[str]:
    """The compiler's command line that builds the library at `output`."""
    return [COMPILER, *CXXFLAGS, "-shared", "-o",
            str(output), str(SOURCE), *LIBS]


def library_path() -> Path:
    """Where the build of this source with this command lands."""
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update(" ".join(compile_command("")).encode())
    return BUILD_DIR / f"libkmb_native_{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless an identical build exists; its path.

    Raises RuntimeError with the compiler's output when the build fails.
    """
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build in a private directory and rename, so concurrent processes
    # never load a half-written library.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        library = Path(tmp) / target.name
        cmd = compile_command(library)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(
                f"native oracle build failed: {cmd[0]}: {exc}") from None
        if proc.returncode != 0:
            raise RuntimeError(
                f"native oracle build failed ({proc.returncode}): "
                f"{' '.join(cmd)}\n{(proc.stdout + proc.stderr)[-4000:]}")
        os.replace(library, target)
    return target


def _load():
    """Build (once per process) and load the library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            double_p = ctypes.POINTER(ctypes.c_double)
            lib.kmb_kernel_product.restype = ctypes.c_int
            lib.kmb_kernel_product.argtypes = [
                double_p, double_p, double_p, double_p, double_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int64,
            ]
            lib.kmb_num_threads.restype = ctypes.c_int
            lib.kmb_num_threads.argtypes = []
            _lib = lib
    return _lib


def is_available() -> bool:
    """Whether the library of this source is built (nothing is built)."""
    return library_path().exists()


def num_threads() -> int:
    """OpenMP threads the library runs on (builds it if needed)."""
    return _load().kmb_num_threads()


def native_kernel_product(*, kernel, source_points, target_points=None,
                          source_signal=None, normalize_rows=False,
                          row_offset=0, return_rowsums=False):
    """a = K(x, y) @ b in float64 via the native library (built if needed).

    Args mirror bruteforce_numpy.blocked_kernel_product; `row_offset`
    shifts the global row index for inverse-distance diagonal masking when
    called on a slab of target rows.
    """
    if kernel not in KERNEL_IDS:
        raise NotImplementedError(f"Unknown kernel {kernel!r}.")
    lib = _load()

    y = np.ascontiguousarray(source_points, dtype=np.float64)
    x = y if target_points is None else np.ascontiguousarray(
        target_points, dtype=np.float64)
    m, d = y.shape
    n = x.shape[0]
    if source_signal is None:
        b = np.ones((m, 1), dtype=np.float64)
    else:
        b = np.ascontiguousarray(source_signal, dtype=np.float64)
    e = b.shape[1]
    if x.shape[1] != d or b.shape[0] != m:
        raise ValueError(f"shapes x {x.shape}, y {y.shape}, b {b.shape} "
                         "do not fit together")

    out = np.empty((n, e), dtype=np.float64)
    rowsums = np.empty((n,), dtype=np.float64)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    status = lib.kmb_kernel_product(
        ptr(x), ptr(y), ptr(b), ptr(out), ptr(rowsums),
        n, m, d, e, KERNEL_IDS[kernel], int(bool(normalize_rows)),
        1, int(row_offset))
    if status != 0:
        raise RuntimeError(f"native kernel product failed ({status})")
    if return_rowsums:
        return out, rowsums
    return out
