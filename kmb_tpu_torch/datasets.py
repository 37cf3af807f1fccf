"""Dataset layer: the registry, seeded generators and float64 ground truth.

The port's copy of kmb_tpu/datasets.py, with the same names, seeds and
arrays, split in two:

- `make_arrays(name)` generates a dataset's arrays with numpy alone.  For
  the same name they are byte-identical to what kmb_tpu writes.
- `ground_truth(arrays, device)` computes the float64 target signal with
  the plain PyTorch product (`kernel_matvec_torch` in float64) on the given
  device, in blocks of target rows against chunks of source columns whose
  deferred states are merged, so no float64 temporary holds more than
  `TRUTH_BLOCK_ENTRIES` entries: the 2^20-point datasets' 1.1e12 pairs
  fit the card's memory.  On the CPU it uses the numpy oracle below 10^7
  pairs and the native oracle above when that is built, as kmb_tpu does.
- `get_dataset(name, device)` reads, or first writes, the HDF5 file of the
  reference spec (source/target points and signals, attrs task, kernel,
  point_type, normalize_rows, same_points, density_estimation), through
  h5py where it is installed and `kmb_tpu_torch.hdf5`'s own writer and
  reader where it is not: the in-memory path needs neither.
"""

from __future__ import annotations

import logging
import math
import os
import time

import numpy as np

from kmb_tpu_torch import hdf5, native, resolve_device
from kmb_tpu_torch.algorithms.bruteforce_numpy import blocked_kernel_product

logger = logging.getLogger("kmb")

NUMPY_TRUTH_MAX_PAIRS = 10**7
# Logged when a dataset's truth is computed: name, device, seconds and the
# peak of the device memory allocated meanwhile (0 on the CPU).
TRUTH_LOG = "float64 truth of %s on %s: %.3f s, peak %d bytes allocated"
# The float64 truth's blocks: at most this many entries in each (rows x
# columns) temporary of the plain product (2^26: 512 MiB), with row blocks
# of at least TRUTH_ROWS target rows where the cap allows.
TRUTH_BLOCK_ENTRIES = 2**26
TRUTH_ROWS = 256


def get_dataset_fn(dataset):
    """Path of the local HDF5 file for a dataset name."""
    data_dir = os.environ.get("KMB_DATA_DIR", "data")
    os.makedirs(data_dir, exist_ok=True)
    return os.path.join(data_dir, f"{dataset}.hdf5")


def make_arrays(name):
    """The dataset's arrays and attributes, generated with numpy (no truth).

    Returns a dict with float64 `source_points` (M, D), `target_points`
    (N, D) (the source array itself when `same_points`), `source_signal`
    (M, E) (ones with density estimation), its `name`, and the attributes
    `task`, `kernel`, `point_type`, `normalize_rows`, `same_points`,
    `density_estimation`, `short_description`, `description`.
    """
    if name not in DATASETS:
        raise KeyError(f"Unknown dataset {name!r}.")
    return dict(DATASETS[name](), name=name)


def ground_truth(arrays, device="cuda", *, max_entries=None):
    """(N, E) float64 product-direction truth for `make_arrays` output.

    On the CPU below NUMPY_TRUTH_MAX_PAIRS pairs the numpy oracle computes
    it, above them the native oracle when its library is built.  Otherwise
    the plain product runs in float64 on `device` over blocks of target
    rows and chunks of source columns of at most `max_entries` entries
    (default TRUTH_BLOCK_ENTRIES), each chunk's deferred state at its
    global offsets (so the diagonal mask stays on the global diagonal) and
    the states folded as the sharded schedules fold theirs.
    """
    dev = resolve_device(device)
    y = arrays["source_points"]
    x = arrays["target_points"]
    b = arrays["source_signal"]
    kernel, normalize_rows = arrays["kernel"], bool(arrays["normalize_rows"])
    targets = None if arrays["same_points"] else x
    if dev.type == "cpu" and len(x) * len(y) <= NUMPY_TRUTH_MAX_PAIRS:
        return blocked_kernel_product(
            kernel=kernel, source_points=y, target_points=targets,
            source_signal=b, normalize_rows=normalize_rows)
    if dev.type == "cpu" and native.is_available():
        return native.native_kernel_product(
            kernel=kernel, source_points=y, target_points=targets,
            source_signal=b, normalize_rows=normalize_rows)
    return _chunked_truth(targets, y, b, kernel, normalize_rows, dev,
                          max_entries or TRUTH_BLOCK_ENTRIES)


def _chunked_truth(x, y, b, kernel, normalize_rows, dev, max_entries):
    """The float64 plain product of targets `x` (None: the sources) over
    (rows x cols) blocks of at most `max_entries` entries, as numpy."""
    import torch

    from kmb_tpu_torch.ops.product import kernel_matvec_torch
    from kmb_tpu_torch.parallel.sharded import finalize, fold, uses_flash

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(dev)

    ty, tb = to(y), to(b)
    tx = ty if x is None else to(x)
    n, m = len(tx), len(ty)
    cols = min(m, max(1, max_entries // TRUTH_ROWS))
    rows = min(n, max(1, max_entries // cols))
    flash = uses_flash(kernel, normalize_rows)
    out = torch.empty((n, tb.shape[1]), dtype=torch.float64, device=dev)
    for r0 in range(0, n, rows):
        xb = tx[r0:r0 + rows]
        state = None
        for c0 in range(0, m, cols):
            part = kernel_matvec_torch(
                xb, ty[c0:c0 + cols], tb[c0:c0 + cols], kernel_name=kernel,
                normalize_rows=normalize_rows, block_n=rows, deferred=True,
                row_offset=r0, col_offset=c0)
            state = fold(state, part, flash)
        out[r0:r0 + rows] = finalize(state, flash, normalize_rows, False)
    return out.cpu().numpy()


def write_output(filename, arrays, target_signal):
    """Write a dataset file in the reference HDF5 layout."""
    hdf5.write(filename, {key: arrays[key] for key in (
        "task", "kernel", "point_type", "normalize_rows",
        "short_description", "description", "same_points",
        "density_estimation")}, {
        "source_points": arrays["source_points"],
        "target_points": arrays["target_points"],
        "source_signal": arrays["source_signal"],
        "target_signal": target_signal})


def get_dataset(which, device="cuda"):
    """Return (open HDF5 file, point dimension D); generates if missing.

    A missing file is generated locally, its truth computed on `device`.
    The file is an h5py.File, or `hdf5.File` where h5py is missing.
    """
    fn = get_dataset_fn(which)
    if not os.path.exists(fn):
        arrays = make_arrays(which)
        write_output(fn, arrays, _timed_truth(which, arrays, device))
    f = hdf5.open_read(fn)
    dimension = int(f["source_points"].shape[-1])
    return f, dimension


def _timed_truth(which, arrays, device):
    """`ground_truth`, logged with its seconds and, on the card, the most
    memory it held allocated (TRUTH_LOG)."""
    import torch

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    start = time.perf_counter()
    truth = ground_truth(arrays, dev)
    seconds = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    logger.info(TRUTH_LOG, which, dev, seconds, peak)
    return truth


def _arrays(*, task, kernel, short_description, description, source_points,
            target_points=None, source_signal=None, point_type="float",
            normalize_rows=False):
    """Assemble the arrays exactly as kmb_tpu's write_output stores them."""
    source_points = np.asarray(source_points, dtype=np.float64)
    same_points = target_points is None
    density_estimation = source_signal is None
    return dict(
        task=task, kernel=kernel, point_type=point_type,
        normalize_rows=normalize_rows, short_description=short_description,
        description=description, same_points=same_points,
        density_estimation=density_estimation,
        source_points=source_points,
        target_points=(source_points if same_points
                       else np.asarray(target_points, dtype=np.float64)),
        source_signal=(np.ones((len(source_points), 1)) if density_estimation
                       else np.asarray(source_signal, dtype=np.float64)),
    )


# -- synthetic generators ----------------------------------------------------

def fibonacci_sphere(n_points, radius=1.0):
    """Evenly spread points on the 2-sphere via the golden-angle spiral."""
    i = np.arange(n_points, dtype=np.float64)
    y = 1.0 - 2.0 * i / (n_points - 1)         # from 1 to -1
    r_y = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    golden_angle = math.pi * (3.0 - math.sqrt(5.0))
    theta = golden_angle * i
    points = np.stack(
        [np.cos(theta) * r_y, y, np.sin(theta) * r_y], axis=1)
    return radius * points


def uniform_sphere(n_points=1000, dimension=3, radius=1.0,
                   kernel="inverse-distance", task="product",
                   normalize_rows=False, n_channels=1):
    """Generator: golden-angle sphere cloud (dimension must be 3)."""
    if dimension != 3:
        raise ValueError("The Fibonacci sphere generator is 3-dimensional.")

    def make():
        rng = np.random.default_rng(n_points + dimension)
        source_points = fibonacci_sphere(n_points, radius=radius)
        source_signal = rng.standard_normal((n_points, n_channels))
        return _arrays(
            task=task,
            kernel=kernel,
            short_description=f"sphere (N={n_points}, D={dimension})",
            description=(f"{task.capitalize()} on the sphere, {kernel} "
                         f"(N={n_points}, D={dimension})"),
            source_points=source_points,
            source_signal=source_signal,
            normalize_rows=normalize_rows,
        )

    return make


def uniform_cube(n_points=1000, dimension=3, radius=1.0, kernel="gaussian",
                 task="product", normalize_rows=False, n_channels=1,
                 density_estimation=False):
    """Generator: seeded uniform sample in [0, radius]^D."""

    def make():
        rng = np.random.default_rng(n_points + dimension)
        source_points = radius * rng.random((n_points, dimension))
        source_signal = (
            None if density_estimation
            else rng.standard_normal((n_points, n_channels)))
        return _arrays(
            task=task,
            kernel=kernel,
            short_description=f"cube (N={n_points}, D={dimension})",
            description=(f"{task.capitalize()} on the cube, {kernel} "
                         f"(N={n_points}, D={dimension})"),
            source_points=source_points,
            source_signal=source_signal,
            normalize_rows=normalize_rows,
        )

    return make


def normal_cloud(n_points=10000, dimension=784, radius=1.0, kernel="gaussian",
                 task="product", normalize_rows=False, n_channels=1,
                 separate_targets=False, n_targets=None):
    """Generator: isotropic Gaussian cloud, scaled by radius/sqrt(D).

    The 1/sqrt(D) scaling keeps pairwise squared distances and dot products
    O(1) in any dimension, so exponential-family kernels stay in a sane
    numerical range.
    """

    def make():
        rng = np.random.default_rng(n_points + dimension)
        scale = radius / math.sqrt(dimension)
        source_points = scale * rng.standard_normal((n_points, dimension))
        target_points = None
        if separate_targets:
            m = n_targets or n_points
            target_points = scale * rng.standard_normal((m, dimension))
        source_signal = rng.standard_normal((n_points, n_channels))
        return _arrays(
            task=task,
            kernel=kernel,
            short_description=f"normal (N={n_points}, D={dimension})",
            description=(f"{task.capitalize()} on a normal cloud, {kernel} "
                         f"(N={n_points}, D={dimension})"),
            source_points=source_points,
            target_points=target_points,
            source_signal=source_signal,
            normalize_rows=normalize_rows,
        )

    return make


# -- real-data loaders (local raw files) -------------------------------------

def _raw_path(filename):
    """Path of a raw input file under KMB_RAW_DIR (default: <data>/raw)."""
    raw_dir = os.environ.get(
        "KMB_RAW_DIR",
        os.path.join(os.environ.get("KMB_DATA_DIR", "data"), "raw"))
    path = os.path.join(raw_dir, filename)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Raw data file {filename!r} not found in {raw_dir!r}: "
            "download it elsewhere and place it there (or set KMB_RAW_DIR).")
    return path


def load_idx(path):
    """Vectorized IDX (MNIST-format) reader -> (N, prod(dims)) float64."""
    import gzip
    import struct

    opener = gzip.open if path.endswith(".gz") else open
    dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: ">i2", 0x0C: ">i4",
              0x0D: ">f4", 0x0E: ">f8"}
    with opener(path, "rb") as f:
        zero, type_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0 or type_code not in dtypes:
            raise ValueError(f"{path!r} is not an IDX file.")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=dtypes[type_code])
    return data.astype(np.float64).reshape(dims[0], -1)


def mnist(variant="mnist", kernel="gaussian", task="product",
          normalize_rows=False, n_points=None, n_targets=None):
    """Generator: MNIST / Fashion-MNIST pixels (D=784), train as sources,
    test as targets, scaled to [0, 1] and by 1/sqrt(D)."""
    files = {
        "mnist": ("train-images-idx3-ubyte.gz", "t10k-images-idx3-ubyte.gz"),
        "fashion-mnist": ("fashion-train-images-idx3-ubyte.gz",
                          "fashion-t10k-images-idx3-ubyte.gz"),
    }[variant]

    def make():
        src = load_idx(_raw_path(files[0]))[:n_points]
        tgt = load_idx(_raw_path(files[1]))[:n_targets]
        d = src.shape[1]
        scale = 1.0 / (255.0 * math.sqrt(d))
        rng = np.random.default_rng(d)
        return _arrays(
            task=task,
            kernel=kernel,
            short_description=f"{variant} (M={len(src)}, N={len(tgt)})",
            description=(f"{task.capitalize()} on {variant} pixels, "
                         f"{kernel} (M={len(src)}, N={len(tgt)}, D={d})"),
            source_points=src * scale,
            target_points=tgt * scale,
            source_signal=rng.standard_normal((len(src), 1)),
            normalize_rows=normalize_rows,
        )

    return make


def glove(dimension=25, kernel="exponential", task="attention",
          normalize_rows=True, n_points=None, n_targets=10000):
    """Generator: unit-normalised GloVe twitter embeddings, the last
    `n_targets` rows of a seeded shuffle as targets."""

    def make():
        path = _raw_path(f"glove.twitter.27B.{dimension}d.txt")
        rows = []
        with open(path, "rb") as f:
            for line in f:
                parts = line.rstrip().split()
                rows.append(np.asarray(parts[1:], dtype=np.float64))
                if n_points is not None and len(rows) >= n_points + n_targets:
                    break
        pts = np.stack(rows)
        pts /= np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-12)
        rng = np.random.default_rng(dimension)
        pts = pts[rng.permutation(len(pts))]
        src, tgt = pts[:-n_targets], pts[-n_targets:]
        rng2 = np.random.default_rng(dimension + 1)
        return _arrays(
            task=task,
            kernel=kernel,
            short_description=f"glove-{dimension} (M={len(src)})",
            description=(f"{task.capitalize()} on unit GloVe-{dimension} "
                         f"embeddings, {kernel} (M={len(src)}, "
                         f"N={len(tgt)})"),
            source_points=src,
            target_points=tgt,
            source_signal=rng2.standard_normal((len(src), 1)),
            normalize_rows=normalize_rows,
        )

    return make


# -- registry (the names and seeds of kmb_tpu/datasets.py:372-524) -----------

def _name(task, label, d, e, m, n, kernel):
    return f"{task}-{label}-D{d}-E{e}-M{m}-N{n}-{kernel}"


_SIZES = [1000, 2000, 5000, 10000]

PRODUCT_SPHERE = {
    _name("product", "sphere", 3, 1, n, n, "inverse-distance"):
        uniform_sphere(n_points=n, task="product", kernel="inverse-distance")
    for n in _SIZES
}
SOLVER_SPHERE = {
    _name("solver", "sphere", 3, 1, n, n, "inverse-distance"):
        uniform_sphere(n_points=n, task="solver", kernel="inverse-distance")
    for n in _SIZES
}
PRODUCT_CUBE = {
    _name("product", "cube", 3, 1, n, n, "gaussian"):
        uniform_cube(n_points=n, task="product", kernel="gaussian")
    for n in _SIZES
}
SOLVER_CUBE = {
    _name("solver", "cube", 3, 1, n, n, "gaussian"):
        uniform_cube(n_points=n, task="solver", kernel="gaussian")
    for n in _SIZES
}
ATTENTION = {
    _name("attention", "sphere", 3, 1, n, n, "exponential"):
        uniform_sphere(n_points=n, task="attention", kernel="exponential",
                       normalize_rows=True)
    for n in _SIZES
}
ATTENTION_HIGHD = {
    _name("attention", "normal", 64, 8, 10000, 10000, "exponential"):
        normal_cloud(n_points=10000, dimension=64, n_channels=8,
                     task="attention", kernel="exponential",
                     normalize_rows=True),
}
HIGH_D = {
    _name("product", "normal", 784, 1, 10000, 10000, "gaussian"):
        normal_cloud(n_points=10000, dimension=784, task="product",
                     kernel="gaussian"),
    _name("solver", "normal", 784, 1, 5000, 5000, "gaussian"):
        normal_cloud(n_points=5000, dimension=784, task="solver",
                     kernel="gaussian"),
    _name("product", "normal", 256, 16, 20000, 20000,
          "absolute-exponential"):
        normal_cloud(n_points=20000, dimension=256, n_channels=16,
                     task="product", kernel="absolute-exponential"),
}
KDE = {
    _name("product", "cube-kde", 3, 1, 10000, 10000, "gaussian"):
        uniform_cube(n_points=10000, task="product", kernel="gaussian",
                     density_estimation=True),
}
# Scale configs (the 2^20-point entries: up to 1.1e12 pairs of float64
# truth, computed on the card in blocks).
SCALE = {
    _name("product", "cube", 3, 1, n, n, "gaussian"):
        uniform_cube(n_points=n, task="product", kernel="gaussian")
    for n in [50000, 131072, 1048576]
}
SCALE.update({
    _name("solver", "cube", 3, 1, 50000, 50000, "gaussian"):
        uniform_cube(n_points=50000, task="solver", kernel="gaussian"),
    _name("solver", "cube", 3, 1, 131072, 131072, "gaussian"):
        uniform_cube(n_points=131072, task="solver", kernel="gaussian"),
    _name("solver", "sphere", 3, 1, 131072, 131072, "inverse-distance"):
        uniform_sphere(n_points=131072, task="solver",
                       kernel="inverse-distance"),
    _name("solver", "cube", 3, 1, 131072, 131072,
          "absolute-exponential"):
        uniform_cube(n_points=131072, task="solver",
                     kernel="absolute-exponential"),
    _name("product", "sphere", 3, 1, 131072, 131072, "inverse-distance"):
        uniform_sphere(n_points=131072, task="product",
                       kernel="inverse-distance"),
    _name("attention", "cube", 3, 1, 262144, 262144, "exponential"):
        uniform_cube(n_points=262144, task="attention",
                     kernel="exponential", normalize_rows=True),
    _name("attention", "normal", 25, 1, 1048576, 1048576, "exponential"):
        normal_cloud(n_points=1048576, dimension=25, task="attention",
                     kernel="exponential", normalize_rows=True),
    _name("attention", "normal", 25, 1, 1048576, 10000, "exponential"):
        normal_cloud(n_points=1048576, separate_targets=True,
                     n_targets=10000, dimension=25, task="attention",
                     kernel="exponential", normalize_rows=True),
})
REAL_DATA = {
    _name("product", "mnist", 784, 1, 60000, 10000, "gaussian"):
        mnist("mnist", kernel="gaussian", task="product"),
    _name("product", "fashion-mnist", 784, 1, 60000, 10000, "gaussian"):
        mnist("fashion-mnist", kernel="gaussian", task="product"),
    _name("attention", "glove25", 25, 1, 1183514, 10000, "exponential"):
        glove(dimension=25),
    _name("attention", "glove100", 100, 1, 1183514, 10000, "exponential"):
        glove(dimension=100),
}

DATASETS = {
    **PRODUCT_SPHERE,
    **SOLVER_SPHERE,
    **PRODUCT_CUBE,
    **SOLVER_CUBE,
    **ATTENTION,
    **ATTENTION_HIGHD,
    **HIGH_D,
    **KDE,
    **SCALE,
    **REAL_DATA,
}
