"""Registry of performance metrics for plot axes.

The port's copy of kmb_tpu/plotting/metrics.py, reading the port's result
store; h5py is imported only where sibling result files are scanned.  The
metric names are kmb_tpu's, so both packages' rows share the plots: on the
card a "chip" (`tflops-per-chip`, `pairs-per-second-per-chip`,
`scaling-efficiency`) is one card, and `n_chips` is the number of ranks a
sharded row ran on (one process per card).

Rebuild of reference plotting/metrics.py:1-128.  Each entry of
`all_metrics` is a dict:

- ``description``: axis label,
- ``worst``: the worst possible value; its *sign* encodes the optimization
  direction (``+inf`` = smaller is better, ``-inf`` = bigger is better —
  the Pareto sweep in utils.create_pointset keys off this, reference
  utils.py:38-39),
- ``function(dataset, result_file, properties, metrics_cache)``: computes
  the scalar for one stored run.  `dataset` is the open dataset HDF5 file,
  `result_file` the open result HDF5 file (tables ``result``/``error``),
  `properties` its attrs as a dict, and `metrics_cache` an HDF5 group (or
  any mapping) inside the result file used to memoize expensive statistics.

Error statistics follow the reference exactly (metrics.py:36-61): per
target point, the L2 norm of its (E,)-row of the error table, then
max/mean/median/RMSE over points, cached under ``errors`` in the metrics
group.

New TPU-first metrics beyond the reference set (SURVEY.md §5): throughput
in kernel evaluations per second (``pairs-per-second``) and achieved
``tflops-per-chip`` derived from the 2·N·M·(D+E) FLOP count of the dense
product — both with ``worst=-inf``, exercising the "bigger is better"
branch of the Pareto logic.
"""

from __future__ import annotations

import numpy as np


def get_error_statistics(result_file, metrics_cache):
    """Max/mean/median/RMSE of per-point L2 error norms, memoized."""
    if "errors" not in metrics_cache:
        error = np.asarray(result_file["error"], dtype=np.float64)
        norms = np.sqrt((error**2).sum(axis=-1))
        grp = metrics_cache.create_group("errors")
        grp.attrs["max"] = float(np.max(norms))
        grp.attrs["mean"] = float(np.mean(norms))
        grp.attrs["median"] = float(np.median(norms))
        grp.attrs["rmse"] = float(np.sqrt(np.mean(norms**2)))
    return metrics_cache["errors"].attrs


def _error_stat(stat):
    def fn(dataset, result_file, properties, metrics_cache):
        return float(get_error_statistics(result_file, metrics_cache)[stat])
    return fn


def _attr(name):
    def fn(dataset, result_file, properties, metrics_cache):
        return float(properties[name])
    return fn


def total_time(dataset, result_file, properties, metrics_cache):
    return float(properties["build_time"]) + float(properties["query_time"])


def _problem_size(dataset):
    """(N, M, D, E) of the benchmark problem, from the dataset file."""
    m, d = dataset["source_points"].shape
    n, e = dataset["target_signal"].shape
    return n, m, d, e


def pairs_per_second(dataset, result_file, properties, metrics_cache):
    """Kernel pair evaluations per second of query time (N·M / t_query)."""
    n, m, _, _ = _problem_size(dataset)
    return n * m / max(float(properties["query_time"]), 1e-12)


def tflops_per_chip(dataset, result_file, properties, metrics_cache):
    """Achieved TFLOP/s per chip in the query phase.

    Dense kernel product cost model: the (N,M) squared-distance/GEMM block
    costs 2·N·M·D FLOPs and the K@b contraction 2·N·M·E, i.e.
    2·N·M·(D+E) total (SURVEY.md §5 tracing row).  `n_chips` comes from
    the algorithm's get_additional() when it ran sharded; default 1.
    """
    n, m, d, e = _problem_size(dataset)
    chips = float(properties.get("n_chips", 1))
    flops = 2.0 * n * m * (d + e)
    return flops / max(float(properties["query_time"]), 1e-12) / chips / 1e12


_scaling_baseline_cache = {}


def _min_chip_rate(dataset, properties):
    """Best per-chip pairs/s among sibling runs at the smallest chip count.

    Siblings are the stored results for the same (dataset, algorithm),
    scanned attrs-only from the results directory and cached per process.
    The current run's own attrs are always considered too, so the metric
    is well-defined even when this run is the only (or the first) one —
    its efficiency is then 1.0 by construction.
    """
    key = (properties["dataset"], properties["algo"])
    if key not in _scaling_baseline_cache:
        import glob
        import os

        import h5py

        from kmb_tpu_torch.results import get_result_filename

        n, m, _, _ = _problem_size(dataset)
        candidates = []
        root = os.path.join(
            get_result_filename(properties["dataset"]), properties["algo"])
        for path in glob.glob(os.path.join(root, "*.hdf5")):
            try:
                with h5py.File(path, "r") as f:
                    attrs = dict(f.attrs)
            except OSError:
                continue  # e.g. the run currently open r+; added below
            if "n_chips" in attrs and "query_time" in attrs:
                candidates.append((int(attrs["n_chips"]),
                                   float(attrs["query_time"])))
        if "n_chips" in properties:
            candidates.append((int(properties["n_chips"]),
                               float(properties["query_time"])))
        if not candidates:
            raise KeyError("n_chips")
        min_chips = min(c for c, _ in candidates)
        best_time = min(t for c, t in candidates if c == min_chips)
        _scaling_baseline_cache[key] = (
            n * m / max(best_time, 1e-12) / min_chips)
    return _scaling_baseline_cache[key]


def scaling_efficiency(dataset, result_file, properties, metrics_cache):
    """Throughput vs perfect linear scaling from the smallest-chip sibling.

        efficiency(p) = pairs_per_second(p) / (p * per_chip_rate(p_min))

    First-class version of the side tool scaling.py: computed from stored
    results, so the >=80%-linear target (BASELINE.md) is checkable from
    the result store and visible on the website.  Only defined for runs
    that report `n_chips` (the sharded TPU algorithms); raising KeyError
    makes compute_all_metrics skip it for everything else.
    """
    chips = float(properties["n_chips"])  # KeyError -> metric skipped
    rate = pairs_per_second(dataset, result_file, properties, metrics_cache)
    return rate / (chips * _min_chip_rate(dataset, properties))


all_metrics = {
    "max-error": {
        "description": "Max error",
        "function": _error_stat("max"),
        "worst": float("inf"),
    },
    "mean-error": {
        "description": "Mean error",
        "function": _error_stat("mean"),
        "worst": float("inf"),
    },
    "median-error": {
        "description": "Median error",
        "function": _error_stat("median"),
        "worst": float("inf"),
    },
    "rmse-error": {
        "description": "RMSE error",
        "function": _error_stat("rmse"),
        "worst": float("inf"),
    },
    "build-time": {
        "description": "Build time (s)",
        "function": _attr("build_time"),
        "worst": float("inf"),
    },
    "query-time": {
        "description": "Query time (s)",
        "function": _attr("query_time"),
        "worst": float("inf"),
    },
    "total-time": {
        "description": "Total time (s)",
        "function": total_time,
        "worst": float("inf"),
    },
    "memory-footprint": {
        "description": "Memory footprint (kB)",
        "function": _attr("memory_footprint"),
        "worst": float("inf"),
    },
    "pairs-per-second": {
        "description": "Kernel evaluations/s",
        "function": pairs_per_second,
        "worst": float("-inf"),
    },
    "pairs-per-second-per-chip": {
        "description": "Kernel evaluations/s per chip",
        "function": lambda dataset, result_file, properties, cache: (
            pairs_per_second(dataset, result_file, properties, cache)
            / float(properties.get("n_chips", 1))),
        "worst": float("-inf"),
    },
    "tflops-per-chip": {
        "description": "TFLOP/s per chip",
        "function": tflops_per_chip,
        "worst": float("-inf"),
    },
    "scaling-efficiency": {
        "description": "Scaling efficiency vs linear",
        "function": scaling_efficiency,
        "worst": float("-inf"),
    },
}
