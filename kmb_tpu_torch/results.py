"""HDF5 result store.

A copy of kmb_tpu/results.py (the port imports nothing of kmb_tpu) in which
h5py is imported only where a file is written or read, and a result is
written by `kmb_tpu_torch.hdf5` (its own writer where h5py is missing).

Result files live at `results/{dataset}/{algorithm}/{flat_params}.hdf5`
(same path scheme as reference results.py:73-93, so sweeps resume at
experiment granularity by file existence).

Each file holds:
- tables `result` ((N,E) or (M,E) float64) and `error` (result - truth),
- attrs: dataset, algo, name, kernel, run_count, build_time, query_time,
  memory_footprint, plus anything from algo.get_additional(),
- a `metrics` group used as a cache by the plotting layer.
"""

from __future__ import annotations

import json
import os
import re
import traceback

import numpy as np

from kmb_tpu_torch import hdf5


class CustomJSONizer(json.JSONEncoder):
    """JSON encoder that accepts NumPy booleans and scalars."""

    def default(self, obj):
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        return super().default(obj)


def results_root() -> str:
    return os.environ.get("KMB_RESULTS_DIR", "results")


def get_result_filename(dataset=None, definition=None, query_arguments=None):
    """Path `results/{dataset}/{algorithm}/{flat sorted-JSON params}.hdf5`."""
    parts = [results_root()]
    if dataset:
        parts.append(dataset)
    if definition:
        parts.append(definition.algorithm)
        params = dict(definition.arguments, **(query_arguments or {}))
        flat = re.sub(
            r"\W+", "_",
            json.dumps(params, sort_keys=True, cls=CustomJSONizer),
        ).strip("_")
        parts.append(flat + ".hdf5")
    return os.path.join(*parts)


def store_result(*, dataset, definition, query_arguments, attrs, result,
                 error):
    """Write one experiment's output and metadata."""
    fn = get_result_filename(dataset, definition, query_arguments)
    os.makedirs(os.path.dirname(fn), exist_ok=True)
    hdf5.write(fn, attrs, {"result": result, "error": error})
    # A success supersedes any failure marker from an earlier attempt.
    try:
        os.remove(fn + ".failed")
    except OSError:
        pass
    return fn


def record_failure(*, dataset, definition, query_arguments, reason):
    """Write a `.failed` sidecar where the result file would have gone.

    The reference only logs a dead container in red and moves on
    (reference runner.py:319-338); the sidecar additionally makes a
    partially failed sweep inspectable post-hoc.  Resume-by-existence
    checks only for the `.hdf5`, so a retry re-runs the experiment and
    `store_result` removes the stale marker on success.
    """
    fn = get_result_filename(dataset, definition, query_arguments) + ".failed"
    os.makedirs(os.path.dirname(fn), exist_ok=True)
    with open(fn, "w") as f:
        f.write(str(reason) + "\n")
    return fn


def load_all_results(dataset=None):
    """Iterate (attrs_dict, open r+ h5py.File) over every stored result.

    The file is opened read-write so metric computations can cache their
    statistics inside it; it is closed after the consumer advances.
    """
    import h5py

    for root, _, files in os.walk(get_result_filename(dataset)):
        for fn in files:
            if os.path.splitext(fn)[-1] != ".hdf5":
                continue
            path = os.path.join(root, fn)
            try:
                f = h5py.File(path, "r+")
            except OSError:
                print(f"Was unable to read {path}")
                traceback.print_exc()
                continue
            try:
                yield dict(f.attrs), f
            finally:
                f.close()


def get_unique_algorithms(dataset=None):
    """Set of algorithm tags appearing in the stored results."""
    return {props["algo"] for props, _ in load_all_results(dataset)}
