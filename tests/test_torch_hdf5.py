"""The port's own HDF5 writer and reader (kmb_tpu_torch.hdf5).

Every dataset and result file is written by the module's own writer.  h5py
reads what it writes as it reads its own files: every attribute type of
the dataset and result files (str, bool, int, float, 1-D arrays) with the
type h5py gives its own, and every array.  The module's reader reads the
writer's files; h5py can add the plotting layer's metric group to one.
The CLI with h5py unimportable (the own reader on its read path) stores
the same dataset and result as with h5py's reader.
"""

import struct
import sys

import h5py
import numpy as np
import pytest

import kmb_tpu_torch.main as cli
from kmb_tpu_torch import hdf5
from kmb_tpu_torch.datasets import get_dataset_fn

ATTRS = {"kernel": "gaussian", "empty": "", "utf8": "é ü", "flag": True,
         "numpy_flag": np.bool_(False), "count": 3, "numpy_count": np.int64(7),
         "seconds": 1.5, "numpy_seconds": np.float64(2.5),
         "floats": np.array([1.0, 2.0]), "ints": np.array([1, 2, 3])}
ARRAYS = {"points": np.random.default_rng(0).random((1000, 3)),
          "column": np.arange(10.0).reshape(10, 1),
          "single": np.ones((3, 2), np.float32),
          "index": np.arange(5)}
DATASET = "product-sphere-D3-E1-M1000-N1000-inverse-distance"


def _h5py_file(path, attrs, arrays):
    with h5py.File(path, "w") as f:
        for key, value in attrs.items():
            f.attrs[key] = value
        for key, value in arrays.items():
            f[key] = value


def _same(got, want):
    assert type(got) is type(want), (got, want)
    assert np.array_equal(got, want)


def test_lookup3_is_hdf5s_checksum(tmp_path):
    path = tmp_path / "latest.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.attrs["kernel"] = "gaussian"
    raw = path.read_bytes()
    assert raw[8] >= 2   # a superblock with a checksum
    assert hdf5.lookup3(raw[:44]) == struct.unpack_from("<I", raw, 44)[0]


def test_h5py_reads_the_writers_file_as_its_own(tmp_path):
    ours, theirs = tmp_path / "ours.h5", tmp_path / "theirs.h5"
    hdf5.write(ours, ATTRS, ARRAYS)
    _h5py_file(theirs, ATTRS, ARRAYS)
    with h5py.File(ours, "r") as got, h5py.File(theirs, "r") as want:
        assert sorted(got.attrs) == sorted(want.attrs)
        for key in ATTRS:
            _same(got.attrs[key], want.attrs[key])
        assert sorted(got) == sorted(want)
        for key in ARRAYS:
            assert got[key].dtype == want[key].dtype
            _same(got[key][:], want[key][:])


def test_the_reader_reads_the_writers_file(tmp_path):
    path = tmp_path / "ours.h5"
    hdf5.write(path, ATTRS, ARRAYS)
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        assert sorted(got.attrs) == sorted(want.attrs)
        for key in ATTRS:
            _same(got.attrs[key], want.attrs[key])
        assert sorted(got.keys()) == sorted(ARRAYS)
        for key, value in ARRAYS.items():
            assert got[key].shape == value.shape
            _same(got[key][:], value)
            _same(got[key][2:4], value[2:4])


def test_h5py_adds_a_metrics_group_to_the_writers_file(tmp_path):
    path = tmp_path / "ours.h5"
    hdf5.write(path, ATTRS, ARRAYS)
    with h5py.File(path, "r+") as f:
        f.create_group("metrics").attrs["rel"] = 0.5
    with h5py.File(path, "r") as f:
        assert f["metrics"].attrs["rel"] == 0.5
        _same(f["points"][:], ARRAYS["points"])


@pytest.mark.parametrize("value", [None, {"a": 1}, np.ones((2, 2)),
                                   np.array(["a"])])
def test_the_writer_refuses_what_it_cannot_store(value, tmp_path):
    with pytest.raises(TypeError, match="cannot store"):
        hdf5.write(tmp_path / "x.h5", {"bad": value}, {})


def _cli_files(tmp_path, monkeypatch, name, without_h5py):
    monkeypatch.setenv("KMB_DATA_DIR", str(tmp_path / name / "data"))
    monkeypatch.setenv("KMB_RESULTS_DIR", str(tmp_path / name / "results"))
    with monkeypatch.context() as m:
        if without_h5py:
            m.setitem(sys.modules, "h5py", None)   # its import fails
        cli.main(["--local", "--hardware", "CPU", "--runs", "1",
                  "--algorithm", "torch-product-cpu", "--dataset", DATASET])
    (result,) = (tmp_path / name / "results" / DATASET
                 / "torch-product-cpu").iterdir()
    return get_dataset_fn(DATASET), result


def test_cli_without_h5py_stores_what_h5py_stores(tmp_path, monkeypatch):
    files = [_cli_files(tmp_path, monkeypatch, name, without)
             for name, without in (("own", True), ("h5py", False))]
    (own_data, own_result), (data, result) = files
    timed = {"build_time", "query_time", "memory_footprint"}
    for got_path, want_path in ((own_data, data), (own_result, result)):
        with h5py.File(got_path, "r") as got, \
                h5py.File(want_path, "r") as want:
            assert sorted(got.attrs) == sorted(want.attrs)
            for key in set(want.attrs) - timed:
                _same(got.attrs[key], want.attrs[key])
            assert sorted(got) == sorted(want)
            for key in ("source_points", "target_points", "source_signal",
                        "target_signal"):
                if key in want:
                    _same(got[key][:], want[key][:])
            for key in ("result", "error"):
                if key in want:
                    np.testing.assert_allclose(got[key][:], want[key][:],
                                               rtol=1e-6, atol=1e-7)
