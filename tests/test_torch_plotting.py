"""The port's plotting, report and website beside kmb_tpu's, on the same
stored rows.

The rows are stored once per module by the port's CLI (CPU tier: the
plain PyTorch product, the numpy oracle at six precisions and the native
oracle) on two small datasets.  Each test gives each package its own copy
of the result files, since the metrics cache statistics inside them, and
runs kmb_tpu's functions (and the repository's plot.py, report.py and
create_website.py) and the port's on them.  Floats must agree within
1e-12 relative; files and text exactly.
"""

import os
import shutil

import h5py
import pytest

import create_website
import plot as jax_plot
import report as jax_report
from kmb_tpu.datasets import get_dataset as jax_get_dataset
from kmb_tpu.plotting import metrics as jax_metrics
from kmb_tpu.plotting import utils as jax_utils
from kmb_tpu.plotting.plot_variants import (
    all_plot_variants as jax_plot_variants)
from kmb_tpu.results import load_all_results as jax_load_all_results

from kmb_tpu_torch import plot, report, website
from kmb_tpu_torch.datasets import get_dataset
from kmb_tpu_torch.plotting import metrics, utils
from kmb_tpu_torch.plotting.plot_variants import all_plot_variants
from kmb_tpu_torch.results import load_all_results

DATASETS = ("product-sphere-D3-E1-M1000-N1000-inverse-distance",
            "attention-sphere-D3-E1-M1000-N1000-exponential")
REL = 1e-12
PACKAGES = {
    "kmb_tpu": (jax_get_dataset, jax_load_all_results, jax_metrics,
                jax_utils),
    "kmb_tpu_torch": (lambda name: get_dataset(name, device="cpu"),
                      load_all_results, metrics, utils),
}


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """Result and data files written by `python -m kmb_tpu_torch --local
    --hardware CPU` on DATASETS."""
    from kmb_tpu_torch.main import main as cli_main

    root = tmp_path_factory.mktemp("stored")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KMB_DATA_DIR", str(root / "data"))
        mp.setenv("KMB_RESULTS_DIR", str(root / "results"))
        for dataset in DATASETS:
            cli_main(["--local", "--hardware", "CPU", "--dataset", dataset,
                      "--runs", "1"])
    return root


@pytest.fixture
def copies(stored, tmp_path, monkeypatch):
    """A fresh copy of the stored files per package; returns a function
    that points the environment at one package's copy."""
    for package in PACKAGES:
        shutil.copytree(stored, tmp_path / package)

    def use(package):
        monkeypatch.setenv("KMB_DATA_DIR", str(tmp_path / package / "data"))
        monkeypatch.setenv("KMB_RESULTS_DIR",
                           str(tmp_path / package / "results"))
    return use


def assert_close(a, b):
    if isinstance(a, float) or isinstance(b, float):
        assert a == b or abs(a - b) <= REL * max(abs(a), abs(b)), (a, b)
    else:
        assert a == b


def _all_metrics(package, use):
    get, load, _, util = PACKAGES[package]
    use(package)
    out = {}
    for dataset in DATASETS:
        f, _ = get(dataset)
        for props, result in load(dataset):
            algo, name, values = util.compute_all_metrics(f, result, props)
            out[dataset, algo, name] = values
        f.close()
    return out


def test_the_stored_rows(stored):
    algos = set()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KMB_RESULTS_DIR", str(stored / "results"))
        for props, _ in load_all_results():
            algos.add(props["algo"])
    assert algos == {"torch-product-cpu", "bruteforce-product-blas",
                     "native-product"}


def test_metric_registry_matches():
    assert list(metrics.all_metrics) == list(jax_metrics.all_metrics)
    for name, metric in metrics.all_metrics.items():
        theirs = jax_metrics.all_metrics[name]
        assert metric["description"] == theirs["description"]
        assert metric["worst"] == theirs["worst"]
    assert all_plot_variants == jax_plot_variants


def test_all_metrics_equal(copies):
    ours = _all_metrics("kmb_tpu_torch", copies)
    theirs = _all_metrics("kmb_tpu", copies)
    assert sorted(ours) == sorted(theirs)
    assert len(ours) == 2 * 8
    for key, values in ours.items():
        assert sorted(values) == sorted(theirs[key]), key
        assert "scaling-efficiency" not in values   # no n_chips
        for metric, value in values.items():
            assert_close(value, theirs[key][metric])


@pytest.mark.parametrize("variant", [v for v in all_plot_variants
                                     if not v.startswith("scaling")])
def test_pareto_fronts_equal(variant, copies):
    xn, yn = all_plot_variants[variant]
    fronts = {}
    for package, (get, load, _, util) in PACKAGES.items():
        copies(package)
        f, _ = get(DATASETS[0])
        runs = util.compute_metrics(f, load(DATASETS[0]), xn, yn)
        f.close()
        fronts[package] = {
            algo: util.create_pointset(sorted(points), xn, yn)
            for algo, points in runs.items()}
    assert sorted(fronts["kmb_tpu"]) == sorted(fronts["kmb_tpu_torch"])
    for algo, front in fronts["kmb_tpu_torch"].items():
        theirs = fronts["kmb_tpu"][algo]
        for ours_list, their_list in zip(front, theirs):
            assert len(ours_list) == len(their_list)
            for a, b in zip(ours_list, their_list):
                assert_close(a, b)


@pytest.mark.parametrize("n", [0, 1, 4, 13])
def test_colors_and_linestyles_equal(n):
    assert utils.generate_n_colors(n) == jax_utils.generate_n_colors(n)
    names = [f"algo-{i}" for i in range(n)]
    assert utils.create_linestyles(names) == jax_utils.create_linestyles(
        names)


def test_plot_labels_equal():
    for xn in metrics.all_metrics:
        for yn in metrics.all_metrics:
            assert utils.get_plot_label(
                metrics.all_metrics[xn], metrics.all_metrics[yn]
            ) == jax_utils.get_plot_label(jax_metrics.all_metrics[xn],
                                          jax_metrics.all_metrics[yn])


def test_chip_metrics_on_sharded_rows(tmp_path, monkeypatch):
    """scaling-efficiency and tflops-per-chip read `n_chips`: one
    ShardedProduct row (a world of one) stored by the port's runner, and
    siblings at 2 and 4 cards with other query times."""
    from kmb_tpu_torch.definitions import Definition
    from kmb_tpu_torch.runner import run

    dataset = DATASETS[0]
    monkeypatch.setenv("KMB_RESULTS_DIR", str(tmp_path / "results"))
    definition = Definition(
        algorithm="torch-sharded-product",
        module="kmb_tpu_torch.algorithms.torch_sharded",
        constructor="ShardedProduct",
        arguments={"kernel": "inverse-distance", "dimension": 3,
                   "precision": "float32", "schedule": "ring",
                   "device": "cpu"},
        query_argument_groups=[{}])
    run(definition=definition, dataset=dataset, runs=1, device="cpu")
    (path,) = [os.path.join(d, name) for d, _, names in
               os.walk(tmp_path / "results") for name in names]
    with h5py.File(path, "r") as f:
        assert f.attrs["n_chips"] == 1
        base_time = float(f.attrs["query_time"])
    for chips, share in ((2, 0.6), (4, 0.3)):
        sibling = path.replace(".hdf5", f"_{chips}.hdf5")
        shutil.copy(path, sibling)
        with h5py.File(sibling, "r+") as f:
            f.attrs["n_chips"] = chips
            f.attrs["query_time"] = base_time * share
    values = {}
    for package, (get, load, mod, util) in PACKAGES.items():
        mod._scaling_baseline_cache.clear()
        f, _ = get(dataset)
        values[package] = {}
        for props, result in load(dataset):
            _, _, found = util.compute_all_metrics(f, result, props)
            values[package][int(props["n_chips"])] = found
        f.close()
        mod._scaling_baseline_cache.clear()
    ours, theirs = values["kmb_tpu_torch"], values["kmb_tpu"]
    assert sorted(ours) == sorted(theirs) == [1, 2, 4]
    for chips in (1, 2, 4):
        assert sorted(ours[chips]) == sorted(theirs[chips])
        for metric, value in ours[chips].items():
            assert_close(value, theirs[chips][metric])
    assert ours[1]["scaling-efficiency"] == 1.0
    assert ours[2]["scaling-efficiency"] == pytest.approx(1 / 1.2)
    assert ours[4]["tflops-per-chip"] == pytest.approx(
        ours[1]["tflops-per-chip"] / (4 * 0.3))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, name), root)
                  for d, _, names in os.walk(root) for name in names)


def test_plot_writes_the_same_file(copies, tmp_path):
    for package, main in (("kmb_tpu", jax_plot.main),
                          ("kmb_tpu_torch", plot.main)):
        copies(package)
        out = tmp_path / f"plot-{package}"
        out.mkdir()
        main(["--dataset", DATASETS[0], "--output",
              str(out / "plot.png"), "--raw", "-x", "query-time", "-y",
              "max-error"] + (["--hardware", "CPU"]
                              if package == "kmb_tpu_torch" else []))
        assert os.path.getsize(out / "plot.png") > 0
    assert _files(tmp_path / "plot-kmb_tpu") == _files(
        tmp_path / "plot-kmb_tpu_torch")


def test_report_rows_and_text_equal(copies, capsys):
    rows = {}
    for package, module in (("kmb_tpu", jax_report),
                            ("kmb_tpu_torch", report)):
        copies(package)
        rows[package] = module.collect("*")
        texts = []
        for fmt in ("markdown", "tsv"):
            module.emit(rows[package], fmt)
            texts.append(capsys.readouterr().out)
        rows[package + "/text"] = texts
    assert len(rows["kmb_tpu_torch"]) == 16
    # Equal query times order both the same way.
    assert rows["kmb_tpu_torch/text"] == rows["kmb_tpu/text"]
    for ours, theirs in zip(rows["kmb_tpu_torch"], rows["kmb_tpu"]):
        assert sorted(ours) == sorted(theirs)
        for key in ours:
            assert_close(ours[key], theirs[key])


@pytest.mark.parametrize("flags", [["--latex"], ["--scatter"]])
def test_website_writes_the_same_site(flags, copies, tmp_path):
    for package, main in (("kmb_tpu", create_website.main),
                          ("kmb_tpu_torch", website.main)):
        copies(package)
        main(["--outputdir", str(tmp_path / f"site-{package}"), *flags])
    ours, theirs = (tmp_path / "site-kmb_tpu_torch", tmp_path / "site-kmb_tpu")
    assert _files(ours) == _files(theirs)
    assert "index.html" in _files(ours)
    for name in _files(ours):
        if name.endswith(".html"):
            assert (ours / name).read_text() == (theirs / name).read_text(), (
                name)
    index = (ours / "index.html").read_text()
    assert DATASETS[0] in index and "native-product" in index
