"""The port's harness around the engines, side by side with kmb_tpu's.

Subprocess isolation (`runner.run_subprocess`, the CLI without `--local`)
and the fixtures of `algorithms/dummy.py`, on the same dataset
(product-cube-D3-E1-M1000-N1000-gaussian, generated under the test's
temporary directory) in both packages, the JAX side on the CPU
(KMB_PLATFORM=cpu in its children):

- a child that outlives its timeout gives the same reason string;
- a child that raises makes `main` exit 1 with the same `.failed` marker,
  at the file name each package's `get_result_filename` gives;
- a successful child stores the row an in-process `--local` run stores:
  the same file name and attribute keys, `result` equal at 1e-6 relative
  to its largest entry (the child's torch thread count, and with it the
  float32 summation order, may differ from the parent's);
- the GPU tier without a card, and a multi-process group without
  `--local`, exit before any child starts and write nothing.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

import kmb_tpu.main as jax_main
import kmb_tpu.runner as jax_runner
from kmb_tpu.definitions import Definition as JaxDefinition
from kmb_tpu.results import get_result_filename as jax_result_filename

import kmb_tpu_torch.main as cli
import kmb_tpu_torch.runner as runner
from kmb_tpu_torch.definitions import Definition, get_definitions
from kmb_tpu_torch.results import get_result_filename, load_all_results

from torch_sharded_worker import spawn_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ALGOS = os.path.join(REPO, "algos.yaml")
DATASET = "product-cube-D3-E1-M1000-N1000-gaussian"
NO_DEVICE = "no CUDA device is available"
RESULT_RTOL = 1e-6
PACKAGES = ("kmb_tpu", "kmb_tpu_torch")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def _fixture(package, constructor, algorithm, **arguments):
    """A Definition of one of the package's dummy fixtures."""
    cls = JaxDefinition if package == "kmb_tpu" else Definition
    return cls(algorithm=algorithm,
               module=f"{package}.algorithms.dummy",
               constructor=constructor,
               arguments={"kernel": "gaussian", "dimension": 3,
                          "normalize_rows": False, **arguments},
               query_argument_groups=[{}])


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, name), root)
                  for d, _, names in os.walk(root) for name in names)


@pytest.mark.parametrize("package", PACKAGES)
def test_subprocess_timeout_returns_reason(package, monkeypatch):
    monkeypatch.setenv("KMB_PLATFORM", "cpu")
    definition = _fixture(package, "SleepyProduct", "dummy-sleepy",
                          seconds=120)
    if package == "kmb_tpu":
        reason = jax_runner.run_subprocess(
            definition=definition, dataset=DATASET, runs=1, timeout=5)
    else:
        reason = runner.run_subprocess(
            definition=definition, dataset=DATASET, runs=1, hardware="CPU",
            timeout=5)
    assert reason == "timeout after 5s"


@pytest.mark.parametrize("package", PACKAGES)
def test_main_counts_child_failures(package, monkeypatch):
    monkeypatch.setenv("KMB_PLATFORM", "cpu")
    argv = ["--dataset", DATASET, "--algorithm", "dummy-crashy",
            "--run-disabled", "--runs", "1", "--timeout", "120"]
    with pytest.raises(SystemExit) as exc:
        if package == "kmb_tpu":
            jax_main.main(argv + ["--definitions", JAX_ALGOS])
        else:
            cli.main(argv + ["--hardware", "CPU"])
    assert exc.value.code == 1
    definition = _fixture(package, "CrashyProduct", "dummy-crashy")
    name = (jax_result_filename if package == "kmb_tpu"
            else get_result_filename)(DATASET, definition, {})
    # Both packages put the marker at the same path.
    assert name == jax_result_filename(
        DATASET, _fixture("kmb_tpu", "CrashyProduct", "dummy-crashy"), {})
    with open(name + ".failed") as f:
        reason = f.read()
    assert "exit code" in reason
    assert reason == "child exit code 1\n"
    assert not os.path.exists(name)


def test_successful_child_stores_the_local_row(tmp_path, monkeypatch):
    argv = ["--hardware", "CPU", "--dataset", DATASET, "--algorithm",
            "torch-product-cpu", "--runs", "2"]
    stored = {}
    for mode, extra in (("child", []), ("local", ["--local"])):
        root = str(tmp_path / mode)
        monkeypatch.setenv("KMB_RESULTS_DIR", root)
        cli.main(argv + extra)
        stored[mode] = root
    files = {mode: _files(root) for mode, root in stored.items()}
    assert files["child"] == files["local"]
    assert len(files["child"]) == 1 and files["child"][0].endswith(".hdf5")
    rows = {}
    for mode, root in stored.items():
        with h5py.File(os.path.join(root, files[mode][0]), "r") as f:
            rows[mode] = (dict(f.attrs), f["result"][:], f["error"][:])
    (child, child_result, _), (local, local_result, _) = (
        rows["child"], rows["local"])
    assert sorted(child) == sorted(local)
    assert child["algo"] == "torch-product-cpu" and child["run_count"] == 2
    assert child["backend"] == "cpu"
    scale = np.abs(local_result).max()
    np.testing.assert_allclose(child_result, local_result, rtol=0,
                               atol=RESULT_RTOL * scale)


def test_child_entry_point_runs_a_definition(tmp_path):
    # `python -m kmb_tpu_torch.run_algorithm` as run_subprocess starts it.
    env = dict(os.environ, PYTHONPATH=REPO,
               KMB_DATA_DIR=str(tmp_path / "data"))
    proc = subprocess.run(
        [sys.executable, "-m", "kmb_tpu_torch.run_algorithm", "--dataset",
         DATASET, "--algorithm", "dummy-product", "--module",
         "kmb_tpu_torch.algorithms.dummy", "--constructor", "DummyProduct",
         "--runs", "1", "--hardware", "CPU",
         '{"kernel": "gaussian", "dimension": 3}'],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "Stored result: " in proc.stdout   # logged to stdout, relayed
    (props, _), = list(load_all_results(DATASET))
    assert props["algo"] == "dummy-product" and props["run_count"] == 1


def test_gpu_tier_without_a_card_starts_no_child(tmp_path):
    _no_card()
    env = dict(os.environ, PYTHONPATH=REPO,
               KMB_DATA_DIR=str(tmp_path / "data"))
    proc = subprocess.run(
        [sys.executable, "-m", "kmb_tpu_torch", "--dataset", DATASET],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert NO_DEVICE in proc.stderr
    assert "Launching child" not in proc.stdout + proc.stderr
    assert os.listdir(tmp_path) == []   # no data/, no results/


def test_gpu_tier_child_without_a_card_writes_nothing(tmp_path):
    # The child refuses too, before it generates the dataset.
    _no_card()
    definition = Definition(
        algorithm="torch-product", module="kmb_tpu_torch.algorithms."
        "torch_engine", constructor="TorchProduct",
        arguments={"kernel": "gaussian", "dimension": 3,
                   "normalize_rows": False, "precision": "float32"},
        query_argument_groups=[{}])
    reason = runner.run_subprocess(definition=definition, dataset=DATASET,
                                   runs=1, hardware="GPU", timeout=120)
    assert reason == "child exit code 1"
    assert os.listdir(tmp_path) == []


def test_timeout_option():
    assert cli.make_parser().parse_args([]).timeout == 1200
    assert jax_main.make_parser().parse_args([]).timeout == 1200
    assert not cli.make_parser().parse_args([]).local


def test_two_ranks_refuse_subprocess_mode(tmp_path):
    from kmb_tpu_torch.datasets import get_dataset

    dirs = dict(KMB_DATA_DIR=str(tmp_path / "data"),
                KMB_RESULTS_DIR=str(tmp_path / "results"))
    with pytest.MonkeyPatch.context() as mp:
        for name, value in dirs.items():
            mp.setenv(name, value)
        get_dataset(DATASET, device="cpu")[0].close()
    outputs = spawn_ranks("subprocess-cli", 2, {"dataset": np.array(DATASET)},
                          str(tmp_path), env=dirs, timeout=120)
    for out in outputs:
        assert "2 ranks" in str(out["exit"])
        assert "needs --local" in str(out["exit"])
    assert not os.path.exists(dirs["KMB_RESULTS_DIR"])


def test_fixture_entries_mirror_the_repository():
    import yaml

    with open(JAX_ALGOS) as f:
        jax_entries = yaml.safe_load(f)
    with open(os.path.join(REPO, "kmb_tpu_torch", "algos.yaml")) as f:
        entries = yaml.safe_load(f)
    for name in ("dummy-product", "dummy-sleepy", "dummy-crashy",
                 "dummy-solver", "bruteforce-product-blas",
                 "bruteforce-solver-blas", "native-product"):
        theirs = dict(jax_entries[name])
        theirs["module"] = theirs["module"].replace("kmb_tpu.",
                                                    "kmb_tpu_torch.")
        assert entries[name] == theirs, name
    disabled = get_definitions(dataset=DATASET, task="product",
                               hardware="CPU", run_disabled=True)
    assert {"dummy-product", "dummy-sleepy",
            "dummy-crashy"} <= {d.algorithm for d in disabled}


@pytest.mark.parametrize("package", PACKAGES)
def test_build_loop_keeps_one_fitted_state(package, tmp_path, monkeypatch):
    """The best-of-N build loop never holds two fitted states at once, and
    the runner's finally-block releases the winner too."""
    import importlib

    dummy = importlib.import_module(f"{package}.algorithms.dummy")
    run = jax_runner.run if package == "kmb_tpu" else runner.run
    monkeypatch.setenv("KMB_RESULTS_DIR", str(tmp_path / "results"))
    dummy.TrackingProduct.reset_counters()
    definition = _fixture(package, "TrackingProduct", "tracking-product")
    kwargs = {} if package == "kmb_tpu" else {"device": "cpu"}
    run(definition=definition,
        dataset="product-sphere-D3-E1-M1000-N1000-inverse-distance", runs=3,
        **kwargs)
    assert dummy.TrackingProduct.max_live_fitted == 1
    assert dummy.TrackingProduct.live_fitted == 0


@pytest.mark.parametrize("constructor,task", [("DummyProduct", "product"),
                                              ("DummySolver", "solver")])
def test_dummy_fixtures_shapes(constructor, task, tmp_path, monkeypatch):
    # The same stored shapes as kmb_tpu's fixtures (random values).
    dataset = {"product": DATASET,
               "solver": "solver-cube-D3-E1-M1000-N1000-gaussian"}[task]
    shapes = {}
    for package in PACKAGES:
        monkeypatch.setenv("KMB_RESULTS_DIR", str(tmp_path / package))
        run = jax_runner.run if package == "kmb_tpu" else runner.run
        kwargs = {} if package == "kmb_tpu" else {"device": "cpu"}
        run(definition=_fixture(package, constructor, f"dummy-{task}"),
            dataset=dataset, runs=1, **kwargs)
        rows = [(props["algo"], props["run_count"], f["result"].shape)
                for props, f in load_all_results(dataset)]
        assert len(rows) == 1
        shapes[package] = rows[0]
    assert shapes["kmb_tpu"] == shapes["kmb_tpu_torch"]
    assert shapes["kmb_tpu_torch"][2] == (1000, 1)


def test_host_memory_reading_matches_psutil():
    # The host algorithms read /proc/self/statm, as psutil's rss does on
    # Linux (the card's machine has no psutil); within 1% (or 4 MiB) of
    # the process's RSS read just after.
    import psutil

    from kmb_tpu_torch.algorithms.dummy import DummyProduct

    ours = DummyProduct(kernel="gaussian", dimension=3).get_memory_usage()
    theirs = psutil.Process().memory_info().rss / 1024
    assert abs(ours - theirs) <= max(0.01 * theirs, 4096)
