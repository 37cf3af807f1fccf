"""The port's install, smoke and sweep twins (kmb_tpu_torch.install,
.smoke, .run_all) on the CPU.

`install --hardware CPU` builds the native oracle and lists every algos.yaml
entry as importable; the default GPU tier exits without a card before it
builds or writes anything.  `smoke --hardware CPU` (its test step skipped:
it would run this suite inside itself) runs install, a benchmark run of
five definitions drawn at random, the plot and the website in its work
directory.  `run_all` is exercised
through its dataset filter, run_all.sh's.
"""

import os
import subprocess
import sys

import pytest
import torch

from kmb_tpu.datasets import DATASETS as JAX_DATASETS

from kmb_tpu_torch import run_all
from kmb_tpu_torch.definitions import DEFAULT_DEFINITIONS, _load_yaml
from kmb_tpu_torch.smoke import DATASET, EXCLUDED

# The CPU tier's algorithms for the smoke's dataset, disabled ones included.
CPU_PRODUCTS = {"bruteforce-product-blas", "dummy-crashy", "dummy-product",
                "dummy-sleepy", "native-product", "torch-product-cpu"}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(*argv, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_install_on_the_cpu_lists_every_entry(tmp_path):
    proc = _module("kmb_tpu_torch.install", "--hardware", "CPU",
                   cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    for name in _load_yaml(DEFAULT_DEFINITIONS):
        assert f"  {name} " in out and "AVAILABLE" in out.split(
            f"  {name} ")[1].splitlines()[0], name
    assert "native oracle: libkmb_native_" in out
    assert "kernel library" not in out
    assert out.rstrip().endswith("install: OK")


def test_install_default_tier_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _module("kmb_tpu_torch.install", cwd=tmp_path)
    assert proc.returncode != 0
    assert "--hardware GPU: no CUDA device is available" in proc.stderr
    assert proc.stdout == "" and os.listdir(tmp_path) == []


def test_smoke_on_the_cpu_builds_the_plot_and_the_website(tmp_path):
    work = tmp_path / "work"
    proc = _module("kmb_tpu_torch.smoke", "--hardware", "CPU", "--workdir",
                   str(work), "--skip", "tests", cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "tests: skipped (--skip)" in proc.stdout
    assert "== smoke OK" in proc.stdout
    assert (work / "results" / f"{DATASET}.png").stat().st_size > 0
    assert (work / "website" / "index.html").stat().st_size > 0
    assert (work / "data" / f"{DATASET}.hdf5").exists()
    # Five definitions drawn at random, as smoke.sh draws them: each one
    # drawn stored a result, and the fixtures left out were not drawn.
    results = work / "results" / DATASET
    algorithms = set(os.listdir(results))
    assert algorithms and algorithms <= CPU_PRODUCTS - set(EXCLUDED)
    for name in algorithms:
        assert any(f.suffix == ".hdf5" for f in (results / name).iterdir())
    assert sorted(os.listdir(tmp_path)) == ["work"]


def test_run_all_sweeps_what_run_all_sh_sweeps():
    # run_all.sh:8-15, on the JAX package's registry.
    want = [name for name in JAX_DATASETS
            if not ("M131072" in name or "M50000" in name
                    or "M60000" in name)]
    assert run_all.sweep_datasets() == want
    assert "product-cube-D3-E1-M1048576-N1048576-gaussian" in want
