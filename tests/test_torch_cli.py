"""The port's command line picks its device from --hardware alone.

`python -m kmb_tpu_torch` runs on the card unless it is told otherwise:
the default tier is GPU, and without a CUDA device it exits with the
`resolve_device` message before it writes a dataset or a result.  The CPU
runs only with `--hardware CPU`.
"""

import os
import subprocess
import sys

import pytest
import torch

import kmb_tpu_torch.main as cli
from kmb_tpu_torch.results import load_all_results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = "product-sphere-D3-E1-M1000-N1000-inverse-distance"
NO_DEVICE = "no CUDA device is available"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_default_tier_is_gpu():
    args = cli.make_parser().parse_args(["--local"])
    assert args.hardware == "GPU"
    assert cli.device_for(args.hardware) == "cuda"
    assert cli.device_for("CPU") == "cpu"
    assert not hasattr(cli, "detect_hardware")


def test_cli_without_a_card_exits_and_writes_nothing(tmp_path):
    _no_card()
    env = dict(os.environ, PYTHONPATH=REPO,
               KMB_DATA_DIR=str(tmp_path / "data"))
    proc = subprocess.run(
        [sys.executable, "-m", "kmb_tpu_torch", "--local", "--dataset",
         DATASET],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert NO_DEVICE in proc.stderr
    assert "--hardware GPU" in proc.stderr
    assert os.listdir(tmp_path) == []   # no data/, no results/


@pytest.mark.parametrize("argv", [["--local"],
                                  ["--local", "--hardware", "GPU"]])
def test_gpu_tier_refuses_the_cpu_in_process(argv, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=NO_DEVICE):
        cli.main([*argv, "--dataset", DATASET])
    assert not (tmp_path / "data").exists()
    assert not (tmp_path / "results").exists()


def test_cpu_tier_runs_when_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cli.main(["--local", "--hardware", "CPU", "--dataset", DATASET])
    # The plain PyTorch product, with the host baselines of the CPU tier.
    rows = [props for props, _ in load_all_results(DATASET)]
    assert sorted({props["algo"] for props in rows}) == [
        "bruteforce-product-blas", "native-product", "torch-product-cpu"]
    (props,) = [p for p in rows if p["algo"] == "torch-product-cpu"]
    assert props["backend"] == "cpu"
