"""The benchmark's own tests: CPU tests, and tests marked `cuda` that
skip without a card (decided in a fixture, never at import)."""

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def repo_env(monkeypatch):
    """Child processes find portbench and the port from the repository."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    monkeypatch.chdir(ROOT)
    return ROOT
