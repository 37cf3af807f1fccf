"""The harness end to end on the CPU, at a small size; what it imports;
and its refusals without a card."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "kmb_tpu"}
SMALL = {
    "cube-n2p20.signal-stream": {"n_targets": 400, "n_sources": 400},
    "glove25.signal-stream": {"n_targets": 64, "n_sources": 3000},
    "cube-n2p21-ring4.signal-stream": {"n_targets": 400, "n_sources": 400},
}


def cpu_args(cell, trace=0, seconds=0.5, seed=2**31 + 77):
    return run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace), "--device",
                      "cpu", "--override", json.dumps(SMALL[cell])])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_runs_on_the_cpu(repo_env, cell, trace):
    result, lines = run.run_cell(cpu_args(cell, trace))
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 2
    # No number from the CPU goes under a device metric's name.
    assert result["metrics"] == {}
    assert result["device"] == {"platform": "cpu",
                                "count": 4 if "ring4" in cell else 1}
    assert list(result)[-1] == "checks"
    assert [line.split()[1] for line in lines] == list(result["checks"])


def _top_level_modules(code, cwd):
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_imports_jax_or_the_jax_package(repo_env):
    # Every module of the benchmark, every metric reader, and a whole run:
    # the top-level name of each loaded module, compared whole
    # (kmb_tpu_torch is not kmb_tpu).
    code = textwrap.dedent(f"""
        import json, pkgutil, importlib, sys
        import portbench
        for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
            if not m.name.startswith("portbench.tests"):
                importlib.import_module(m.name)
        from portbench import run
        from types import SimpleNamespace
        for path in sorted(run.METRICS.glob("*.py")):
            try:
                run.read_metric(path.stem, SimpleNamespace())
            except Exception:
                pass
        args = run.parse(["--workload", "glove25.signal-stream", "--seed",
                          "5", "--seconds", "0.2", "--device", "cpu",
                          "--override", json.dumps({SMALL['glove25.signal-stream']!r})])
        run.run_cell(args)
        print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
    """)
    names = _top_level_modules(code, repo_env)
    assert "kmb_tpu_torch" in names and "portbench" in names
    assert not names & FORBIDDEN


def test_references_import_nothing_of_the_program(repo_env):
    code = textwrap.dedent("""
        import json, pkgutil, importlib, sys
        import portbench.references as refs
        for m in pkgutil.iter_modules(refs.__path__, "portbench.references."):
            importlib.import_module(m.name)
        print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
    """)
    names = _top_level_modules(code, repo_env)
    assert not names & (FORBIDDEN | {"kmb_tpu_torch"})


def test_refuses_without_a_card(repo_env):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "cube-n2p20.signal-stream", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=repo_env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_refuses_with_the_benchmark_files_alone(repo_env, tmp_path):
    shutil.copy(repo_env / "BENCHMARK.json", tmp_path)
    shutil.copytree(repo_env / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in __import__("os").environ.items()
           if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "cube-n2p20.signal-stream", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "kmb_tpu_torchx", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert run.forbidden_modules() == ["jaxlib"]
