"""One-command end-to-end smoke of the port (the twin of smoke.sh):

    python -m kmb_tpu_torch.smoke [--hardware GPU|CPU] [--workdir DIR]
                                  [--skip tests|plot|website ...]

install -> the port's tests -> a benchmark run -> plot -> website, on the
smallest dataset, each step a `python -m` process in the work directory
(default: a fresh temporary directory, never the repository), which holds
its data/, results/, plot and website/.  `--hardware` (default GPU, which
needs a CUDA device) goes to install, the run and the plot.  The run is
smoke.sh's (5 algorithms, the disabled fixtures included) less the two
fixtures that sleep for minutes or crash by design, which would fail the
smoke or outlast it.  `--skip` leaves a step out and says so; the plot and
the website need matplotlib and jinja2.  At the end the result directory,
the plot and index.html must exist (the latter two unless skipped).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = "product-sphere-D3-E1-M1000-N1000-inverse-distance"
STEPS = ("install", "tests", "run", "plot", "website")
# Disabled fixtures that sleep for two minutes or crash by design.
EXCLUDED = ("dummy-sleepy", "dummy-crashy")


def commands(hardware):
    """Each step's command line."""
    python = sys.executable
    tests = sorted(os.path.join(ROOT, "tests", name)
                   for name in os.listdir(os.path.join(ROOT, "tests"))
                   if name.startswith("test_torch_") and name.endswith(".py"))
    run = [python, "-m", "kmb_tpu_torch", "--local", "--runs", "2",
           "--timeout", "300", "--run-disabled", "--max-n-algorithms", "5",
           "--dataset", DATASET, "--hardware", hardware]
    for name in EXCLUDED:
        run += ["--exclude", name]
    return {
        "install": [python, "-m", "kmb_tpu_torch.install", "--hardware",
                    hardware],
        "tests": [python, "-m", "pytest", *tests, "-x", "-q"],
        "run": run,
        "plot": [python, "-m", "kmb_tpu_torch.plot", "--dataset", DATASET,
                 "--hardware", hardware],
        "website": [python, "-m", "kmb_tpu_torch.website", "--outputdir",
                    "website", "--latex"],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m kmb_tpu_torch.smoke")
    parser.add_argument("--hardware", default="GPU", choices=["CPU", "GPU"])
    parser.add_argument("--workdir", help="default: a new temporary "
                        "directory")
    parser.add_argument("--skip", action="append", default=[],
                        choices=STEPS, help="leave this step out")
    args = parser.parse_args(argv)
    work = args.workdir or tempfile.mkdtemp(prefix="kmb_torch_smoke_")
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ, KMB_DATA_DIR=os.path.join(work, "data"),
               KMB_RESULTS_DIR=os.path.join(work, "results"))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    print(f"== smoke: workdir={work} dataset={DATASET} "
          f"hardware={args.hardware}", flush=True)
    steps = commands(args.hardware)
    for i, step in enumerate(STEPS, 1):
        if step in args.skip:
            print(f"== {i}/{len(STEPS)} {step}: skipped (--skip)", flush=True)
            continue
        print(f"== {i}/{len(STEPS)} {step}", flush=True)
        if subprocess.run(steps[step], cwd=work, env=env).returncode != 0:
            print(f"== smoke FAILED at {step}", flush=True)
            return 1

    results = os.path.join(work, "results", DATASET)
    wanted = [results]
    if "plot" not in args.skip:
        wanted.append(os.path.join(work, "results", f"{DATASET}.png"))
    if "website" not in args.skip:
        wanted.append(os.path.join(work, "website", "index.html"))
    missing = [path for path in wanted if not os.path.exists(path)
               or (os.path.isfile(path) and os.path.getsize(path) == 0)]
    if missing:
        print(f"== smoke FAILED: missing {missing}", flush=True)
        return 1
    print(f"== smoke OK: {len(os.listdir(results))} algorithm dirs"
          + ("" if "plot" in args.skip else ", plot")
          + ("" if "website" in args.skip else ", website")
          + f" under {work}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
