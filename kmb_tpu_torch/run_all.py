"""The full sweep, then the website (the twin of run_all.sh):

    python -m kmb_tpu_torch.run_all [--hardware GPU|CPU] [CLI flags ...]

Every registry dataset but the large-scale entries that run_all.sh leaves
to explicit runs (`sweep_datasets`) goes through
`python -m kmb_tpu_torch --local` (a failure is reported and the sweep goes
on) and `python -m kmb_tpu_torch.plot`, then
`python -m kmb_tpu_torch.website --outputdir website --latex` builds the
site.  `--hardware` (default GPU, which needs a CUDA device) goes to the
runs and the plots; other flags go to the runs.  Results land under the
working directory, as the CLI puts them.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

from kmb_tpu_torch.datasets import DATASETS

# run_all.sh's filter: entries run explicitly, not in the sweep.
LARGE_SCALE = ("M131072", "M50000", "M60000")


def sweep_datasets():
    """The registry's names that the sweep runs, in registry order."""
    return [name for name in DATASETS
            if not any(tag in name for tag in LARGE_SCALE)]


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m kmb_tpu_torch.run_all")
    parser.add_argument("--hardware", default="GPU", choices=["CPU", "GPU"])
    args, extra = parser.parse_known_args(argv)
    python = sys.executable
    failed = []
    for dataset in sweep_datasets():
        print(f"=== {dataset} ===", flush=True)
        if subprocess.run([python, "-m", "kmb_tpu_torch", "--dataset",
                           dataset, "--local", "--hardware", args.hardware,
                           *extra]).returncode != 0:
            print(f"FAILED: {dataset}", flush=True)
            failed.append(dataset)
        subprocess.run([python, "-m", "kmb_tpu_torch.plot", "--dataset",
                        dataset, "--hardware", args.hardware])
    subprocess.run([python, "-m", "kmb_tpu_torch.website", "--outputdir",
                    "website", "--latex"], check=True)
    print(f"Sweep complete: results/ and website/ are populated; "
          f"{len(failed)} datasets failed: {failed}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
