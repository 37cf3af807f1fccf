"""Child entry point for isolated experiment runs.

`python -m kmb_tpu_torch.run_algorithm ...` is what
`kmb_tpu_torch.runner.run_subprocess` starts for each experiment (the twin
of the repository's run_algorithm.py); see `runner.run_from_cmdline` for
its arguments.
"""

from kmb_tpu_torch.runner import run_from_cmdline

if __name__ == "__main__":
    run_from_cmdline()
