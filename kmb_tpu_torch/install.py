"""Build and check the port's native and device parts (the twin of
install.py):

    python -m kmb_tpu_torch.install [--hardware GPU|CPU] [--definitions FILE]

1. On the card (the GPU tier, the default; without a CUDA device it exits
   before it builds or writes anything): builds the kernel library
   (`ops/_build.build`, nvcc) and reports ptxas's registers and spills.
   `--hardware CPU` runs on the CPU only when asked and skips this step.
2. Builds the native float64 oracle (`native.build`, g++) and reports its
   threads.
3. Imports every entry of kmb_tpu_torch/algos.yaml (`algorithm_status`)
   and lists each with its status; a module that does not import fails
   the install.
4. Prints torch's version, CUDA's and the devices.

Exits 0 when every step passed.
"""

from __future__ import annotations

import argparse
import re
import sys

from kmb_tpu_torch import resolve_device
from kmb_tpu_torch.definitions import (
    DEFAULT_DEFINITIONS, Definition, InstantiationStatus, _load_yaml,
    algorithm_status)


def ptxas_summary(report):
    """'<kernels> kernels, <low>-<high> registers, <bytes> bytes spilled'
    from a `-Xptxas -v` report."""
    registers = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spills = sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", report))
    if not registers:
        return "no kernel in the report"
    return (f"{len(registers)} kernels, {min(registers)}-{max(registers)} "
            f"registers, {spills} bytes spilled")


def build_kernels():
    from kmb_tpu_torch.ops import _build

    library = _build.build()
    _build.load_library()
    print(f"kernel library: {library.name}: "
          f"{ptxas_summary(_build.report_path(library).read_text())}")


def build_native():
    from kmb_tpu_torch import native

    library = native.build()
    print(f"native oracle: {library.name} "
          f"(threads={native.num_threads()})")


def check_algorithms(definition_file):
    """Each algos.yaml entry's import status; False if a module is missing."""
    ok = True
    print("Checking algorithm modules:")
    for name, entry in sorted(_load_yaml(definition_file).items()):
        status = algorithm_status(Definition(
            algorithm=name, module=entry["module"],
            constructor=entry["constructor"], arguments={},
            query_argument_groups=[]))
        print(f"  {name:32s} {status.name}")
        ok &= status == InstantiationStatus.AVAILABLE
    return ok


def report_devices():
    import torch

    devices = [torch.cuda.get_device_name(i)
               for i in range(torch.cuda.device_count())]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"devices: {devices or ['cpu']}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m kmb_tpu_torch.install")
    parser.add_argument(
        "--hardware", default="GPU", choices=["CPU", "GPU"],
        help="GPU builds the kernels and needs a CUDA device; CPU skips them")
    parser.add_argument("--definitions", default=DEFAULT_DEFINITIONS)
    args = parser.parse_args(argv)
    try:
        resolve_device("cuda" if args.hardware == "GPU" else "cpu")
    except RuntimeError as exc:
        raise SystemExit(f"--hardware {args.hardware}: {exc}") from None

    if args.hardware == "GPU":
        build_kernels()
    build_native()
    ok = check_algorithms(args.definitions)
    report_devices()
    print("install:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
