"""Experiment orchestrator: plan, dedup, dispatch (the port's kmb_tpu/main.py).

`python -m kmb_tpu_torch --dataset D` loads the dataset's attrs, expands
kmb_tpu_torch/algos.yaml into the matching experiment definitions, drops
those whose result files already exist, shuffles the rest and runs them
serially, each in a fresh child process under `--timeout`
(runner.run_subprocess), or in this process with `--local`.  `--hardware`
picks the algos.yaml tier and the device: GPU (the default) runs on "cuda"
and exits when there is no CUDA device, before any child starts; CPU runs
on "cpu", and only when asked for.

Launched as several processes (torchrun, or the KMB_COORDINATOR_ADDRESS,
KMB_NUM_PROCESSES and KMB_PROCESS_ID variables), one per card, every rank
runs rank 0's plan in the same order, the sharded algorithms span all
ranks, and rank 0 writes the results.  A child process cannot join its
parent's process group, so several ranks need `--local`:

    torchrun --nproc-per-node 4 -m kmb_tpu_torch --local --dataset D
"""

from __future__ import annotations

import argparse
import logging
import logging.config
import os
import random
import sys

import torch
import torch.distributed

from kmb_tpu_torch import resolve_device
from kmb_tpu_torch.datasets import DATASETS, get_dataset
from kmb_tpu_torch.definitions import (
    DEFAULT_DEFINITIONS, InstantiationStatus, algorithm_status,
    get_definitions, list_algorithms,
)
from kmb_tpu_torch.parallel import multihost
from kmb_tpu_torch.results import get_result_filename, record_failure
from kmb_tpu_torch.runner import run, run_subprocess

logger = logging.getLogger("kmb")


def positive_int(value):
    try:
        i = int(value)
    except ValueError:
        i = 0
    if i < 1:
        raise argparse.ArgumentTypeError(
            f"{value!r} is not a positive integer")
    return i


def make_parser():
    parser = argparse.ArgumentParser(
        prog="python -m kmb_tpu_torch",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument(
        "--dataset", metavar="NAME", choices=DATASETS.keys(),
        default="product-sphere-D3-E1-M1000-N1000-inverse-distance",
        help="dataset to benchmark on")
    parser.add_argument(
        "--hardware", metavar="TIER", default="GPU", choices=["CPU", "GPU"],
        help="hardware tier (selects algos.yaml entries and the device); "
             "GPU needs a CUDA device, CPU runs the plain PyTorch versions")
    parser.add_argument(
        "--definitions", metavar="FILE", default=DEFAULT_DEFINITIONS,
        help="load algorithm definitions from FILE")
    parser.add_argument(
        "--algorithm", metavar="NAME", default=None,
        help="run only the named algorithm")
    parser.add_argument(
        "--exclude", metavar="NAME", action="append", default=[],
        help="skip the named algorithm (repeatable)")
    parser.add_argument(
        "--list-algorithms", action="store_true",
        help="print the names of all known algorithms and exit")
    parser.add_argument(
        "--force", action="store_true",
        help="re-run experiments whose results already exist")
    parser.add_argument(
        "--runs", metavar="COUNT", type=positive_int, default=2,
        help="repetitions per experiment; the best time is kept, so run 1 "
             "absorbs the kernels' first-use build")
    parser.add_argument(
        "--timeout", type=int, default=2 * 600,
        help="per-experiment timeout in seconds (-1 for none)")
    parser.add_argument(
        "--local", action="store_true",
        help="run in-process instead of isolated subprocesses (needed "
             "when several ranks run)")
    parser.add_argument(
        "--max-n-algorithms", type=int, default=-1,
        help="cap the number of experiments (for smoke tests)")
    parser.add_argument(
        "--run-disabled", action="store_true",
        help="run algorithms marked disabled in algos.yaml")
    return parser


def device_for(hardware):
    return "cuda" if hardware == "GPU" else "cpu"


def plan_experiments(args):
    """Expand definitions and drop already-completed experiments."""
    dataset_file, dimension = get_dataset(
        args.dataset, device=device_for(args.hardware))
    kernel = dataset_file.attrs["kernel"]
    task = dataset_file.attrs["task"]
    normalize_rows = bool(dataset_file.attrs.get("normalize_rows", False))
    dataset_file.close()
    # A missing dataset's truth may have been computed on the card: give
    # its memory back, so the children of a subprocess sweep find the
    # card free but for this process's context.
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()

    definitions = get_definitions(
        definition_file=args.definitions,
        dimension=dimension,
        dataset=args.dataset,
        task=task,
        hardware=args.hardware,
        kernel=kernel,
        normalize_rows=normalize_rows,
        run_disabled=args.run_disabled,
    )

    filtered = []
    for definition in definitions:
        remaining = [
            qa for qa in (definition.query_argument_groups or [{}])
            if args.force or not os.path.exists(
                get_result_filename(args.dataset, definition, qa))
        ]
        if remaining:
            filtered.append(
                definition.replace(query_argument_groups=remaining))
    definitions = filtered

    random.shuffle(definitions)

    if args.algorithm:
        definitions = [d for d in definitions
                       if d.algorithm == args.algorithm]
    if args.exclude:
        definitions = [d for d in definitions
                       if d.algorithm not in args.exclude]

    def importable(definition):
        status = algorithm_status(definition)
        if status == InstantiationStatus.NO_CONSTRUCTOR:
            raise RuntimeError(
                f"{definition.module} does not expose "
                f"{definition.constructor}")
        if status == InstantiationStatus.NO_MODULE:
            logger.warning("module %s could not be loaded; skipping",
                           definition.module)
            return False
        return True

    definitions = [d for d in definitions if importable(d)]

    if args.max_n_algorithms >= 0:
        definitions = definitions[: args.max_n_algorithms]
    return definitions


def main(argv=None):
    args = make_parser().parse_args(argv)
    if args.timeout == -1:
        args.timeout = None
    if args.list_algorithms:
        list_algorithms(args.definitions)
        sys.exit(0)
    # Fails here, before any dataset or result is written, when the tier's
    # device is missing: the port never carries on on the CPU unasked.
    try:
        resolve_device(device_for(args.hardware))
    except RuntimeError as exc:
        raise SystemExit(f"--hardware {args.hardware}: {exc}") from None

    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO, format="%(levelname)s:%(name)s:%(message)s")

    # Multi-process bring-up (a no-op unless the environment asks for it).
    if multihost.initialize(device=device_for(args.hardware)):
        logger.info("Multi-process: rank %d of %d.",
                    torch.distributed.get_rank(), multihost.num_hosts())
    if multihost.num_hosts() > 1 and not args.local:
        raise SystemExit(
            f"{multihost.num_hosts()} ranks: a child process cannot join "
            "this process group, so a multi-process run needs --local")

    # Every rank runs rank 0's plan (its shuffle and its view of the
    # results already stored), in the same order: the ranks' collectives
    # must meet.
    definitions = multihost.broadcast_from_coordinator(
        plan_experiments(args) if multihost.is_coordinator() else None)
    if not definitions:
        raise SystemExit("Nothing to run")
    logger.info("Order: %s", [d.algorithm for d in definitions])

    # One definition's failure (a timeout, a dead child, an exception)
    # must not end the sweep: log it, record a .failed marker, move on,
    # and exit non-zero at the end.
    failures = 0
    for definition in definitions:
        reason = None
        try:
            if args.local:
                run(definition=definition, dataset=args.dataset,
                    runs=args.runs, device=device_for(args.hardware))
            else:
                reason = run_subprocess(
                    definition=definition, dataset=args.dataset,
                    runs=args.runs, hardware=args.hardware,
                    timeout=args.timeout)
        except Exception as exc:
            reason = f"exception: {exc!r}"
            logger.exception("Experiment failed: %s on %s",
                             definition, args.dataset)
        if reason is not None:
            failures += 1
            for qa in (definition.query_argument_groups or [{}]
                       if multihost.is_coordinator() else []):
                record_failure(dataset=args.dataset, definition=definition,
                               query_arguments=qa, reason=reason)
    if failures:
        logger.warning("%d/%d experiments failed.", failures,
                       len(definitions))
        sys.exit(1)
