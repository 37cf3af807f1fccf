"""Run one cell of the benchmark and print its result as one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up (process start to the first timed
query: imports, the card, the kernel library, the inputs from the seed,
the engine's `prepare_data` and `fit`, one warm query) is `setup_s`.
Then queries run back to back for `--seconds`.  With `--trace 0` the
line carries the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics (see session.py for what a traced window adds).  After
the window the program's state is freed and the cell's task judges what
it kept of every answer against its plain reference (check.py); each
number compared is printed beside its limit, last on standard error and
last in the line.

A cell on several cards runs one process per card: this process is rank
0 and starts the others (the same command with `--rank`), which print
nothing on standard output.  The run exits non-zero, printing no result,
without enough CUDA cards, when a rank fails, and when jax, jaxlib, flax
or the JAX package `kmb_tpu` is loaded in this process.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from portbench import cell as cells  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "kmb_tpu")
CACHE = cells.ROOT / ".portbench_cache"
METRICS = cells.HERE / "metrics"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Set by rank 0 for the ranks it starts.
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--address", help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--override", type=json.loads, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def fixed_caches():
    """Kernel and build caches at fixed paths inside the checkout."""
    for name, sub in (("TRITON_CACHE_DIR", "triton"),
                      ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                      ("CUDA_CACHE_PATH", "nv")):
        os.environ[name] = str(CACHE / sub)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def free_address():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def rank_args(args):
    """This run's arguments for the ranks it starts, less --rank and
    --address."""
    out = ["--workload", args.workload, "--seed", str(args.seed),
           "--seconds", repr(args.seconds), "--trace", str(args.trace),
           "--device", args.device]
    if args.override:
        out += ["--override", json.dumps(args.override)]
    return out


def start_ranks(command, world, device):
    """Ranks 1 .. world - 1, each `command` + --rank and --address;
    returns the address and the processes.  On the card the kernel
    library is built first, once, rather than by every rank at once."""
    if device == "cuda":
        from kmb_tpu_torch.ops import _build
        _build.build()
    address = free_address()
    procs = [subprocess.Popen(command + ["--rank", str(r),
                                         "--address", address],
                              stdout=sys.stderr.fileno())
             for r in range(1, world)]
    return address, procs


def stop_ranks(procs, timeout=120):
    """Wait for every rank; end any that outlives `timeout`.  Returns the
    exit codes."""
    codes = []
    for proc in procs:
        try:
            codes.append(proc.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            proc.kill()
            codes.append(proc.wait())
    return codes


def join_ranks(address, world, rank, device):
    """This rank's place in the process group (NCCL on the card, gloo on
    the CPU), and the harness's own gloo group for its control messages
    (None where the world's group is gloo already)."""
    import torch.distributed as dist

    from kmb_tpu_torch.parallel import multihost

    multihost.initialize(address, world, rank, device=device)
    return (dist.new_group(backend="gloo")
            if dist.get_backend() == "nccl" else None)


def read_metric(name, measured):
    """The metric's reader, `metrics/<name>.py`; None where it found
    nothing to read."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(measured)


def run_cell(args, prefix=None):
    """One rank's run; rank 0 returns the result's parts, others None.
    `prefix` is the command that starts a rank (default: this module)."""
    import torch
    import torch.distributed as dist

    from portbench import check, devtrace, roofline
    from portbench.session import Session

    torch.set_num_threads(1)
    cell = cells.load(args.workload, args.override)
    world = cell.chips
    procs = []
    address = args.address
    if args.rank == 0 and world > 1:
        address, procs = start_ranks(
            (prefix or [sys.executable, "-m", "portbench.run"])
            + rank_args(args), world, args.device)
    try:
        control = (join_ranks(address, world, args.rank, args.device)
                   if world > 1 else None)
        session = Session(cell, args.seed, device=args.device,
                          rank=args.rank, world=world, control=control)
        began = time.perf_counter()
        session.set_up()
        setup_s = time.perf_counter() - STARTED
        steps = dict(start=began - STARTED, **session.setup_steps)
        if args.trace:
            half = args.seconds / 2
            window_s = session.window(half, counted=True)
            window_s += session.window(half, profiled=True)
        else:
            window_s = session.window(args.seconds)
        reports = session.gather()
        session.free()
        if world > 1:
            dist.destroy_process_group()
        if args.rank != 0:
            return None
        correct, failed, numbers = check.judge(*session.compared(),
                                               cell.limits)
        codes = stop_ranks(procs)
        procs = []
        if any(codes):
            raise RuntimeError(f"a rank failed: exit codes {codes}")
    finally:
        for proc in procs:
            proc.kill()
        stop_ranks(procs)

    cuda = session.cuda
    measured = SimpleNamespace(
        config=cell.config, world=world, setup_s=setup_s,
        window_s=window_s, reports=reports,
        queries=reports[0].queries,
        pairs=session.task.pairs(cell.config), launch_bound_ms=None)
    device = {"platform": "gpu" if cuda else "cpu", "count": world}
    if cuda:
        index = torch.cuda.current_device()
        device["kind"] = torch.cuda.get_device_name(index)
        device["memory_peak_bytes"] = max(r.memory_peak_bytes
                                          for r in reports)
        facts = roofline.card_facts(index)
        if facts is not None:
            device["power_limit_w"] = facts[2]
            sms = torch.cuda.get_device_properties(index).multi_processor_count
            measured.launch_bound_ms = session.task.launch_bound_ms(
                cell.config, world,
                roofline.special_function_rate(sms, facts[1]))
    metrics = {}
    breakdown = None
    if cuda and args.trace:
        traces = [r.trace for r in reports]
        timed = sum(sum(q.launch_ms) for q in measured.queries
                    if q.launch_ms is not None)
        print(f"launch timer: {timed!r} ms of hand kernels over the counted "
              f"half; trace: {traces[0].get('hand_kernel_ms')!r} ms over "
              f"the profiled half", file=sys.stderr)
        lost = [t["missing"] for t in traces if "missing" in t]
        if lost:
            raise devtrace.MissingRecords("; ".join(lost))
        device["busy_s"] = statistics.fmean(t["busy_s"] for t in traces)
        device["window_s"] = statistics.fmean(t["window_s"] for t in traces)
        breakdown = {k: traces[0][k] for k in ("device_ops", "idle_gaps")}
    if cuda:   # a number from the CPU is never a device metric
        for metric in cell.per_layer if args.trace else cell.end_to_end:
            value = read_metric(metric["name"], measured)
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items()),
          file=sys.stderr)
    result = {"correct": correct, "attempted": len(session.answers),
              "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = check.summary(numbers, cell.limits)
    return result, check.lines(numbers, cell.limits)


def main(argv=None, prefix=None):
    args = parse(argv)
    fixed_caches()
    # One client process, one host thread: a query's host work needs no
    # thread pool, and idle workers would share the host's cores with it.
    os.environ["OMP_NUM_THREADS"] = "1"
    if args.rank == 0:
        import torch

        chips = cells.load(args.workload).chips
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < chips:
            print(f"portbench: {args.workload} needs {chips} CUDA card(s), "
                  f"this machine has {have}", file=sys.stderr)
            return 2
    out = run_cell(args, prefix)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    if out is None:
        return 0
    result, lines = out
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
