"""Multi-process runtime: bring-up, barriers and rank-0 result ownership.

The port's counterpart of kmb_tpu/parallel/multihost.py, on
torch.distributed.  JAX runs one process per host, each driving all of its
host's chips; the torch idiom is one process per card, so a "host" here is
one rank and `num_hosts()` is the world size.  JAX's names are kept so that
each function's counterpart is found under the same name.

- `initialize()` brings up the process group (one call per process, before
  any collective) from arguments or the environment, and is a no-op when
  nothing asks for more than one process, so entry points call it
  unconditionally.  On the card the group is NCCL, one card per rank; on
  the CPU (device="cpu", the tests) it is gloo.  A failed bring-up raises:
  there is no fallback from NCCL to another backend.
- `is_coordinator()` gates filesystem side effects (result files) to rank 0:
  every rank computes, one rank records.
- `barrier()` synchronises the ranks.
- `max_across_hosts(x)` reduces a rank-local scalar (a wall-clock time) to
  the fleet maximum, so a multi-process time is the slowest rank's.
- `broadcast_from_coordinator(obj)` gives every rank rank 0's object (the
  CLI's experiment plan, so every rank runs the same experiments in the
  same order).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from kmb_tpu_torch import resolve_device


def _env_int(*names):
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return None


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, *, device="cuda"):
    """Bring up the process group; a no-op for single-process runs.

    Arguments default from the environment: KMB_COORDINATOR_ADDRESS,
    KMB_NUM_PROCESSES and KMB_PROCESS_ID (the JAX package's variables), else
    torchrun's MASTER_ADDR and MASTER_PORT, WORLD_SIZE and RANK.  With none
    of them set, nothing happens and False is returned.  The address is
    "host:port" (a TCP rendezvous) or a URL torch.distributed accepts as
    an init_method ("tcp://...", "file://...").

    device="cuda" (the default) makes an NCCL group with this rank bound to
    card LOCAL_RANK (default: the process id modulo the cards present);
    device="cpu" makes a gloo group.  Returns True once a group exists
    (also when one existed before the call).
    """
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        coordinator_address = os.environ.get("KMB_COORDINATOR_ADDRESS")
    if coordinator_address is None and "MASTER_ADDR" in os.environ \
            and "MASTER_PORT" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = _env_int("KMB_NUM_PROCESSES", "WORLD_SIZE")
    if coordinator_address is None and num_processes is None:
        return False
    if process_id is None:
        process_id = _env_int("KMB_PROCESS_ID", "RANK")
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a multi-process run needs a coordinator address, the number "
            "of processes and this process's id (got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r})")
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dev = resolve_device(device)
    kwargs = dict(init_method=init_method, world_size=int(num_processes),
                  rank=int(process_id))
    if dev.type == "cuda":
        local_rank = _env_int("LOCAL_RANK")
        if local_rank is None:
            local_rank = int(process_id) % torch.cuda.device_count()
        torch.cuda.set_device(local_rank)
        dist.init_process_group(
            "nccl", device_id=torch.device("cuda", local_rank), **kwargs)
    else:
        dist.init_process_group("gloo", **kwargs)
    return True


def is_coordinator() -> bool:
    """True on the process that owns filesystem side effects (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def num_hosts() -> int:
    """The number of processes (one per card; see the module docstring)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _collective_device() -> torch.device:
    """Where this rank's collective buffers live: its card under NCCL,
    the CPU under gloo (and without a process group)."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier():
    """Synchronise every rank; nothing to wait for without a group."""
    if dist.is_initialized():
        dist.barrier()


def max_across_hosts(value: float) -> float:
    """Fleet-wide maximum of a rank-local scalar (e.g. a timing)."""
    if num_hosts() <= 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def broadcast_from_coordinator(obj):
    """Rank 0's `obj` on every rank (a picklable object of this program,
    such as the experiment plan); the object itself without a group."""
    if num_hosts() <= 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_collective_device())
    return box[0]
