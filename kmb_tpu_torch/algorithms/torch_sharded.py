"""Sharded algorithms: the distributed engine as a harness citizen.

The twins of kmb_tpu/algorithms/tpu_sharded.py (`ShardedProduct`,
`ShardedSolverCG`, same constructor arguments and `get_additional` keys).
They wrap the schedules of parallel/sharded.py in the benchmark lifecycle,
so distributed runs give the same result files as every other method.

The mesh spans every rank of the process group (multihost.initialize; one
process per card), or the first `n_devices` of them; without a process
group it is this process alone, a world of one.  Mesh construction and the
staging of each rank's shards happen in the untimed `prepare_*` hooks; the
Nystrom build is timed in `fit`; `query` runs the sharded computation,
gathers the whole result onto every rank and ends in `hard_fence` on every
rank.  `n_chips` is the mesh's rank count.  A mesh over some of the ranks
sends its result to the others, so every rank returns the same answer.
"""

from __future__ import annotations

import numpy as np
import torch

from kmb_tpu_torch import resolve_device
from kmb_tpu_torch.algorithms.base import BaseProduct, BaseSolver
from kmb_tpu_torch.algorithms.torch_engine import _TorchAlgorithm
from kmb_tpu_torch.parallel import multihost
from kmb_tpu_torch.parallel.sharded import (
    build_sharded_precond, cg_solve_shard, make_mesh, prepare_sharded_cg,
    product_shard, shard_layout, shard_rows)
from kmb_tpu_torch.trace import span
from kmb_tpu_torch.utils import hard_fence


def _resolve_ranks(n_devices):
    """The ranks of the mesh: the first `n_devices` (all when not set)."""
    world = multihost.num_hosts()
    if n_devices and n_devices > 0:
        if n_devices > world:
            raise RuntimeError(
                f"requested {n_devices} devices, have {world}")
        return range(n_devices)
    return range(world)


class _ShardedAlgorithm(_TorchAlgorithm):
    _DEVICE_ATTRS = _TorchAlgorithm._DEVICE_ATTRS + ("xs", "ys", "bs",
                                                     "_prepared")

    def get_additional(self):
        extra = super().get_additional()
        extra["n_chips"] = self.mesh.size
        return extra


class ShardedProduct(_ShardedAlgorithm, BaseProduct):
    """Kernel product sharded over the ranks.

    schedule="ring" rotates source shards around the ranks (context
    parallelism); schedule="allpairs" uses a 2-D (tgt, src) mesh with one
    reduction, and degrades to the ring on a 1-D mesh (one rank, or an odd
    count).  mesh_shape overrides the layout, e.g. [2, 2]; a 2-D mesh runs
    the all-pairs schedule.
    """

    def __init__(self, *, kernel, dimension, normalize_rows=False,
                 precision="float32", schedule="ring", mesh_shape=None,
                 n_devices=None, block_n=None, block_m=None, device="cuda"):
        super().__init__(kernel=kernel, dimension=dimension,
                         normalize_rows=normalize_rows, precision=precision)
        self._check_kernel(kernel)
        self._check_precision(precision)
        if schedule not in ("ring", "allpairs"):
            raise ValueError(f"Unknown schedule {schedule!r}.")
        self.device = resolve_device(device)
        self.schedule = schedule
        self.mesh_shape = tuple(mesh_shape) if mesh_shape else None
        self.n_devices = n_devices
        self.block_n = block_n
        del block_m   # kmb_tpu's Pallas tile; the CUDA kernels pick theirs
        # n_devices tells device-sweep rows apart (the scaling-efficiency
        # metric groups by name).
        tag = f", devices={n_devices}" if n_devices else ""
        self.name = f"ShardedProduct({precision}, {schedule}{tag})"

    def prepare_data(self, *, source_points, target_points, same_points=False,
                     density_estimation=False):
        ranks = _resolve_ranks(self.n_devices)
        if self.mesh_shape:
            shape = self.mesh_shape
        elif self.schedule == "allpairs" and len(ranks) % 2 == 0:
            shape = (2, len(ranks) // 2)
        else:
            shape = (len(ranks),)
        self.mesh = make_mesh(shape, ranks=ranks, device=self.device)
        self._schedule = "allpairs" if len(self.mesh.shape) == 2 else "ring"
        y = np.asarray(source_points, dtype=np.float32)
        x = y if same_points else np.asarray(target_points, dtype=np.float32)
        self.n, self.m = len(x), len(y)
        self.density_estimation = density_estimation
        if self.mesh.member:
            targets, sources = shard_layout(self.mesh, self._schedule)
            self.xs = shard_rows(x, *targets, self.mesh.device)
            self.ys = shard_rows(y, *sources, self.mesh.device)

    def fit(self):
        pass  # streaming: no precomputation

    def prepare_query(self, *, source_signal):
        b = (np.ones((self.m, 1), np.float32) if self.density_estimation
             else np.asarray(source_signal, dtype=np.float32))
        self.e = b.shape[1]
        if self.mesh.member:
            _, sources = shard_layout(self.mesh, self._schedule)
            with span("engine.stage_signal"):
                self.bs = shard_rows(b, *sources, self.mesh.device)

    def query(self):
        if self.density_estimation and self.normalize_rows:
            out = torch.ones((self.n, 1), dtype=torch.float32,
                             device=self.mesh.device)
        elif self.mesh.member:
            local = product_shard(
                self.xs, self.ys, self.bs, mesh=self.mesh,
                schedule=self._schedule, n=self.n, m=self.m,
                kernel_name=self.kernel, normalize_rows=self.normalize_rows,
                density_estimation=self.density_estimation,
                precision=self.precision, block_n=self.block_n)
            out = self.mesh.gather_rows(local, self.n)
        else:
            out = torch.empty((self.n, self.e), dtype=torch.float32,
                              device=self.mesh.device)
        self.res = hard_fence(self.mesh.publish(out))

    def get_additional(self):
        extra = super().get_additional()
        extra["schedule"] = self.schedule
        return extra


class ShardedSolverCG(_ShardedAlgorithm, BaseSolver):
    """Distributed matrix-free Krylov solver: the ring matvec, with every
    dot product summed over the ranks."""

    def __init__(self, *, kernel, dimension, normalize_rows=False,
                 precision="float32", tol=1e-6, max_iters=1000,
                 precond_rank=0, n_devices=None, device="cuda"):
        super().__init__(kernel=kernel, dimension=dimension,
                         normalize_rows=normalize_rows, precision=precision)
        self._check_kernel(kernel)
        self._check_precision(precision)
        self.device = resolve_device(device)
        self.tol = tol
        self.max_iters = max_iters
        self.precond_rank = int(precond_rank)
        self.n_devices = n_devices
        self.iterations = 0
        self.residual = float("nan")
        # Kept through set_query_arguments' name rebuild, so the rank-256
        # variant is not stored under the plain variant's name.
        self._param_tag = f", rank={precond_rank}" if precond_rank else ""
        self.name = f"ShardedSolverCG({precision}, tol={tol}{self._param_tag})"

    def prepare_data(self, *, source_points):
        ranks = _resolve_ranks(self.n_devices)
        self.mesh = make_mesh((len(ranks),), ranks=ranks, device=self.device)
        self.m = len(source_points)
        # Untimed: stage this rank's shard and build the ring matvec.  The
        # Nystrom build is timed (fit), as in the single-card solver.
        if self.mesh.member:
            self._prepared = prepare_sharded_cg(
                np.asarray(source_points, dtype=np.float32), mesh=self.mesh,
                kernel_name=self.kernel, precision=self.precision)

    def fit(self):
        # TIMED: the sharded Nystrom build (one ring product with
        # E = rank); rank 0 keeps it a no-op.
        if self.precond_rank > 0 and self.mesh.member:
            self._prepared = build_sharded_precond(
                self._prepared, kernel_name=self.kernel,
                precond_rank=self.precond_rank)
            hard_fence(self._prepared.precond.u)

    def set_query_arguments(self, tol=None, max_iters=None):
        if tol is not None:
            self.tol = tol
        if max_iters is not None:
            self.max_iters = max_iters
        self.name = (f"ShardedSolverCG({self.precision}, "
                     f"tol={self.tol}{self._param_tag})")

    def prepare_query(self, *, target_signal):
        rhs = np.asarray(target_signal, dtype=np.float32)
        self.e = rhs.shape[1]
        if self.mesh.member:
            self.rhs = shard_rows(rhs, self.mesh.size, self.mesh.index,
                                  self.mesh.device)

    def query(self):
        mesh = self.mesh
        iters, residual = 0, 0.0
        if mesh.member:
            b, iters, residual = cg_solve_shard(
                self._prepared, self.rhs, kernel_name=self.kernel,
                tol=float(self.tol), max_iters=int(self.max_iters))
            b = mesh.gather_rows(b, self.m)
        else:
            b = torch.empty((self.m, self.e), dtype=torch.float32,
                            device=mesh.device)
        if mesh.size < mesh.world:   # the other ranks take the mesh's answer
            info = mesh.publish(torch.tensor(
                [iters, residual], dtype=torch.float64, device=mesh.device))
            iters, residual = int(info[0]), float(info[1])
            mesh.publish(b)
        self.res = hard_fence(b)
        self.iterations = int(iters)
        self.residual = float(residual)

    def get_additional(self):
        extra = super().get_additional()
        extra.update(cg_iterations=self.iterations,
                     cg_relative_residual=self.residual)
        return extra
