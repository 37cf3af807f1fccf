"""Faults planted under the timed path, to show that `correct` fails.

- "stale": a query returns the engine's state unchanged (the answer of
  the query before);
- "half": half of the sources left out, the mean taken over the rest;
- "altered": one value of one answer altered where the query makes it;
- "exchange": the ring's exchange between ranks left out (each rank
  folds its own chunk at every step);
- "slow_rank": no fault of the answer, a delay: rank 1's card sleeps
  about 5 ms before each ring step, outside the launch timer's events,
  so the ring's lockstep grows and `lockstep_ms.ring4` has to show it.

`plant(name)` patches the port in this process and returns the undo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kmb_tpu_torch.algorithms import torch_engine, torch_sharded
from kmb_tpu_torch.parallel import sharded

ENGINES = (torch_engine.TorchProduct, torch_sharded.ShardedProduct)
SLOW_CYCLES = 10_000_000      # about 5 ms at the H100's 1.98 GHz


def _patch(owner, name, value, undo):
    undo.append((owner, name, getattr(owner, name)))
    setattr(owner, name, value)


def _halved(matvec):
    def half(x, y, b, **kwargs):
        m = y.shape[0] // 2
        out = matvec(x, y[:m], b[:m], **kwargs)
        scale = y.shape[0] / m
        if isinstance(out, tuple):
            return tuple(None if t is None else t * scale for t in out)
        return out if kwargs.get("normalize_rows") else out * scale
    return half


def plant(name):
    undo = []
    if name == "stale":
        for cls in ENGINES:
            original = cls.query

            def query(self, original=original):
                if getattr(self, "res", None) is None:
                    original(self)
            _patch(cls, "query", query, undo)
    elif name == "half":
        _patch(torch_engine, "kernel_matvec",
               _halved(torch_engine.kernel_matvec), undo)
        _patch(sharded, "kernel_matvec", _halved(sharded.kernel_matvec),
               undo)
    elif name == "altered":
        for cls in ENGINES:
            original = cls.query

            def query(self, original=original):
                original(self)
                self.calls = getattr(self, "calls", 0) + 1
                if self.calls == 3:
                    self.res[0, 0] += 1e-3 * float(self.res.abs().max())
            _patch(cls, "query", query, undo)
    elif name == "exchange":
        def rotate(self, send, recv):
            recv.copy_(send)
            return []
        _patch(sharded.Mesh, "rotate", rotate, undo)
    elif name == "slow_rank":
        original = sharded.ring_chunk

        def ring_chunk(*args, **kwargs):
            if dist.get_rank() == 1 and torch.cuda.is_available():
                torch.cuda._sleep(SLOW_CYCLES)
            return original(*args, **kwargs)
        _patch(sharded, "ring_chunk", ring_chunk, undo)
    else:
        raise ValueError(f"no fault {name!r}")

    def restore():
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)
    return restore
