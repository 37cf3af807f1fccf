"""Small shared utilities."""

from __future__ import annotations

import contextlib

import torch

from kmb_tpu_torch.trace import span


@contextlib.contextmanager
def highest_precision():
    """True float32 matmuls (no TF32) inside; the caller's setting after."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def hard_fence(tree):
    """Force completion of every tensor in `tree` and return it.

    `tree` is a tensor, None, or a tuple/list of them.  A CUDA tensor is
    fenced by a device synchronize plus one host readback that depends on
    every element (a global reduction), so a host timer around the call
    measures finished device work, not the enqueue.
    """
    leaves = tree if isinstance(tree, (tuple, list)) else (tree,)
    leaves = [leaf for leaf in leaves if isinstance(leaf, torch.Tensor)]
    with span("fence.wait"):   # the host waits for the device
        for leaf in leaves:
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
    with span("fence.check"):  # the reduction, once the device is done
        for leaf in leaves:
            if leaf.numel():
                leaf.abs().max().item()
    return tree
