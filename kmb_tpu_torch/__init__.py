"""kmb_tpu_torch — the PyTorch / CUDA port of kmb_tpu for an NVIDIA H100.

The package mirrors kmb_tpu's module layout, so each module's counterpart
is found under the same name.  It imports torch and never jax, and
nothing of kmb_tpu: what it needs of that package's JAX-free modules
(the lifecycle API, the float64 oracle, the dataset registry, the
definitions and result store) it keeps as its own copies.

The streaming kernel product and attention run on the card through two
hand-written CUDA kernels (`kmb_tpu_torch/ops/csrc/`), built
with nvcc at first use and bound with ctypes.  Every entry point takes
an explicit `device`, defaulting to "cuda"; with no CUDA device it raises
unless the caller passes device="cpu", which runs the plain PyTorch
versions of the kernels.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# The float32 tier must never silently run on TF32 tensor cores (about
# three decimal digits): the squared-distance form cancels, and the
# reference tiers are full f32.  Both switches are process-wide in torch.
# The matmul switch goes through set_float32_matmul_precision, the setter
# that keeps torch's old and new precision flags in step (setting
# `allow_tf32` alone after a caller's set_float32_matmul_precision("high")
# leaves them at odds, and recent torch then refuses to read either).
torch.set_float32_matmul_precision("highest")
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    Raises when CUDA is asked for (the default) and no card is present:
    the port never carries on on the CPU unless told to.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
