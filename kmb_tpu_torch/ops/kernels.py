"""Kernel function zoo (PyTorch side), the twin of kmb_tpu.ops.kernels.

Semantics match the JAX zoo exactly:

- "gaussian":              k(x, y) = exp(-|x - y|^2)
- "absolute-exponential":  k(x, y) = exp(-|x - y|)
- "inverse-distance":      k(x, y) = 1 / |x - y|, with k = 0 on the diagonal
- "exponential":           k(x, y) = exp(<x, y>)  (attention kernel)

Each `KernelSpec` carries the canonical maps (`fn`, `log_fn`) and the
engine fast path of the streaming product:

- `point_scale`: engines multiply the points by this first;
- `form_sign`: engines produce `form_sign * point_scale^2 * true_form`;
- `scaled_fn`: kernel values from that signed, scaled form;
- `scaled_log2_fn`: BASE-2 logits from that form.  The flash accumulation
  runs entirely in base 2 (`exp2` rescales), and the deferred (acc, m, l)
  state carries a base-2 running max, so states from shards merge with the
  same exp2 algebra as the JAX package.

Scaling both point sets by sqrt(log2 e) scales squared distances and dot
products by log2 e, so the per-pair transcendental of exp-family kernels
is a bare exp2.  The CUDA kernels (`csrc/common.cuh`) hard-code the same
maps per kernel; the tests hold these against the JAX zoo.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

LOG2E = math.log2(math.e)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str
    on: str  # "sqdist" | "dot"
    fn: Callable[[torch.Tensor], torch.Tensor]
    log_fn: Optional[Callable[[torch.Tensor], torch.Tensor]]
    zero_diagonal: bool = False
    # Engine fast path (see module docstring); defaults = canonical form.
    point_scale: float = 1.0
    form_sign: float = 1.0
    scaled_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    scaled_log2_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __post_init__(self):
        if self.scaled_fn is None:
            object.__setattr__(self, "scaled_fn", self.fn)
        if self.scaled_log2_fn is None and self.log_fn is not None:
            log_fn = self.log_fn
            object.__setattr__(
                self, "scaled_log2_fn", lambda g: log_fn(g) * LOG2E)


def _clamp0(t):
    # max(t, 0) with -0.0 turned into +0.0 (and NaN kept), as jnp.maximum
    # gives it: rsqrt(-0.0) would be -inf.
    return torch.clamp_min(t, 0.0) + 0.0


def _gaussian(sqd):
    return torch.exp(-sqd)


def _gaussian_log(sqd):
    return -sqd


def _abs_exp(sqd):
    return torch.exp(-torch.sqrt(_clamp0(sqd)))


def _abs_exp_log(sqd):
    return -torch.sqrt(_clamp0(sqd))


def _inverse_distance(sqd):
    # 1/sqrt(0) = inf; the engines mask the diagonal (zero_diagonal=True).
    return torch.rsqrt(_clamp0(sqd))


def _exponential(dot):
    return torch.exp(dot)


def _exponential_log(dot):
    return dot


def _neg_sqrt(g):
    return -torch.sqrt(_clamp0(g))


def _identity(g):
    return g


KERNELS = {
    # Engine form: g = -log2(e) * |x - y|^2  =>  k = 2^g.
    "gaussian": KernelSpec(
        name="gaussian", on="sqdist", fn=_gaussian, log_fn=_gaussian_log,
        point_scale=math.sqrt(LOG2E), form_sign=-1.0,
        scaled_fn=torch.exp2, scaled_log2_fn=_identity,
    ),
    # Engine form: g = (log2(e) * |x - y|)^2  =>  k = 2^(-sqrt(g)).
    "absolute-exponential": KernelSpec(
        name="absolute-exponential", on="sqdist", fn=_abs_exp,
        log_fn=_abs_exp_log,
        point_scale=LOG2E,
        scaled_fn=lambda g: torch.exp2(_neg_sqrt(g)),
        scaled_log2_fn=_neg_sqrt,
    ),
    "inverse-distance": KernelSpec(
        name="inverse-distance",
        on="sqdist",
        fn=_inverse_distance,
        log_fn=None,
        zero_diagonal=True,
    ),
    # Engine form: g = log2(e) * <x, y>  =>  k = 2^g.
    "exponential": KernelSpec(
        name="exponential", on="dot", fn=_exponential,
        log_fn=_exponential_log,
        point_scale=math.sqrt(LOG2E),
        scaled_fn=torch.exp2, scaled_log2_fn=_identity,
    ),
}


def get_kernel(name: str) -> KernelSpec:
    if name not in KERNELS:
        raise NotImplementedError(
            f"Kernel {name!r} is not supported; choose from {sorted(KERNELS)}."
        )
    return KERNELS[name]
