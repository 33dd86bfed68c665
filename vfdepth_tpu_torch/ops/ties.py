"""Elementwise ops whose gradient at a tie follows the JAX reference.

The forward values are PyTorch's own; only the derivative at the kink
differs between the frameworks, and a training step from a random init
hits those kinks exactly (a conv over an all-zero voxel region with zero
bias gives an exact 0 into LeakyReLU; constant disparity regions give an
exact 0 into the smoothness ``abs``):

* ``leaky_relu``: JAX's derivative at 0 is 1 (``where(x >= 0, ...)``),
  ``F.leaky_relu``'s is the negative slope;
* ``abs``: JAX's derivative at 0 is +1, ``torch.abs``'s is 0;
* ``clip``: ``jnp.clip`` is ``minimum(maximum(x, lo), hi)`` and splits the
  gradient 1/2 : 1/2 at a bound, ``torch.clamp`` passes all of it. Binary
  ``torch.maximum`` / ``torch.minimum`` split ties as JAX does.

(A min over an axis splits ties in both frameworks when written
``torch.amin`` / ``torch.amax``; ``torch.min(dim=...)`` does not.)
"""
from __future__ import annotations

import torch


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, x * negative_slope)


def abs(x: torch.Tensor) -> torch.Tensor:  # noqa: A001 (mirrors jnp.abs)
    return torch.where(x >= 0, x, -x)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    # the bounds are filled on x's device (no host-to-device copy)
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))
