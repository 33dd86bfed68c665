"""Seeded weights, made on the device in a few large calls.

The ImageNet encoder weights are not in the repository, so both nets start
from a seeded random initialisation in the flax defaults' family: every
convolution and dense kernel normal with std 1/sqrt(fan_in), biases 0,
BatchNorm at identity. ``BEVFold``'s rel-depth kernel keeps the fan-in of
the joint convolution it is a slice of. The benchmark hands the same
tensors, by parameter name, to the program and to the plain reference.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch


def make(spec: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for ``spec``'s (name, shape)
    pairs: one normal draw for every kernel, scaled by one multiply."""
    spec = list(spec)
    shapes = dict(spec)
    kernels = [(n, s) for n, s in spec
               if not (n.endswith("bias") or len(s) == 1)]
    sizes = [math.prod(s) for _, s in kernels]
    stds = []
    for name, shape in kernels:
        fan = math.prod(shape[1:])
        if name.endswith("weight_rel"):
            fan += math.prod(shapes[name[:-len("_rel")]][1:])
        stds.append(1.0 / math.sqrt(fan))
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat *= torch.repeat_interleave(
        torch.tensor(stds, device=device, dtype=torch.float32),
        torch.tensor(sizes, device=device))
    out = dict(zip((n for n, _ in kernels),
                   (c.view(s) for c, (_, s) in zip(flat.split(sizes),
                                                   kernels))))
    for name, shape in spec:
        if name not in out:
            fill = 1.0 if name.endswith("bn.weight") else 0.0
            out[name] = torch.full(shape, fill, device=device)
    return out


def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module``'s parameters by name; the names and
    shapes must match exactly. BatchNorm's running statistics go to mean 0,
    variance 1."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            f"parameters differ: only in the module "
            f"{sorted(set(params) - set(weights))[:8]}, only in the weights "
            f"{sorted(set(weights) - set(params))[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: {tuple(p.shape)} against "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.zero_()
            elif name.endswith("running_var"):
                buf.fill_(1.0)
