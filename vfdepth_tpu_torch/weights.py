"""Parameters of the port: seeded random init, and the JAX package's flax
parameters carried over.

``load_flax_params`` takes the flax trees as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, ...)`` on the JAX side), so this
module needs no JAX. The port's module names follow the flax tree, so a
leaf maps by its path with three renames (``Conv_0`` -> ``conv``,
``BatchNorm_0`` -> ``bn``, ``Dense_0`` -> ``dense``) and these leaf rules:

* conv kernel HWIO -> OIHW; Dense kernel [I, O] -> [O, I];
* BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
  running_var;
* ``BEVFold.kernel`` / ``kernel_rel`` -> ``weight`` / ``weight_rel``.

It raises if a flax leaf finds no port tensor, or if a port parameter or
buffer is left unset. ``load_optax_adam_state`` carries an optax Adam state
over onto ``torch.optim.Adam`` by the same paths.
"""
from __future__ import annotations

import math
from typing import Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_MODULE_RENAME = {"Conv_0": "conv", "BatchNorm_0": "bn", "Dense_0": "dense"}
_LEAF_RENAME = {"kernel": "weight", "kernel_rel": "weight_rel",
                "scale": "weight",
                "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_name(path: Tuple[str, ...]) -> str:
    mods = [_MODULE_RENAME.get(p, p) for p in path[:-1]]
    return ".".join(mods + [_LEAF_RENAME.get(path[-1], path[-1])])


def _to_torch_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf in ("kernel", "kernel_rel") and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)      # HWIO -> OIHW
    if leaf == "kernel" and value.ndim == 2:
        return value.T                          # Dense [I, O] -> [O, I]
    return value


def load_flax_params(model: nn.Module, params: Mapping,
                     batch_stats: Mapping) -> None:
    """Copy flax ``params`` / ``batch_stats`` trees (nested dicts of numpy
    arrays, keyed like the port's submodules, e.g. {'depth_net': ...,
    'pose_net': ...} for ``VFDepthModel``) into ``model`` in place."""
    state = {k: v for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    unset = set(state)
    unused = []
    for tree in (params, batch_stats):
        for path, value in _leaves(tree):
            name = _torch_name(path)
            if name not in state:
                unused.append("/".join(path))
                continue
            target = state[name]
            value = _to_torch_layout(path[-1], value)
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{'/'.join(path)} {value.shape} does not fit "
                                 f"{name} {tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.tensor(value))
            unset.discard(name)
    if unused or unset:
        raise ValueError(f"flax leaves without a port tensor: {sorted(unused)}; "
                         f"port tensors left unset: {sorted(unset)}")


def _find_adam_state(opt_state):
    """optax's ``ScaleByAdamState`` (anything with ``mu``, ``nu`` and
    ``count``) inside an optax state, which may nest it in tuples."""
    if all(hasattr(opt_state, k) for k in ("mu", "nu", "count")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _find_adam_state(part)
            if found is not None:
                return found
    return None


def load_optax_adam_state(optimizer: torch.optim.Optimizer, model: nn.Module,
                          opt_state) -> None:
    """Set ``optimizer``'s Adam state from an optax Adam state (numpy
    leaves): ``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq``, ``count`` ->
    ``step`` (the updates made so far, which bias correction counts), each
    moment tree keyed like the flax params and carried over with the same
    paths and layouts as ``load_flax_params``. Raises unless every
    parameter of the optimizer gets both moments."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no optax Adam state (mu, nu, count) found")
    params = dict(model.named_parameters())
    moments: dict = {}
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for path, value in _leaves(tree):
            name = _torch_name(path)
            if name not in params:
                raise ValueError(f"optax leaf {'/'.join(path)} has no port "
                                 f"parameter ({name})")
            p = params[name]
            value = _to_torch_layout(path[-1], value)
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{'/'.join(path)} {value.shape} does not fit "
                                 f"{name} {tuple(p.shape)}")
            moments.setdefault(id(p), {})[key] = torch.tensor(
                np.ascontiguousarray(value), dtype=p.dtype, device=p.device)
    count = float(np.asarray(adam.count))
    for group in optimizer.param_groups:
        for p in group["params"]:
            m = moments.get(id(p), {})
            if set(m) != {"exp_avg", "exp_avg_sq"}:
                raise ValueError("the optax state leaves an optimizer "
                                 "parameter without its moments")
            optimizer.state[p] = {"step": torch.tensor(count), **m}


def init_random(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init in the flax defaults' family: conv / linear
    weights normal with std 1/sqrt(fan_in) (LeCun), biases 0, BatchNorm at
    identity (running mean 0, var 1). Draws on the CPU from ``generator``,
    so a seed gives the same weights on every device."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or p.dim() == 1:
                p.copy_(torch.ones_like(p) if name.endswith("bn.weight")
                        else torch.zeros_like(p))
                continue
            fan_in = math.prod(p.shape[1:])
            if name.endswith("weight_rel"):
                # the rel-depth slice of BEVFold's conv keeps the JOINT
                # conv's fan-in (its siblings' channels included)
                fan_in += math.prod(model.get_parameter(
                    name[:-len("_rel")]).shape[1:])
            w = torch.empty(p.shape).normal_(0.0, 1.0 / math.sqrt(fan_in),
                                             generator=generator)
            p.copy_(w)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.zero_()
            elif name.endswith("running_var"):
                buf.fill_(1.0)

