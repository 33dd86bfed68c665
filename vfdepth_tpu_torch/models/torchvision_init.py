"""ImageNet initialisation of the ResNet encoders from a local weight file
(port of ``vfdepth_tpu/models/torchvision_init.py``).

The published configs set ``weights_init: true`` (torchvision-pretrained
ResNet encoders, as the reference VFDepth). Nothing is fetched: the weights
come from a file on the disk, a torchvision state dict (``.pth``) or an
``.npz`` of the same keys, named by ``VFDEPTH_RESNET_WEIGHTS`` or found at
``assets/weights/resnet<N>_imagenet.npz``. With no file the encoders keep
their random init and a warning says so, as in the JAX package.

Unlike the JAX package, a file that exists but does not load, or lacks a
tensor the encoder needs, raises: the JAX loader warns and silently stays
random there, which trains another model than the config asks for.

Name map, torchvision -> ``models/resnet.py ResnetEncoder``: ``conv1`` ->
``conv1``; ``bn1`` -> ``bn1.bn``; ``layerS.B.convK`` / ``.bnK`` ->
``layerS_B.convK`` / ``.bnK.bn``; ``layerS.B.downsample.0`` / ``.1`` ->
``layerS_B.downsample_conv`` / ``.downsample_bn.bn``. BatchNorm takes
weight, bias, running_mean and running_var. A multi-image encoder (the pose
net's, 2 frames stacked on channels) gets conv1 tiled over its images and
divided by their number (the packnet / monodepth2 convention).
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

_STAGE_BLOCKS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3]}
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def find_resnet_weights(num_layers: int = 18) -> Optional[str]:
    """The weight file the loader would read, or None: the
    ``VFDEPTH_RESNET_WEIGHTS`` file (None if it names no file), else the
    repository's ``assets/weights/resnet<N>_imagenet.npz``."""
    env = os.environ.get("VFDEPTH_RESNET_WEIGHTS", "")
    if env:
        return env if os.path.isfile(env) else None
    default = os.path.join(REPO_ROOT, "assets", "weights",
                           f"resnet{num_layers}_imagenet.npz")
    return default if os.path.isfile(default) else None


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The file's tensors as numpy arrays; raises if it does not load."""
    try:
        if path.endswith(".npz"):
            with np.load(path) as f:
                return {k: f[k] for k in f.files}
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.numpy() for k, v in sd.items()}
    except Exception as e:
        raise ValueError(f"could not load ResNet weights from {path}: "
                         f"{e}") from e


def _encoder_tensors(sd: Dict[str, np.ndarray], num_layers: int,
                     num_input_images: int, blocks_with_down) -> Dict:
    """Port tensor name -> array, for every tensor the file sets."""
    def take(key):
        if key not in sd:
            raise KeyError(f"ResNet weight file lacks {key!r}")
        return sd[key]

    def bn(dst, src):
        return {f"{dst}.{leaf}": take(f"{src}.{leaf}")
                for leaf in _BN_LEAVES}

    conv1 = take("conv1.weight")
    if num_input_images > 1:
        conv1 = np.concatenate([conv1] * num_input_images,
                               axis=1) / num_input_images
    out = {"conv1.weight": conv1, **bn("bn1.bn", "bn1")}
    n_convs = 3 if num_layers == 50 else 2
    for stage, n_blocks in enumerate(_STAGE_BLOCKS[num_layers]):
        for blk in range(n_blocks):
            t = f"layer{stage + 1}.{blk}"
            p = f"layer{stage + 1}_{blk}"
            for ci in range(1, n_convs + 1):
                out[f"{p}.conv{ci}.weight"] = take(f"{t}.conv{ci}.weight")
                out.update(bn(f"{p}.bn{ci}.bn", f"{t}.bn{ci}"))
            if p in blocks_with_down:
                out[f"{p}.downsample_conv.weight"] = take(
                    f"{t}.downsample.0.weight")
                out.update(bn(f"{p}.downsample_bn.bn", f"{t}.downsample.1"))
    return out


def load_resnet_encoder_params(encoder: nn.Module, num_layers: int = 18,
                               num_input_images: int = 1,
                               weights_path: Optional[str] = None) -> bool:
    """Overwrite a ``ResnetEncoder``'s convolutions and BatchNorm
    parameters and statistics, in place, with the torchvision weights of
    ``weights_path`` (default: ``find_resnet_weights``). Returns whether a
    file was loaded: with none it warns and leaves the encoder as it is.
    Raises if the file does not load, lacks a tensor or has a misshapen
    one."""
    weights_path = weights_path or find_resnet_weights(num_layers)
    if not weights_path or not os.path.isfile(weights_path):
        warnings.warn(
            "weights_init requested but no pretrained ResNet weights found: "
            "set VFDEPTH_RESNET_WEIGHTS to a torchvision state-dict .pth or "
            ".npz, or put assets/weights/resnet*_imagenet.npz in the "
            "repository; using random initialization")
        return False
    sd = _load_state_dict(weights_path)
    blocks_with_down = {name for names in encoder.blocks for name in names
                        if getattr(encoder, name).has_down}
    tensors = _encoder_tensors(sd, num_layers, num_input_images,
                               blocks_with_down)
    state = encoder.state_dict()
    for name, value in tensors.items():
        target = state[name]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"ResNet weight {name} {value.shape} does not "
                             f"fit the encoder's {tuple(target.shape)}")
    with torch.no_grad():
        for name, value in tensors.items():
            state[name].copy_(torch.from_numpy(np.asarray(value)))
    return True
