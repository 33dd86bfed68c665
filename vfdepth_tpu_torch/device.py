"""Device choice for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU explicitly
(``device="cpu"``, as the tests do). With no CUDA device and no explicit
CPU request they raise: there is no silent CPU fallback, because a CPU run
of this model is a test, never a deployment.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
