"""Trilinear frustum sampler (kernel K3).

Port of the forward of ``vfdepth_tpu/ops/sample3d_packed.py``
``grid_sample_3d_packed(vol, coords, grad_dtype, "yxz")`` (:257): the XLA
oct build + row gather + the TPU combine kernel ``_combine_kernel`` (:101,
launched by ``_combine_taps`` :117) become ONE direct 8-tap gather kernel,
``csrc/sample3d.cu``.

Semantics: align_corners=True, zeros padding; per axis the base is clamped
to [0, size-2] and both tap weights are rederived from the clamp offset
(``_kernel_axis_weights``), so every tap read is in bounds; non-finite
coordinates give zeros. Taps combine in the TPU kernel's order (dy fastest,
dz slowest).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_POINT_CHUNK = 1 << 18   # plain version: points per gather


def _axis_weights(coord: torch.Tensor, size: int):
    """Per-axis clamped base and the two tap weights (``_kernel_axis_weights``).
    The clamp of p to [-2, size+1] only keeps the int cast defined: any p
    outside [-1, size] already gives two zero weights."""
    p = torch.clamp((coord + 1.0) * 0.5 * (size - 1), -2.0, size + 1.0)
    p0 = torch.floor(p)
    t = p - p0
    i0 = p0.long()
    base = torch.clamp(i0, 0, size - 2)
    off = i0 - base
    is0 = (off == 0).to(coord.dtype)
    ism1 = (off == -1).to(coord.dtype)
    isp1 = (off == 1).to(coord.dtype)
    return base, (1 - t) * is0 + t * ism1, t * is0 + (1 - t) * isp1


def sample3d_trilinear_plain(vol: torch.Tensor,
                             coords: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version with explicit gathers.

    vol [B, H(y), W(x), D(z), C]; coords [B, N, 3] (x, y, z) in [-1, 1].
    Returns [B, N, C]. Chunks the points to bound its memory on the card.
    """
    nb, h, w, d, c = vol.shape
    n = coords.shape[1]
    rows = vol.reshape(nb, h * w * d, c)
    out = vol.new_empty(nb, n, c)
    # tap t = dz*4 + dx*2 + dy, in flat rows of the yxz volume
    offs = [(t & 1) * w * d + ((t >> 1) & 1) * d + ((t >> 2) & 1)
            for t in range(8)]
    for b in range(nb):
        for s in range(0, n, _POINT_CHUNK):
            crd = coords[b, s:s + _POINT_CHUNK]
            finite = torch.isfinite(crd).all(dim=-1, keepdim=True)
            crd = torch.where(finite, crd, -4.0)
            xb, wx0, wx1 = _axis_weights(crd[:, 0], w)
            yb, wy0, wy1 = _axis_weights(crd[:, 1], h)
            zb, wz0, wz1 = _axis_weights(crd[:, 2], d)
            wts = [wz0 * wx0 * wy0, wz0 * wx0 * wy1,
                   wz0 * wx1 * wy0, wz0 * wx1 * wy1,
                   wz1 * wx0 * wy0, wz1 * wx0 * wy1,
                   wz1 * wx1 * wy0, wz1 * wx1 * wy1]
            base = (yb * w + xb) * d + zb
            acc = rows[b, base + offs[0]] * wts[0][:, None]
            for t in range(1, 8):
                acc = acc + rows[b, base + offs[t]] * wts[t][:, None]
            out[b, s:s + _POINT_CHUNK] = acc
    return out


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("sample3d").vf_sample3d_trilinear
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def sample3d_trilinear(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a yxz volume [B, H, W, D, C] at coords [B, N, 3]
    -> [B, N, C] float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``sample3d_trilinear.launches`` counts launches) or raise.
    """
    if vol.dim() != 5 or coords.dim() != 3 or coords.shape[-1] != 3 \
            or coords.shape[0] != vol.shape[0]:
        raise ValueError(f"expected vol [B, H, W, D, C] and coords [B, N, 3], "
                         f"got {tuple(vol.shape)} and {tuple(coords.shape)}")
    nb, h, w, d, c = vol.shape
    if min(h, w, d) < 2:
        raise ValueError(f"every volume axis needs >= 2 samples: {(h, w, d)}")
    for name, t in (("vol", vol), ("coords", coords)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if coords.device != vol.device:
        raise ValueError(f"coords on {coords.device}, vol on {vol.device}")
    if vol.device.type == "cpu":
        return sample3d_trilinear_plain(vol, coords)
    if vol.device.type != "cuda":
        raise ValueError(f"unsupported device {vol.device}")
    for name, t in (("vol", vol), ("coords", coords)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = coords.shape[1]
    out = torch.empty(nb, n, c, device=vol.device)
    with torch.cuda.device(vol.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(vol.data_ptr(), coords.data_ptr(), out.data_ptr(),
                           nb, h, w, d, c, n, stream)
    if err != 0:
        raise RuntimeError(f"sample3d_trilinear launch failed: CUDA error {err}")
    sample3d_trilinear.launches += 1
    return out


sample3d_trilinear.launches = 0
