"""Gather-based 2-D grid sampling (port of ``vfdepth_tpu/ops/grid_sample.py``
``grid_sample_2d``), for the depth-synthesis warp (``warp_depth``).

Not a TPU kernel: the JAX package computes it with XLA gathers, and this
plain PyTorch version is its port on every device. Its rules are JAX's, not
the image warp's (kernel K5, ``ops/warp.py``), which is why ``warp_depth``
does not call K5:

* ``align_corners=True`` unnormalisation, zero padding per tap;
* non-finite coordinates are replaced by -2.0 (every tap outside) and
  reported by the optional finite mask; finite coordinates are not clipped;
* nearest rounds half to even (``jnp.round``; ``torch.round`` does too);
* the bilinear weights are ``x - floor(x)``, so the gradient reaches the
  coordinates as well as the sampled map, as XLA's autodiff gives it.

``F.grid_sample`` is not used: its handling of non-finite coordinates is
another.
"""
from __future__ import annotations

import torch


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> [0, size-1] pixel coordinates (align_corners=True)."""
    return (coord + 1.0) * 0.5 * (size - 1)


def grid_sample_2d(img: torch.Tensor, coords: torch.Tensor,
                   mode: str = "bilinear", with_finite_mask: bool = False):
    """Sample ``img`` [..., H, W, C] at normalised ``coords`` [..., *pts, 2]
    ((x, y) in [-1, 1]; leading dims equal img's batch dims) -> [..., *pts,
    C], and with ``with_finite_mask`` also a [..., *pts, 1] mask in img's
    dtype, 0 where a coordinate was non-finite. ``mode``: "bilinear" or
    "nearest"."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unknown mode {mode!r}")
    batch_shape = tuple(img.shape[:-3])
    h, w, c = img.shape[-3:]
    nb = len(batch_shape)
    if tuple(coords.shape[:nb]) != batch_shape:
        raise ValueError(f"batch mismatch {tuple(img.shape)} vs "
                         f"{tuple(coords.shape)}")
    pts_shape = tuple(coords.shape[nb:-1])
    flat_img = img.reshape(-1, h * w, c)
    cf = coords.reshape(flat_img.shape[0], -1, 2)

    finite = torch.isfinite(cf).all(dim=-1)                       # [b, n]
    cf = torch.where(finite[..., None], cf, -2.0)
    x = _unnormalize(cf[..., 0], w)
    y = _unnormalize(cf[..., 1], h)

    def tap(ix, iy, weight):
        # ix, iy: integral floats; the bounds test in float equals JAX's
        # int32 test (a coordinate too large for int32 is out either way)
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()
        vals = torch.gather(flat_img, 1, idx[..., None].expand(
            idx.shape + (c,)))
        return vals * (weight * valid.to(img.dtype))[..., None]

    if mode == "nearest":
        out = tap(torch.round(x), torch.round(y), torch.ones_like(x))
    else:
        x0, y0 = torch.floor(x), torch.floor(y)
        wx = (x - x0).to(img.dtype)
        wy = (y - y0).to(img.dtype)
        out = (tap(x0, y0, (1 - wx) * (1 - wy))
               + tap(x0 + 1, y0, wx * (1 - wy))
               + tap(x0, y0 + 1, (1 - wx) * wy)
               + tap(x0 + 1, y0 + 1, wx * wy))
    out = out.reshape(batch_shape + pts_shape + (c,))
    if with_finite_mask:
        return out, finite.to(img.dtype).reshape(batch_shape + pts_shape
                                                 + (1,))
    return out
