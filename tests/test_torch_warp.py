"""K5 (image + mask warp) of the PyTorch port against the JAX package.

On the CPU the kernel wrapper runs its plain PyTorch version; its values
and the autograd Function's coordinate gradient are held against:

* ``warp_image_mask_quad`` (XLA gather form, f32): the same taps in another
  association, so values agree to 1e-6 and the coordinate gradient to 1e-5
  of its largest entry; the nearest mask is exact;
* ``warp_image_mask_mxu`` (the TPU kernel, Pallas interpret mode): it
  rounds sources and ddx / ddy to bf16, so the bounds are those of
  tests/test_warp_mxu.py: values 4e-3, gradient entries 2e-2 of the scale
  and a gradient cosine above 0.9995, masks exact.

Inputs mix in-image, out-of-image, exact-border, non-finite and huge
finite coordinates.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vfdepth_tpu.ops.warp_mxu import warp_image_mask_mxu
from vfdepth_tpu.ops.warp_quad import warp_image_mask_quad
from vfdepth_tpu_torch.ops.warp import (warp_image_mask, warp_image_mask_maps,
                                        warp_image_mask_maps_plain)
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
H, W = 32, 48


def _inputs(seed, b=2, n=None, bf16=False):
    rng = np.random.RandomState(seed)
    n = H * W if n is None else n
    img = rng.rand(b, H, W, 3).astype(np.float32)
    if bf16:   # bf16-representable sources: the MXU kernel rounds them
        img = np.array(jnp.asarray(img).astype(jnp.bfloat16)
                       .astype(jnp.float32))
    mask = (rng.rand(b, H, W, 1) > 0.3).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (b, n, 2)).astype(np.float32)
    coords[:, :5, 0] = np.nan
    coords[:, 5:8, 1] = np.inf
    coords[:, 8:10] = 1.0
    coords[:, 10:12] = -1.0
    coords[:, 12:14, 0] = 3e30          # huge but finite: clipped to 1e6 px
    coords[:, 14:16, 1] = -3e30
    cot = rng.randn(b, n, 3).astype(np.float32)
    return img, mask, coords, cot


def _port(img, mask, coords, cot):
    c = torch.from_numpy(coords).requires_grad_()
    img_w, mask_w = warp_image_mask(torch.from_numpy(img),
                                    torch.from_numpy(mask), c)
    (img_w * torch.from_numpy(cot)).sum().backward()
    return img_w.detach().numpy(), mask_w.numpy(), c.grad.numpy()


def _jax(fn, img, mask, coords, cot):
    (img_w, mask_w), vjp = jax.vjp(
        lambda c: fn(jnp.asarray(img), jnp.asarray(mask), c),
        jnp.asarray(coords))
    (g,) = vjp((jnp.asarray(cot), jnp.zeros_like(mask_w)))
    return np.asarray(img_w), np.asarray(mask_w), np.asarray(g)


@pytest.mark.parametrize("seed,n", [(0, None), (1, 1000)])
def test_warp_matches_quad(seed, n):
    img, mask, coords, cot = _inputs(seed, n=n)
    iq, mq, gq = _jax(warp_image_mask_quad, img, mask, coords, cot)
    ip, mp, gp = _port(img, mask, coords, cot)
    assert np.isfinite(ip).all() and np.isfinite(gp).all()
    np.testing.assert_allclose(ip, iq, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(mp, mq)
    np.testing.assert_allclose(gp, gq, rtol=0, atol=1e-5 * np.abs(gq).max())
    np.testing.assert_array_equal(gp[:, :8], 0.0)    # non-finite coords
    assert (ip[:, :8] == 0).all() and (mp[:, :8] == 0).all()


@pytest.mark.parametrize("seed", [2, 3])
def test_warp_matches_mxu_interpret(seed):
    img, mask, coords, cot = _inputs(seed, b=1, bf16=True)
    im, mm, gm = _jax(warp_image_mask_mxu, img, mask, coords, cot)
    ip, mp, gp = _port(img, mask, coords, cot)
    np.testing.assert_allclose(ip, im, atol=4e-3, rtol=4e-3)
    np.testing.assert_array_equal(mp, mm)
    scale = np.abs(gm).max()
    np.testing.assert_allclose(gp, gm, atol=2e-2 * scale, rtol=2e-2)
    cos = gp.ravel() @ gm.ravel() / (np.linalg.norm(gp) * np.linalg.norm(gm))
    assert cos > 0.9995, cos


def test_warp_maps_are_the_closed_form_derivatives():
    """ddx / ddy are d img_w / d pixel: finite differences of the plain
    version away from tap boundaries agree."""
    img, mask, coords, _ = _inputs(4, b=1, n=400)
    coords = np.clip(np.nan_to_num(coords), -0.9, 0.9)
    t = [torch.from_numpy(a) for a in (img, mask, coords)]
    img_w, _, ddx, ddy = warp_image_mask_maps_plain(*t)
    eps_px = 1e-3
    for axis, dd, size in ((0, ddx, W), (1, ddy, H)):
        shifted = t[2].clone()
        shifted[..., axis] += eps_px * 2.0 / (size - 1)
        img2 = warp_image_mask_maps_plain(t[0], t[1], shifted)[0]
        fd = (img2 - img_w) / eps_px
        # skip pixels whose shift crossed a tap boundary
        px = (t[2][..., axis] + 1.0) * 0.5 * (size - 1)
        keep = (torch.frac(px) < 1 - 2 * eps_px)[..., None].expand_as(fd)
        torch.testing.assert_close(fd[keep], dd[keep], rtol=0, atol=2e-2)


def test_warp_wrapper_takes_plain_version_on_cpu_and_checks_inputs():
    img, mask, coords, _ = (torch.from_numpy(a) for a in _inputs(5, n=300))
    before = warp_image_mask_maps.launches
    for a, b in zip(warp_image_mask_maps(img, mask, coords),
                    warp_image_mask_maps_plain(img, mask, coords)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert warp_image_mask_maps.launches == before
    with pytest.raises(TypeError):
        warp_image_mask_maps(img.double(), mask, coords)
    with pytest.raises(ValueError):
        warp_image_mask_maps(img[..., :2], mask, coords)
    with pytest.raises(ValueError):
        warp_image_mask_maps(img.to("meta"), mask.to("meta"),
                             coords.to("meta"))
