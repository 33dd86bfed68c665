"""The ungrouped back-projection sampler (kernel K1b), its backward (K2b) and
the normalised grouped form of K1, against the JAX package, on the CPU.

On the CPU the port's entries run the kernels' plain PyTorch versions:
``sample_bilinear``, ``sample_bilinear_with_nearest_mask``,
``sample_backproject``, ``sample_backproject_raw`` and
``sample_backproject_grouped``, each held against the JAX entry of the same
name with ``_pallas`` (vfdepth_tpu/ops/pallas_sample.py):

* against the f32 XLA forms of the same functions (``ops/grid_sample.py``
  bilinear and nearest gathers, the validity gate and the rel column, group
  sums): the same f32 taps summed in the same order, 1e-5 of the largest
  input; nearest picks, validity and counts exact (the two pick rules,
  "fraction > 0.5" and round-half-even, differ only at exact ties, which
  these random inputs do not hit);
* against the Pallas kernels in interpret mode, which round features and
  tap weights to bf16 and emit bf16: forward atol 0.05, rtol 0.02, backward
  atol 0.05 of the largest entry and rtol 0.05, as tests/test_pallas_sample.py
  holds the kernel itself against the gathers; validity exact.

K2b (through autograd) against ``jax.vjp`` of the same forms, and in raw
mode against autograd of the port's own plain forward (the same f32
products summed in another order, 1e-5). Non-finite and huge coordinates,
points behind the camera and off the image are in every input.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vfdepth_tpu.ops.grid_sample import grid_sample_2d
from vfdepth_tpu.ops import pallas_sample as jps
from vfdepth_tpu_torch.ops import backproject_sample as tbs
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")

F32_TOL = 1e-5        # x max|input|
PALLAS_FWD = dict(atol=0.05, rtol=0.02)


def _norm_inputs(seed, b=2, h=16, w=24, c=8, n=700, special=True):
    """Features, a 0/1 mask with holes, normalised coordinates over and past
    the image (corners, non-finite and huge ones when ``special``) and a
    rel-depth column."""
    rng = np.random.RandomState(seed)
    img = rng.randn(b, h, w, c).astype(np.float32)
    mask = (rng.rand(b, h, w, 1) > 0.3).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (b, n, 2)).astype(np.float32)
    coords[:, :4] = [[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [1.0, -1.0]]
    if special:
        coords[:, 10, 0] = np.nan
        coords[:, 11, 1] = np.inf
        coords[:, 12] = [-np.inf, 0.0]
        coords[:, 13] = [1e30, 0.2]
    rel = rng.uniform(0.1, 2.0, (b, n)).astype(np.float32)
    return img, mask, coords, rel


def _xla_backproject(img, mask, coords, rel):
    """The f32 XLA form of the back-projection epilogue: ([feat, rel] *
    valid, valid) with valid = nearest mask > 0.5."""
    feat = grid_sample_2d(img, coords)
    m = grid_sample_2d(mask, coords, mode="nearest")[..., 0]
    valid = (m > 0.5).astype(img.dtype)
    return (jnp.concatenate([feat, rel[..., None]], axis=-1)
            * valid[..., None], valid)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=tol, err_msg=what)


def test_sample_bilinear_matches_xla_and_pallas():
    img, _, coords, _ = _norm_inputs(0)
    got = tbs.sample_bilinear(*_t(img, coords)).numpy()
    assert got.shape == coords.shape[:2] + img.shape[-1:]
    _close(got, grid_sample_2d(jnp.asarray(img), jnp.asarray(coords)),
           F32_TOL * np.abs(img).max())
    np.testing.assert_array_equal(got[:, 10:14], 0.0)   # dead points
    np.testing.assert_allclose(
        got, np.asarray(jps.sample_bilinear_pallas(jnp.asarray(img),
                                                   jnp.asarray(coords))),
        **PALLAS_FWD)


def test_sample_with_nearest_mask_matches_xla_and_pallas():
    img, mask, coords, _ = _norm_inputs(1)
    got = tbs.sample_bilinear_with_nearest_mask(*_t(img, mask, coords))
    got = got.numpy()
    assert got.shape[-1] == img.shape[-1] + 1
    ji, jm, jc = jnp.asarray(img), jnp.asarray(mask), jnp.asarray(coords)
    _close(got[..., :-1], grid_sample_2d(ji, jc), F32_TOL * np.abs(img).max())
    np.testing.assert_array_equal(
        got[..., -1], np.asarray(grid_sample_2d(jm, jc, mode="nearest"))[..., 0])
    want = np.asarray(jps.sample_bilinear_with_nearest_mask_pallas(ji, jm, jc),
                      np.float32)
    np.testing.assert_array_equal(got[..., -1], want[..., -1])
    np.testing.assert_allclose(got[..., :-1], want[..., :-1], **PALLAS_FWD)


def test_sample_backproject_matches_xla_and_pallas():
    img, mask, coords, rel = _norm_inputs(2)
    coords[:, 20:60] = -3.0       # caller-sanitised invalid points
    feat, valid = tbs.sample_backproject(*_t(img, mask, coords, rel))
    feat, valid = feat.numpy(), valid.numpy()
    want, want_valid = _xla_backproject(*map(jnp.asarray,
                                             (img, mask, coords, rel)))
    np.testing.assert_array_equal(valid, np.asarray(want_valid))
    assert 0 < valid.sum() < valid.size
    _close(feat, want, F32_TOL * np.abs(img).max())
    pf, pv = jps.sample_backproject_pallas(*map(jnp.asarray,
                                                (img, mask, coords, rel)))
    np.testing.assert_array_equal(valid, np.asarray(pv, np.float32))
    np.testing.assert_allclose(feat, np.asarray(pf, np.float32), **PALLAS_FWD)


def test_sample_backproject_invalid_points_give_exact_zeros():
    """A NaN rel-depth of an invalid point adds nothing (a select), and its
    NaN cotangent row reaches no gradient."""
    img, mask, coords, rel = _norm_inputs(3)
    coords[:, 20:60] = -3.0
    rel[:, 20:60] = np.nan
    f = torch.from_numpy(img).requires_grad_()
    feat, valid = tbs.sample_backproject(f, *_t(mask, coords, rel))
    assert torch.isfinite(feat).all()
    assert (feat[:, 20:60] == 0).all() and (valid[:, 20:60] == 0).all()
    g = torch.randn(feat.shape, generator=torch.Generator().manual_seed(0))
    g_nan = torch.where(valid[..., None] > 0, g, float("nan"))
    (dg_nan,) = torch.autograd.grad(feat, f, g_nan, retain_graph=True)
    (dg,) = torch.autograd.grad(feat, f, g)
    assert torch.isfinite(dg_nan).all()
    torch.testing.assert_close(dg_nan, dg, rtol=0, atol=0)


def _raw_inputs(seed, b=3, h=16, w=24, c=8, n=900):
    """Camera-plane points mixing in-image, behind-camera, near-zero-depth,
    off-image and non-finite cases (the model's raw mode)."""
    rng = np.random.RandomState(seed)
    img = rng.randn(b, h, w, c).astype(np.float32)
    mask = (rng.rand(b, h, w, 1) > 0.3).astype(np.float32)
    z = rng.uniform(-2.0, 10.0, (b, n)).astype(np.float32)
    z[:, :20] = rng.uniform(-1e-7, 1e-7, (b, 20))
    px = rng.uniform(-6, w + 6, (b, n)).astype(np.float32)
    py = rng.uniform(-6, h + 6, (b, n)).astype(np.float32)
    cam = np.stack([px * z, py * z, z], axis=-1)
    cam[:, 30:35, 0] = np.nan
    cam[:, 35:40, 1] = np.inf
    cam[:, 40:42, 2] = np.nan
    return img, mask, cam


def test_sample_backproject_raw_matches_pallas():
    img, mask, cam = _raw_inputs(4)
    rel_scale = 1.0 / 24.0
    feat, valid = tbs.sample_backproject_raw(*_t(img, mask, cam), rel_scale)
    pf, pv = jps.sample_backproject_raw_pallas(
        jnp.asarray(img), jnp.asarray(mask), jnp.asarray(cam), rel_scale)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(pv, np.float32))
    assert 0 < valid.sum() < valid.numel()
    # invalid points (non-finite depths included) give exact zeros
    assert torch.isfinite(feat).all()
    np.testing.assert_allclose(feat.numpy(), np.asarray(pf, np.float32),
                               **PALLAS_FWD)


@pytest.mark.parametrize("b,gs", [(1, 2), (2, 1)])
def test_sample_backproject_grouped_matches_xla_and_pallas(b, gs):
    img, mask, coords, rel = _norm_inputs(5 + gs, b=b * 2 * gs, n=500)
    coords[:, 20:60] = -3.0
    feat, cnt = tbs.sample_backproject_grouped(*_t(img, mask, coords, rel), b,
                                               gs)
    assert feat.shape == (b, 2, 500, img.shape[-1] + 1)
    pf, pc = jps.sample_backproject_grouped_pallas(
        *map(jnp.asarray, (img, mask, coords, rel)), b, gs)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(pc, np.float32))
    np.testing.assert_allclose(feat.numpy(), np.asarray(pf, np.float32),
                               **PALLAS_FWD)
    per_cam, valid = _xla_backproject(*map(jnp.asarray,
                                           (img, mask, coords, rel)))
    per_cam = np.asarray(per_cam).reshape((b, 2, gs) + per_cam.shape[1:])
    np.testing.assert_array_equal(
        cnt.numpy(), np.asarray(valid).reshape(b, 2, gs, -1).sum(2))
    _close(feat.numpy(), per_cam.sum(2), F32_TOL * np.abs(img).max())


def _port_grad(entry, img, args, g):
    f = torch.from_numpy(img).requires_grad_()
    out = entry(f, *args)
    out = out[0] if isinstance(out, tuple) else out
    (d,) = torch.autograd.grad(out, f, torch.from_numpy(g))
    return d.numpy()


def _check_grad(got, want, tol):
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _bwd_close_pallas(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0.05,
                               atol=0.05 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["bilinear", "mask", "backproject"])
def test_backward_matches_jax_vjp(mode):
    img, mask, coords, rel = _norm_inputs(10, special=False)
    if mode == "backproject":
        coords[:, 20:60] = -3.0
    n, c = coords.shape[1], img.shape[-1]
    rng = np.random.RandomState(11)
    ji, jm, jc, jr = map(jnp.asarray, (img, mask, coords, rel))
    if mode == "bilinear":
        g = rng.randn(2, n, c).astype(np.float32)
        got = _port_grad(tbs.sample_bilinear, img, _t(coords), g)
        xla = jax.vjp(lambda i: grid_sample_2d(i, jc), ji)[1](jnp.asarray(g))
        pal = jax.vjp(lambda i: jps.sample_bilinear_pallas(i, jc),
                      ji)[1](jnp.asarray(g))
    elif mode == "mask":
        g = rng.randn(2, n, c + 1).astype(np.float32)
        got = _port_grad(tbs.sample_bilinear_with_nearest_mask, img,
                         _t(mask, coords), g)
        xla = jax.vjp(lambda i: grid_sample_2d(i, jc), ji)[1](
            jnp.asarray(g[..., :-1]))
        pal = jax.vjp(lambda i: jps.sample_bilinear_with_nearest_mask_pallas(
            i, jm, jc), ji)[1](jnp.asarray(g))
    else:
        g = rng.randn(2, n, c + 1).astype(np.float32)
        got = _port_grad(tbs.sample_backproject, img, _t(mask, coords, rel), g)
        xla = jax.vjp(lambda i: _xla_backproject(i, jm, jc, jr)[0], ji)[1](
            jnp.asarray(g))
        pal = jax.vjp(lambda i: jps.sample_backproject_pallas(i, jm, jc, jr),
                      ji)[1]((jnp.asarray(g), jnp.zeros((2, n))))
    _check_grad(got, xla[0], F32_TOL)
    _bwd_close_pallas(got, pal[0])


def test_raw_backward_matches_pallas_and_plain_autograd():
    img, mask, cam = _raw_inputs(12)
    rel_scale = 0.5
    g = np.random.RandomState(13).randn(*cam.shape[:2], img.shape[-1] + 1)
    g = g.astype(np.float32)
    got = _port_grad(tbs.sample_backproject_raw, img, _t(mask, cam) +
                     [rel_scale], g)
    pal = jax.vjp(lambda i: jps.sample_backproject_raw_pallas(
        i, jnp.asarray(mask), jnp.asarray(cam), rel_scale),
        jnp.asarray(img))[1]((jnp.asarray(g), jnp.zeros(cam.shape[:2])))
    _bwd_close_pallas(got, pal[0])
    f = torch.from_numpy(img).requires_grad_()
    out, _ = tbs.sample2d_plain(f, torch.from_numpy(mask[..., 0]),
                                torch.from_numpy(cam), "backproject",
                                rel_scale, raw=True)
    (want,) = torch.autograd.grad(out, f, torch.from_numpy(g))
    _check_grad(got, want.numpy(), F32_TOL)


def test_grouped_normalised_backward_matches_pallas():
    b, gs = 1, 2
    img, mask, coords, rel = _norm_inputs(14, b=b * 2 * gs, n=500,
                                          special=False)
    coords[:, 20:60] = -3.0
    g = np.random.RandomState(15).randn(b, 2, 500, img.shape[-1] + 1)
    g = g.astype(np.float32)
    got = _port_grad(lambda f, *a: tbs.sample_backproject_grouped(f, *a, b,
                                                                  gs),
                     img, _t(mask, coords, rel), g)
    pal = jax.vjp(lambda i: jps.sample_backproject_grouped_pallas(
        i, *map(jnp.asarray, (mask, coords, rel)), b, gs),
        jnp.asarray(img))[1]((jnp.asarray(g), jnp.zeros((b, 2, 500))))
    _bwd_close_pallas(got, pal[0])
    xla = jax.vjp(lambda i: _xla_backproject(
        i, *map(jnp.asarray, (mask, coords, rel)))[0], jnp.asarray(img))[1](
        jnp.asarray(np.repeat(g, gs, axis=1).reshape(b * 2 * gs, 500, -1)))
    _check_grad(got, xla[0], F32_TOL)


def test_wrappers_take_plain_version_on_cpu():
    img, mask, coords, rel = (torch.from_numpy(a) for a in _norm_inputs(16))
    m = mask[..., 0].contiguous()
    c3 = torch.cat([coords, rel[..., None]], dim=-1)
    for mode, crd in (("bilinear", coords), ("mask", coords),
                      ("backproject", c3)):
        got, want = tbs.sample2d(img, m, crd, mode), tbs.sample2d_plain(
            img, m, crd, mode)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    g = torch.randn(2, coords.shape[1], img.shape[-1] + 1)
    valid = tbs.sample2d(img, m, c3, "backproject")[1]
    h, w, c = img.shape[1:]
    torch.testing.assert_close(
        tbs.sample2d_bwd(g, c3, valid, h, w, c),
        tbs.sample2d_bwd_plain(g, c3, valid, h, w, c), rtol=0, atol=0)
    assert tbs.sample2d.launches == 0 and tbs.sample2d_bwd.launches == 0


def test_wrappers_reject_bad_inputs():
    img, mask, coords, _ = (torch.from_numpy(a) for a in _norm_inputs(17))
    m = mask[..., 0].contiguous()
    with pytest.raises(ValueError, match="mode"):
        tbs.sample2d(img, m, coords, "nearest")
    with pytest.raises(ValueError, match="raw"):
        tbs.sample2d(img, m, coords, "mask", raw=True)
    with pytest.raises(ValueError, match="coords"):
        tbs.sample2d(img, m, coords, "backproject")      # needs 3 columns
    with pytest.raises(ValueError, match="mask"):
        tbs.sample2d(img, None, coords, "mask")
    with pytest.raises(TypeError):
        tbs.sample2d(img.double(), m, coords, "bilinear")
    with pytest.raises(ValueError):
        tbs.sample2d(img.to("meta"), None, coords.to("meta"), "bilinear")
    g = torch.zeros(2, coords.shape[1], 8)
    with pytest.raises(ValueError, match="shape"):
        tbs.sample2d_bwd(g[:, :5], coords, None, 16, 24, 8)
    with pytest.raises(ValueError):
        tbs.sample2d_bwd(g.to("meta"), coords.to("meta"), None, 16, 24, 8)
