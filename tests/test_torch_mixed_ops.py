"""The bf16 forms of the port's kernels (plain versions, on the CPU) against
the JAX functions they replace, and the ``sampler_3d`` rule.

* K4's bf16-update form (``sampler_3d: packed``) against ``jax.vjp`` of
  ``grid_sample_3d_packed(vol, coords, "bf16", "yxz")`` in interpret mode,
  with an f32 cotangent (an f32 config: the repaired fault) and with a bf16
  one (mixed precision). Where every point has its own base voxel each
  tap plane entry receives one addition, a single rounding of the same f32
  product in both, and the fold is the same f32 sum in the same order: the
  two agree exactly. Elsewhere the bf16 sums are taken in another order
  (``index_add_`` against XLA's sequential scatter), held to the bound
  tests/test_sample3d_packed.py holds bf16 against f32 updates: cosine
  above 0.9999, allclose at 2e-2. The f32-update form is shown to differ
  from JAX's bf16 updates (by bf16 roundings, ~2^-9 of a value).
* K3 with a bf16 volume against the same function's forward: both combine
  the bf16 tap rows in f32 in the same order and round once; one bf16 step
  (2^-7 of the largest value) covers an f32 difference that crosses a
  rounding boundary.
* K1 and K2 with bf16 features and cotangents against
  ``sample_backproject_grouped_raw_pallas`` in interpret mode: the Pallas
  kernel rounds tap weights and each camera's row to bf16 and sums the
  group in bf16, the port sums in f32 and rounds once; held at the bf16
  tolerance of tests/test_pallas_sample.py (3e-2), validity and counts
  exact.
* K5 with bf16 sources against JAX's CPU warp (``warp_image_mask_quad``),
  which computes in f32 from the same bf16 sources and returns f32: the
  port rounds its outputs to bf16 (half a bf16 step of values in [0, 1],
  2^-9), masks exact; the coordinate gradient through the bf16 ddx / ddy
  within 1e-2 of its largest entry.
* ``intensity_align`` on a bf16 warped image: f32 statistics, the warped
  image's dtype out; one bf16 step.
* K1b with bf16 features, in its four modes, against the Pallas entries
  (``sample_bilinear_pallas``, ``..._with_nearest_mask_pallas``,
  ``sample_backproject_pallas``, ``sample_backproject_raw_pallas``) in
  interpret mode, with non-finite and huge coordinates, NaN and inf depths
  and exact nearest-pick ties (pixel fraction 0.5, which both take
  downwards): the Pallas kernel rounds its tap weights to bf16, the port
  combines in f32 and rounds once, so features are held at the bf16
  tolerance above (3e-2); validity, the nearest mask value and the
  normalised rel column exact, the raw rel column (z * rel_scale, formed
  in f32 by both) within one bf16 step of each value. The port's one
  rounding is checked directly: its bf16 output is its f32 output (on the
  same bf16 values) rounded once, bit for bit.
* K2b with a bf16 cotangent, gated and ungated, with odd row widths,
  against ``jax.vjp`` of the same entries: the Pallas kernel's one-hot
  weights are bf16, its sums f32, its output rounded once; 3e-2 of the
  largest entry, as K2. The port's bf16 gradient is its f32 gradient of
  the same values rounded once, bit for bit.
* K4's f32-update form with a bf16 cotangent (``sampler_3d:
  packed_f32grad`` under mixed precision) against ``jax.vjp`` of
  ``grid_sample_3d_packed(vol, coords, "f32", "yxz")`` on a bf16 volume:
  exact where every point has its own base voxel (f32 products summed in
  JAX's order, one rounding); elsewhere the f32 sums differ by summation
  order alone, which one rounding to bf16 turns into at most one bf16 step
  of a value (2^-7 relative).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vfdepth_tpu.geometry.view_rendering import intensity_align as \
    jax_intensity_align
from vfdepth_tpu.ops import pallas_sample as jps
from vfdepth_tpu.ops.pallas_sample import (_fwd_call_grouped,
                                           sample_backproject_grouped_raw_pallas)
from vfdepth_tpu.ops.sample3d_packed import grid_sample_3d_packed
from vfdepth_tpu.ops.warp_quad import warp_image_mask_quad
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.geometry.view_rendering import intensity_align
from vfdepth_tpu_torch.ops import backproject_sample as tbs
from vfdepth_tpu_torch.ops.backproject_sample import (
    BackprojectGrouped, backproject_grouped, backproject_grouped_bwd,
    backproject_grouped_plain)
from vfdepth_tpu_torch.ops.sample3d import (
    Sample3dTrilinear, sample3d_trilinear, sample3d_trilinear_bwd,
    sample3d_trilinear_bwd_bf16, sample3d_trilinear_bwd_bf16_plain,
    sample3d_trilinear_bwd_plain)
from vfdepth_tpu_torch.ops.warp import warp_image_mask, warp_image_mask_maps
from vfdepth_tpu_torch.training.model import VFDepthModel

from test_torch_ops import _raw_inputs

jax.config.update("jax_platforms", "cpu")
BF = jnp.bfloat16
BF16_STEP = 2.0 ** -7


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_np(x):
    return _f32(jnp.asarray(x).astype(BF))


@pytest.mark.parametrize("mixed,sampler,want", [
    (False, None, "packed_f32grad"), (False, "packed", "packed"),
    (False, "packed_f32grad", "packed_f32grad"), (False, "gather", "gather"),
    (True, None, "packed"), (True, "packed", "packed"),
    (True, "packed_f32grad", "packed_f32grad")])
def test_sampler_3d_rule(mixed, sampler, want):
    """The JAX rule (training/model.py:177-182): bf16 updates for an
    explicit 'packed', in an f32 config too, and by default under mixed
    precision; 'packed_f32grad' under mixed precision takes f32 updates of
    the bf16 cotangent (K4's f32 form with a bf16 g)."""
    cfg = get_config("configs/tiny_fake.yaml")
    cfg.set("mixed_precision", mixed)
    cfg.set("sampler_3d", sampler)
    model = VFDepthModel(cfg, device="cpu")
    assert model.sampler_3d == want
    assert model.depth_net.fusion_net.bf16_updates == (want == "packed")
    assert model.compute_dtype == (torch.bfloat16 if mixed else None)


def test_mixed_precision_with_f32_updates_raises():
    """Of the f32-update samplers under mixed precision, 'packed_f32grad'
    builds and 'gather' (an XLA scatter of bf16 updates in the JAX
    package, not a TPU kernel) still raises."""
    cfg = get_config("configs/tiny_fake.yaml")
    cfg.set("mixed_precision", True)
    cfg.set("sampler_3d", "packed_f32grad")
    assert not VFDepthModel(cfg, device="cpu").depth_net.fusion_net.bf16_updates
    cfg.set("sampler_3d", "gather")
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        VFDepthModel(cfg, device="cpu")


VOL = (2, 5, 6, 4, 16)          # [B, y, x, z, C]


def _distinct_base_coords(seed, b=2):
    """One point per base voxel (the bases lie in [0, size-2] per axis),
    fractions away from the voxel edges: every tap plane entry receives at
    most one addition."""
    rng = np.random.RandomState(seed)
    _, h, w, d, _ = VOL
    n = (h - 1) * (w - 1) * (d - 1)
    base = np.stack([rng.permutation(n) for _ in range(b)])
    yb, xb, zb = (base // ((w - 1) * (d - 1)), (base // (d - 1)) % (w - 1),
                  base % (d - 1))
    pix = np.stack([xb, yb, zb], -1) + rng.uniform(0.1, 0.9, (b, n, 3))
    return (pix / (0.5 * (np.array([w, h, d]) - 1)) - 1.0).astype(np.float32)


def _random_coords(seed, n=400):
    """Points over and past the volume (~7 per base voxel, as in
    tests/test_sample3d_packed.py), one non-finite, one far out."""
    rng = np.random.RandomState(seed)
    coords = rng.uniform(-1.2, 1.2, (2, n, 3)).astype(np.float32)
    coords[:, 5, 1] = np.nan
    coords[:, 6] = [40.0, -1e9, 3.0]
    return coords


def _jax_bf16_updates(vol, coords, g):
    """dvol of ``grid_sample_3d_packed(.., "bf16", "yxz")`` (interpret)."""
    _, vjp = jax.vjp(lambda v: grid_sample_3d_packed(
        v, jnp.asarray(coords), "bf16", "yxz"), jnp.asarray(vol))
    return vjp(jnp.asarray(g))[0]


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.mark.parametrize("g_dtype", [jnp.float32, BF])
def test_k4_bf16_updates_match_jax(g_dtype):
    """f32 cotangent: an f32 config with ``sampler_3d: packed`` (the JAX
    package's bf16-update gradient, which the port's f32 accumulation
    missed); bf16 cotangent: mixed precision (bf16 volume, bf16 dvol)."""
    rng = np.random.RandomState(20)
    vol = rng.randn(*VOL).astype(np.float32)
    t_dtype = torch.float32 if g_dtype == jnp.float32 else torch.bfloat16
    for coords, exact in ((_distinct_base_coords(21), True),
                          (_random_coords(22), False)):
        g = jnp.asarray(rng.randn(2, coords.shape[1], VOL[-1]).astype(
            np.float32)).astype(g_dtype)
        want = _jax_bf16_updates(jnp.asarray(vol).astype(g_dtype), coords, g)
        assert want.dtype == g_dtype
        # through the autograd Function, as the model calls it
        v = torch.from_numpy(vol).to(t_dtype).requires_grad_()
        out = Sample3dTrilinear.apply(v, torch.from_numpy(coords), False, True)
        out.backward(torch.from_numpy(_f32(g)).to(t_dtype))
        got = v.grad
        assert got.dtype == t_dtype
        got, want = _f32(got.float().numpy()), _f32(want)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            assert _cosine(got, want) > 0.9999
            np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
        if g_dtype == jnp.float32:
            # the f32-update form is another function: it misses JAX's
            # bf16 roundings of the tap products
            f32_form = sample3d_trilinear_bwd_plain(
                torch.from_numpy(_f32(g)), torch.from_numpy(coords), VOL)
            assert np.abs(f32_form.numpy() - want).max() > 1e-4 * np.abs(
                want).max()


def test_k4_bf16_wrapper_takes_plain_version_on_cpu():
    coords = torch.from_numpy(_random_coords(23))
    g = torch.randn(2, coords.shape[1], VOL[-1]).to(torch.bfloat16)
    torch.testing.assert_close(
        sample3d_trilinear_bwd_bf16(g, coords, VOL),
        sample3d_trilinear_bwd_bf16_plain(g, coords, VOL), rtol=0, atol=0)
    with pytest.raises(TypeError):
        sample3d_trilinear_bwd_bf16(g.half(), coords, VOL)
    assert sample3d_trilinear_bwd_bf16.launches == 0


def test_k3_bf16_volume_matches_jax():
    rng = np.random.RandomState(24)
    vol = jnp.asarray(rng.randn(*VOL).astype(np.float32)).astype(BF)
    coords = _random_coords(25)
    want = grid_sample_3d_packed(vol, jnp.asarray(coords), "bf16", "yxz")
    assert want.dtype == BF
    got = sample3d_trilinear(torch.from_numpy(_f32(vol)).bfloat16(),
                             torch.from_numpy(coords))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _f32(want), rtol=0,
                               atol=BF16_STEP * np.abs(_f32(vol)).max())
    assert (got[:, 5:7] == 0).all()


@pytest.mark.parametrize("b,gs", [(1, 3), (2, 2)])
def test_k1_k2_bf16_match_pallas_interpret(b, gs):
    rel_scale = 1.0 / 24.0
    feats, mask, cam3 = _raw_inputs(30 + gs, b=b, gs=gs, n=1200)
    cams, h, w, c = feats.shape
    n = cam3.shape[1]
    fb = jnp.asarray(feats).astype(BF)
    feat_j, cnt_j = sample_backproject_grouped_raw_pallas(
        fb, jnp.asarray(mask[..., None]), jnp.asarray(cam3), rel_scale, b, gs)
    assert feat_j.dtype == BF
    _, valid_j = _fwd_call_grouped(
        fb.reshape(cams, h * w, c), jnp.asarray(cam3), jnp.asarray(mask), h,
        w, b, gs, raw=True, rel_scale=rel_scale)
    ft = torch.from_numpy(_f32(fb)).bfloat16().requires_grad_()
    out, valid = BackprojectGrouped.apply(
        ft, torch.from_numpy(mask), torch.from_numpy(cam3), rel_scale, b, gs)
    assert out.dtype == torch.bfloat16 and valid.dtype == torch.float32
    np.testing.assert_array_equal(out[..., -1].detach().float().numpy(),
                                  _f32(cnt_j))
    np.testing.assert_array_equal(valid.numpy(), _f32(valid_j)[..., 0])
    assert np.isfinite(out.float().detach().numpy()).all()
    np.testing.assert_allclose(out[..., :-1].float().detach().numpy(),
                               _f32(feat_j), atol=3e-2, rtol=3e-2)

    g = np.random.RandomState(gs).randn(b, 2, n, c + 2).astype(np.float32)
    g[..., -1] = 0.0                 # the valid column has no cotangent in JAX
    gb = jnp.asarray(g).astype(BF)
    _, vjp = jax.vjp(lambda f: sample_backproject_grouped_raw_pallas(
        f, jnp.asarray(mask[..., None]), jnp.asarray(cam3), rel_scale, b, gs),
        fb)
    (want,) = vjp((gb[..., :-1], jnp.zeros((b, 2, n), BF)))
    assert want.dtype == BF
    out.backward(torch.from_numpy(_f32(gb)).bfloat16())
    got = ft.grad
    assert got.dtype == torch.bfloat16
    want = _f32(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())


def test_k1_k2_bf16_wrappers_take_plain_version_on_cpu():
    feats, mask, cam3 = (torch.from_numpy(a) for a in _raw_inputs(33, n=300))
    fb = feats.bfloat16()
    args = (mask, cam3, 0.5, 1, 3)
    for a, r in zip(backproject_grouped(fb, *args),
                    backproject_grouped_plain(fb, *args)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    _, valid = backproject_grouped(fb, *args)
    g = torch.randn(1, 2, 300, feats.shape[-1] + 2).bfloat16()
    assert backproject_grouped_bwd(g, cam3, valid, *feats.shape[1:],
                                   3).dtype == torch.bfloat16
    assert backproject_grouped.launches_bf16 == 0
    assert backproject_grouped_bwd.launches_bf16 == 0


def _warp_inputs(seed, n_img=3, h=24, w=40):
    rng = np.random.RandomState(seed)
    img = _bf16_np(rng.rand(n_img, h, w, 3))
    mask = (rng.rand(n_img, h, w, 1) > 0.3).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (n_img, h * w, 2)).astype(np.float32)
    coords[:, :3, 0] = np.nan
    coords[:, 3:5] = [3e30, -3e30]
    return img, mask, coords


def test_k5_bf16_sources_match_jax_quad():
    img, mask, coords = _warp_inputs(40)
    want_img, want_mask = warp_image_mask_quad(
        jnp.asarray(img).astype(BF), jnp.asarray(mask).astype(BF),
        jnp.asarray(coords))
    ti = torch.from_numpy(img).bfloat16()
    tm = torch.from_numpy(mask).bfloat16()
    tc = torch.from_numpy(coords).requires_grad_()
    got_img, got_mask = warp_image_mask(ti, tm, tc)
    assert got_img.dtype == got_mask.dtype == torch.bfloat16
    np.testing.assert_allclose(got_img.detach().float().numpy(),
                               _f32(want_img), rtol=0, atol=2.0 ** -9)
    np.testing.assert_array_equal(got_mask.float().numpy(), _f32(want_mask))

    # a bf16-valued cotangent (JAX's quad warp returns f32, so its VJP
    # takes it as f32)
    cot = _bf16_np(np.random.RandomState(41).randn(*img.shape[:1],
                                                   coords.shape[1], 3))
    _, vjp = jax.vjp(lambda c: warp_image_mask_quad(
        jnp.asarray(img).astype(BF), jnp.asarray(mask).astype(BF), c)[0],
        jnp.asarray(coords))
    (want,) = vjp(jnp.asarray(cot))
    got_img.backward(torch.from_numpy(cot).bfloat16())
    want = _f32(want)
    assert tc.grad.dtype == torch.float32
    np.testing.assert_allclose(tc.grad.numpy(), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())
    assert warp_image_mask_maps.launches_bf16 == 0


def test_intensity_align_bf16_matches_jax():
    rng = np.random.RandomState(42)
    ref = _bf16_np(rng.rand(1, 6, 2, 16, 24, 3))
    warp = _bf16_np(rng.rand(1, 6, 2, 16, 24, 3) * 0.8)
    ref_mask = (rng.rand(1, 6, 2, 16, 24, 1) > 0.2).astype(np.float32)
    warp_mask = np.array(_bf16_np(rng.rand(1, 6, 2, 16, 24, 1) > 0.4))
    warp_mask[0, 1] = 0.0                   # a sample without overlap
    want = jax_intensity_align(jnp.asarray(ref).astype(BF),
                               jnp.asarray(ref_mask),
                               jnp.asarray(warp).astype(BF),
                               jnp.asarray(warp_mask).astype(BF))
    assert want.dtype == BF
    got = intensity_align(torch.from_numpy(ref).bfloat16(),
                          torch.from_numpy(ref_mask),
                          torch.from_numpy(warp).bfloat16(),
                          torch.from_numpy(warp_mask).bfloat16())
    assert got.dtype == torch.bfloat16
    want = _f32(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_STEP * np.abs(want).max())


# ---------------------------------------------------------- K1b / K2b bf16

K1B_H, K1B_W = 17, 33      # 0.5 * (size - 1) = 8, 16: exact pixel ties


def _k1b_inputs(seed, mode, c, raw=False, b=3, n=700):
    """bf16-valued features [b, h, w, c], a 0/1 mask with holes, and
    coordinates for ``mode``: normalised points over and past the image
    with corners, non-finite and huge ones, or (``raw``) camera-plane
    points behind the camera, off the image, at near-zero and non-finite
    depths; both with exact nearest-pick ties (pixel fraction 0.5 on one
    axis and on both)."""
    rng = np.random.RandomState(seed)
    h, w = K1B_H, K1B_W
    feats = _bf16_np(rng.randn(b, h, w, c))
    mask = (rng.rand(b, h, w) > 0.3).astype(np.float32)
    ties = np.array([[3.5, 4.0], [10.0, 7.5], [20.5, 11.5], [0.5, 0.5],
                     [w - 1.5, h - 1.5], [31.5, 2.0]], np.float32)
    if raw:
        z = rng.uniform(-2.0, 10.0, (b, n)).astype(np.float32)
        z[:, :20] = rng.uniform(-1e-7, 1e-7, (b, 20))
        px = rng.uniform(-6, w + 6, (b, n)).astype(np.float32)
        py = rng.uniform(-6, h + 6, (b, n)).astype(np.float32)
        coords = np.stack([px * z, py * z, z], axis=-1)
        coords[:, 30:35, 0] = np.nan
        coords[:, 35:40, 1] = np.inf
        coords[:, 40:42, 2] = np.nan
        coords[:, 42:44, 2] = -np.inf
        # z = 1: the divide by z + 1e-8 (= 1 in f32) keeps the tie exact
        coords[:, 50:56, :2] = ties
        coords[:, 50:56, 2] = 1.0
        return feats, mask, coords
    coords = rng.uniform(-1.3, 1.3, (b, n, 3 if mode == "backproject"
                                     else 2)).astype(np.float32)
    coords[:, :4, :2] = [[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [1.0, -1.0]]
    coords[:, 10, 0] = np.nan
    coords[:, 11, 1] = np.inf
    coords[:, 12, :2] = [-np.inf, 0.0]
    coords[:, 13, :2] = [1e30, 0.2]
    coords[:, 50:56, :2] = ties / (0.5 * (np.array([w, h]) - 1)) - 1.0
    if mode == "backproject":
        coords[:, 20:40, :2] = -3.0           # caller-sanitised points
        coords[:, :, 2] = rng.uniform(0.1, 2.0, (b, n))
    return feats, mask, coords


def _jax_k1b(mode, raw, fb, mask, coords, rel_scale):
    """The Pallas entry of ``mode`` (interpret mode) on bf16 features:
    [B, N, C (+1)] as the port's K1b lays it out, and the validity."""
    m4 = jnp.asarray(mask[..., None])
    if mode == "bilinear":
        return jps.sample_bilinear_pallas(fb, jnp.asarray(coords)), None
    if mode == "mask":
        return jps.sample_bilinear_with_nearest_mask_pallas(
            fb, m4, jnp.asarray(coords)), None
    if raw:
        return jps.sample_backproject_raw_pallas(fb, m4, jnp.asarray(coords),
                                                 rel_scale)
    return jps.sample_backproject_pallas(fb, m4, jnp.asarray(coords[..., :2]),
                                         jnp.asarray(coords[..., 2]))


@pytest.mark.parametrize("mode,raw,c", [
    ("bilinear", False, 8), ("mask", False, 6), ("backproject", False, 8),
    ("backproject", True, 7)])
def test_k1b_bf16_matches_pallas_interpret(mode, raw, c):
    rel_scale = 1.0 / 24.0 if raw else 1.0
    feats, mask, coords = _k1b_inputs(50 + c, mode, c, raw)
    fb = jnp.asarray(feats).astype(BF)
    want, want_valid = _jax_k1b(mode, raw, fb, mask, coords, rel_scale)
    assert want.dtype == BF
    tf = torch.from_numpy(feats).bfloat16()
    m = None if mode == "bilinear" else torch.from_numpy(mask)
    tc = torch.from_numpy(coords)
    out, valid = tbs.sample2d(tf, m, tc, mode, rel_scale, raw)
    assert out.dtype == torch.bfloat16
    assert out.shape == (3, coords.shape[1], c + (mode != "bilinear"))
    got = out.float().numpy()
    assert np.isfinite(got).all()
    want = _f32(want)
    if mode == "backproject":
        np.testing.assert_array_equal(valid.numpy(), _f32(want_valid))
        assert valid.dtype == torch.float32 and 0 < valid.sum() < valid.numel()
        if raw:
            np.testing.assert_allclose(got[..., -1], want[..., -1], rtol=BF16_STEP,
                                       atol=0)
        else:
            np.testing.assert_array_equal(got[..., -1], want[..., -1])
        feat_got, feat_want = got[..., :-1], want[..., :-1]
    elif mode == "mask":
        np.testing.assert_array_equal(got[..., -1], want[..., -1])
        feat_got, feat_want = got[..., :-1], want[..., :-1]
    else:
        feat_got, feat_want = got, want
    np.testing.assert_allclose(feat_got, feat_want, atol=3e-2, rtol=3e-2)
    # one rounding of the f32 combine, bit for bit
    ref, ref_valid = tbs.sample2d_plain(tf.float(), m, tc, mode, rel_scale,
                                        raw)
    torch.testing.assert_close(out, ref.to(torch.bfloat16), rtol=0, atol=0)
    if valid is not None:
        torch.testing.assert_close(valid, ref_valid, rtol=0, atol=0)


@pytest.mark.parametrize("mode,raw,c,gated", [
    ("bilinear", False, 7, False), ("mask", False, 8, False),
    ("backproject", False, 6, True), ("backproject", True, 8, True)])
def test_k2b_bf16_matches_pallas_vjp(mode, raw, c, gated):
    """Row widths C (+1): 7, 9, 7, 9 -- odd; the mask column's cotangent
    is read by neither."""
    rel_scale = 1.0 / 24.0 if raw else 1.0
    feats, mask, coords = _k1b_inputs(60 + c, mode, c, raw)
    fb = jnp.asarray(feats).astype(BF)
    n, ldg = coords.shape[1], c + (mode != "bilinear")
    g = _bf16_np(np.random.RandomState(61 + c).randn(3, n, ldg))
    gb = jnp.asarray(g).astype(BF)
    m4 = jnp.asarray(mask[..., None])

    def jax_out(f):
        out, _ = _jax_k1b(mode, raw, f, mask, coords, rel_scale)
        return out
    if mode == "backproject":
        def jax_out(f):      # noqa: F811 (the two-output entries)
            if raw:
                return jps.sample_backproject_raw_pallas(
                    f, m4, jnp.asarray(coords), rel_scale)
            return jps.sample_backproject_pallas(
                f, m4, jnp.asarray(coords[..., :2]),
                jnp.asarray(coords[..., 2]))
        cot = (gb, jnp.zeros((3, n), BF))
    else:
        cot = gb
    (want,) = jax.vjp(jax_out, fb)[1](cot)
    assert want.dtype == BF
    tf = torch.from_numpy(feats).bfloat16().requires_grad_()
    m = None if mode == "bilinear" else torch.from_numpy(mask)
    out, valid = tbs.Sample2d.apply(tf, m, torch.from_numpy(coords), mode,
                                    rel_scale, raw)
    assert (valid is not None) == gated
    out.backward(torch.from_numpy(g).bfloat16())
    got = tf.grad
    assert got.dtype == torch.bfloat16
    want = _f32(want)
    assert np.isfinite(got.float().numpy()).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())
    # one rounding of the f32 gradient, bit for bit
    ref = tbs.sample2d_bwd_plain(torch.from_numpy(g), torch.from_numpy(coords),
                                 valid, K1B_H, K1B_W, c, raw)
    torch.testing.assert_close(got, ref.to(torch.bfloat16), rtol=0, atol=0)


def test_k1b_k2b_bf16_wrappers_take_plain_version_on_cpu():
    feats, mask, coords = (torch.from_numpy(a) for a in _k1b_inputs(
        70, "backproject", 9, raw=True))
    fb = feats.bfloat16()
    out, valid = tbs.sample2d(fb, mask, coords, "backproject", 0.5, True)
    ref, ref_valid = tbs.sample2d_plain(fb, mask, coords, "backproject", 0.5,
                                        True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(valid, ref_valid, rtol=0, atol=0)
    g = torch.randn(out.shape).bfloat16()
    got = tbs.sample2d_bwd(g, coords, valid, K1B_H, K1B_W, 9, True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, tbs.sample2d_bwd_plain(
        g, coords, valid, K1B_H, K1B_W, 9, True), rtol=0, atol=0)
    with pytest.raises(TypeError):
        tbs.sample2d(feats.half(), mask, coords, "backproject", 0.5, True)
    assert tbs.sample2d.launches_bf16 == 0
    assert tbs.sample2d_bwd.launches_bf16 == 0


# ------------------------------------------- K4, f32 updates of a bf16 g

def _jax_f32_updates(vol, coords, g):
    """dvol of ``grid_sample_3d_packed(.., "f32", "yxz")`` (interpret)."""
    _, vjp = jax.vjp(lambda v: grid_sample_3d_packed(
        v, jnp.asarray(coords), "f32", "yxz"), jnp.asarray(vol))
    return vjp(jnp.asarray(g))[0]


def test_k4_f32_updates_of_bf16_cotangent_match_jax():
    rng = np.random.RandomState(80)
    vol = jnp.asarray(rng.randn(*VOL).astype(np.float32)).astype(BF)
    for coords, exact in ((_distinct_base_coords(81), True),
                          (_random_coords(82), False)):
        g = jnp.asarray(rng.randn(2, coords.shape[1], VOL[-1]).astype(
            np.float32)).astype(BF)
        want = _jax_f32_updates(vol, coords, g)
        assert want.dtype == BF
        # through the autograd Function, as the model calls it
        v = torch.from_numpy(_f32(vol)).bfloat16().requires_grad_()
        out = Sample3dTrilinear.apply(v, torch.from_numpy(coords), False,
                                      False)
        out.backward(torch.from_numpy(_f32(g)).bfloat16())
        got = v.grad
        assert got.dtype == torch.bfloat16
        got, want = got.float().numpy(), _f32(want)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                                       atol=1e-6 * np.abs(want).max())
            # JAX's bf16-update form is another function: its bf16 sums
            # round half of the values elsewhere (measured 57%), where the
            # order of the f32 sums may move a few (measured none: on the
            # CPU ``index_add_`` adds in XLA's scatter order)
            bf16_upd = _f32(_jax_bf16_updates(vol, coords, g))
            assert (bf16_upd != want).mean() > 0.3
            assert (got != want).mean() < 0.03


def test_k4_f32_update_wrapper_takes_plain_version_on_cpu():
    coords = torch.from_numpy(_random_coords(83))
    g = torch.randn(2, coords.shape[1], VOL[-1]).bfloat16()
    got = sample3d_trilinear_bwd(g, coords, VOL)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, sample3d_trilinear_bwd_plain(
        g, coords, VOL), rtol=0, atol=0)
    # the f32 sums of the f32 form, rounded once
    f32 = sample3d_trilinear_bwd_plain(g.float(), coords, VOL)
    np.testing.assert_allclose(got.float().numpy(), f32.numpy(),
                               rtol=2.0 ** -7, atol=1e-6 * f32.abs().max())
    assert sample3d_trilinear_bwd.launches_bf16 == 0
