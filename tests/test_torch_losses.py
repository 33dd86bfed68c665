"""The port's losses against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both; gradients are
compared as vector-Jacobian products with the same random cotangent. The
inputs hold the ties a training step meets: a warped image equal to the
target (|0| in the L1 term: JAX's derivative of abs at 0 is +1), two
context frames with equal losses (the min over frames splits the gradient
1/2 : 1/2 in both), constant disparity patches (|0| in the smoothness
term). Everything is f32 and differs only in summation order: values 1e-5
of their magnitude, gradients 1e-4 of the largest entry (SSIM's moment
differences E[x^2] - mu^2 lose a few digits to cancellation). The auto-mask
and every other discrete decision must agree exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vfdepth_tpu.geometry.view_rendering import RenderOutputs as JRender
from vfdepth_tpu.losses import composite as jcomp
from vfdepth_tpu.losses import primitives as jprim
from vfdepth_tpu_torch.geometry.view_rendering import RenderOutputs
from vfdepth_tpu_torch.losses import composite as tcomp
from vfdepth_tpu_torch.losses import primitives as tprim
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
B, CAMS, H, W = 2, 3, 16, 24
FRAMES = (0, -1, 1)


def _vjp_jax(fn, args, cot):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _vjp_torch(fn, args, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(cot),
                                allow_unused=True)
    return out.detach().numpy(), [
        np.zeros_like(a) if g is None else g.numpy() for a, g in zip(args, grads)]


def _close(got, want, rel, what):
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _images(seed, shape):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32)
    b = rng.rand(*shape).astype(np.float32)
    b[..., :4, :6, :] = a[..., :4, :6, :]          # pred == target exactly
    return a, b


@pytest.mark.parametrize("name", ["ssim_loss", "photometric_loss"])
def test_image_primitives(name):
    pred, target = _images(0, (B, CAMS, H, W, 3))
    out_shape = (B, CAMS, H, W, 3 if name == "ssim_loss" else 1)
    cot = np.random.RandomState(1).randn(*out_shape).astype(np.float32)
    want, (gw, _) = _vjp_jax(getattr(jprim, name), (pred, target), cot)
    got, (gg, _) = _vjp_torch(getattr(tprim, name), (pred, target), cot)
    _close(got, want, 1e-5, name)
    _close(gg, gw, 1e-4, name + " grad")


def test_edge_aware_smoothness_and_normalised_disp():
    rng = np.random.RandomState(2)
    rgb = rng.rand(B, CAMS, H, W, 3).astype(np.float32)
    disp = rng.rand(B, CAMS, H, W, 1).astype(np.float32)
    disp[:, :, 2:6, 3:9] = 0.25                    # exact zero differences

    def jfn(r, d):
        return jprim.edge_aware_smoothness(r, jprim.mean_normalized_disp(d))

    def tfn(r, d):
        return tprim.edge_aware_smoothness(r, tprim.mean_normalized_disp(d))

    cot = np.float32(1.7)
    want, (_, gw) = _vjp_jax(jfn, (rgb, disp), cot)
    got, (_, gg) = _vjp_torch(tfn, (rgb, disp), np.asarray(cot))
    _close(got, want, 1e-5, "smoothness")
    _close(gg, gw, 1e-4, "smoothness grad")


def test_masked_mean():
    rng = np.random.RandomState(4)
    loss = rng.rand(B, CAMS, H, W, 1).astype(np.float32)
    mask = (rng.rand(B, CAMS, H, W, 1) > 0.5).astype(np.float32)
    cot = np.float32(0.7)
    want, (gw, _) = _vjp_jax(jprim.masked_mean, (loss, mask), cot)
    got, (gg, _) = _vjp_torch(tprim.masked_mean, (loss, mask),
                              np.asarray(cot))
    _close(got, want, 1e-6, "masked mean")
    _close(gg, gw, 1e-6, "masked mean grad")


def test_auto_mask_ties_go_to_reprojection():
    a = np.array([0.1, 0.2, 0.3], np.float32)
    b = np.array([0.2, 0.2, 0.1], np.float32)
    want = np.asarray(jprim.auto_mask(jnp.asarray(a), jnp.asarray(b)))
    got = tprim.auto_mask(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1.0, 1.0, 0.0])


def _loss_inputs(seed):
    rng = np.random.RandomState(seed)
    n_ctx = len(FRAMES) - 1
    colors = {f: rng.rand(B, CAMS, H, W, 3).astype(np.float32)
              for f in FRAMES}
    batch = {f"color/{f}/0": colors[f] for f in FRAMES}
    batch["mask"] = (rng.rand(B, CAMS, H, W, 1) > 0.1).astype(np.float32)
    t_img = rng.rand(B, CAMS, n_ctx, H, W, 3).astype(np.float32)
    t_img[:, :, 1, :6, :8] = t_img[:, :, 0, :6, :8]   # tied frames
    t_img[:, :, 0, 8:, 12:] = colors[0][:, :, 8:, 12:]  # warped == target
    t_mask = (rng.rand(B, CAMS, n_ctx, H, W, 1) > 0.2).astype(np.float32)
    o_img = rng.rand(B, CAMS, 1 + n_ctx, H, W, 3).astype(np.float32)
    o_mask = rng.randint(0, 3, (B, CAMS, 1 + n_ctx, H, W, 1)).astype(
        np.float32)
    disp = rng.uniform(0.05, 0.95, (B, CAMS, H, W, 1)).astype(np.float32)
    disp[:, :, 10:, :5] = 0.5
    depth = rng.uniform(1.0, 60.0, (B, CAMS, H, W, 1)).astype(np.float32)
    cam = np.tile(np.eye(4, dtype=np.float32), (B, CAMS, n_ctx, 1, 1))
    cam[..., :3, 3] = rng.randn(B, CAMS, n_ctx, 3) * 0.8   # |t| > the ceil
    return batch, t_img, t_mask, o_img, o_mask, disp, depth, cam


@pytest.mark.parametrize("cold_start", [
    None, dict(warmup_steps=4, ramp_steps=8),
    dict(warmup_steps=4, ramp_steps=8, stagger_ramps=True)])
def test_total_loss(cold_start):
    batch, t_img, t_mask, o_img, o_mask, disp, depth, cam = _loss_inputs(3)
    step = 9
    kw = cold_start or {}
    jcfg = jcomp.LossConfig(frame_ids=FRAMES, **kw)
    tcfg = tcomp.LossConfig(frame_ids=FRAMES, **kw)
    key = jax.random.PRNGKey(5)
    _, k1 = jax.random.split(key)
    noise = np.asarray(jax.random.normal(
        k1, (B, CAMS, len(FRAMES) - 1, H, W, 1)))[None]

    def jfn(t_img, o_img, disp, cam):
        r = JRender(t_img, jnp.asarray(t_mask), o_img, jnp.asarray(o_mask),
                    None, None)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        return jcomp.total_loss(key, jcfg, jb, {0: disp},
                                {0: jnp.asarray(depth)}, cam, {0: r},
                                step=jnp.int32(step))

    def tfn(t_img, o_img, disp, cam):
        r = RenderOutputs(t_img, torch.from_numpy(t_mask), o_img,
                          torch.from_numpy(o_mask))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        return tcomp.total_loss(torch.from_numpy(noise), tcfg, tb, {0: disp},
                                {0: torch.from_numpy(depth)}, cam, {0: r},
                                step=step)

    args = (t_img, o_img, disp, cam)
    jl, jlogs = jfn(*[jnp.asarray(a) for a in args])
    jgrads = jax.grad(lambda *a: jfn(*a)[0], argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a) for a in args])
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    tl, tlogs = tfn(*ts)
    tgrads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        ts, torch.autograd.grad(tl, ts, allow_unused=True))]

    assert set(tlogs) == set(jlogs)
    for k, w in jlogs.items():
        w = np.asarray(w)
        g = tlogs[k].detach().numpy()
        if k == "reproj_mask":
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, w, 1e-5, k)
    names = ("temporal_img", "overlap_img", "disp", "cam_t_cam")
    for name, gg, gw in zip(names, tgrads, jgrads):
        _close(gg.numpy(), np.asarray(gw), 1e-4, name)
    if cold_start:
        assert float(tlogs["cold_start/pose_prior"]) > 0
    # the ties were hit: the tied frames split their gradient
    assert np.abs(np.asarray(jgrads[0])[:, :, 1, :6, :8]).max() > 0


def test_cold_start_schedule():
    for kw in (dict(warmup_steps=10, ramp_steps=20),
               dict(warmup_steps=10, ramp_steps=20, stagger_ramps=True),
               dict(warmup_steps=0, ramp_steps=0)):
        jcfg = jcomp.LossConfig(**kw)
        tcfg = tcomp.LossConfig(**kw)
        for step in (0, 5, 10, 11, 25, 30, 45, 60, 100):
            want = jcomp.cold_start_schedule(jcfg, jnp.int32(step),
                                             jnp.float32)
            got = tcomp.cold_start_schedule(tcfg, step)
            for w, g in zip(want, got):
                assert (w is None) == (g is None)
                if w is not None:
                    assert float(g) == float(w), (kw, step)
