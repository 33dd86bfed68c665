"""View rendering of the port against the JAX package, on the CPU.

``relative_cam_poses``, ``project_coords`` (``backproject`` + ``reproject``)
and the dense ``render_views`` (JAX ``warp_op="quad"``, no windows) on the
fake 6-camera rig at 32x48 with a random depth and ego-motion, through the
port's plain warp (K5's plain version). All f32: poses and coordinates
1e-5 of their magnitude (einsums in another order), warped images and
masks, intensity-aligned, 1e-4 of their magnitude with the masks exact
(a coordinate within ~1e-6 of a tap boundary or of the image border would
flip a mask; these inputs have none), gradients of a random projection of
the outputs with respect to depth and poses 1e-4 of the largest entry.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.geometry import pose as jpose
from vfdepth_tpu.geometry import projection as jproj
from vfdepth_tpu.geometry import view_rendering as jvr
from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu_torch.geometry import pose as tpose
from vfdepth_tpu_torch.geometry import projection as tproj
from vfdepth_tpu_torch.geometry import view_rendering as tvr
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
H, W = 32, 48
FRAMES = (0, -1, 1)


def _close(got, want, rel, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def _scene(seed, b=1):
    rng = np.random.RandomState(seed)
    ds = FakeDataset(num_samples=b, height=H, width=W)
    batch = ds.batch(list(range(b)))
    rel_cam = jax_get_config("configs/tiny_fake.yaml").rel_cam_array
    depth = rng.uniform(2.0, 30.0, (b, 6, H, W, 1)).astype(np.float32)
    cam = np.tile(np.eye(4, dtype=np.float32), (b, 6, 2, 1, 1))
    ang = rng.randn(b, 6, 2) * 0.01
    cam[..., 0, 0] = cam[..., 1, 1] = np.cos(ang)
    cam[..., 0, 1], cam[..., 1, 0] = -np.sin(ang), np.sin(ang)
    cam[..., :3, 3] = rng.randn(b, 6, 2, 3) * 0.3
    return batch, rel_cam, depth, cam.astype(np.float32)


def test_relative_cam_poses_and_project_coords():
    batch, rel_cam, depth, cam = _scene(0)
    e, ei = batch["extrinsics"], batch["extrinsics_inv"]
    js, jst = jpose.relative_cam_poses(jnp.asarray(e), jnp.asarray(ei),
                                       jnp.asarray(cam), jnp.asarray(rel_cam))
    ts, tst = tpose.relative_cam_poses(torch.from_numpy(e), torch.from_numpy(ei),
                                       torch.from_numpy(cam),
                                       torch.from_numpy(rel_cam).long())
    _close(ts.numpy(), np.asarray(js), 1e-5, "spatio")
    _close(tst.numpy(), np.asarray(jst), 1e-5, "spatio_tempo")
    k, ik = batch["K/0"], batch["inv_K/0"]
    want = jproj.project_coords(jnp.asarray(depth), jnp.asarray(js[:, :, 0]),
                                jnp.asarray(ik), jnp.asarray(k))
    got = tproj.project_coords(torch.from_numpy(depth), ts[:, :, 0],
                               torch.from_numpy(ik), torch.from_numpy(k))
    assert got.shape == (1, 6, H, W, 2)
    _close(got.numpy(), np.asarray(want), 1e-5, "coords")


@pytest.mark.parametrize("align", [True, False])
def test_render_views_matches_jax(align):
    batch, rel_cam, depth, cam = _scene(1)
    colors = {f: batch[f"color/{f}/0"] for f in FRAMES}
    mask = batch["mask"].copy()
    mask[:, :, :5, :7] = 0.0          # a self-occlusion patch
    e, ei = batch["extrinsics"], batch["extrinsics_inv"]
    k, ik = batch["K/0"], batch["inv_K/0"]
    rng = np.random.RandomState(2)
    cot_t = rng.randn(1, 6, 2, H, W, 3).astype(np.float32)
    cot_o = rng.randn(1, 6, 3, H, W, 3).astype(np.float32)

    def jfn(depth, cam):
        sp, st = jpose.relative_cam_poses(jnp.asarray(e), jnp.asarray(ei), cam,
                                          jnp.asarray(rel_cam))
        r = jvr.render_views({f: jnp.asarray(c) for f, c in colors.items()},
                             jnp.asarray(mask), jnp.asarray(k),
                             jnp.asarray(ik), depth, cam, sp, st,
                             jnp.asarray(rel_cam), FRAMES,
                             do_intensity_align=align, warp_op="quad")
        proj = (jnp.sum(r.temporal_img * cot_t)
                + jnp.sum(r.overlap_img * cot_o))
        return proj, r

    def tfn(depth, cam):
        sp, st = tpose.relative_cam_poses(
            torch.from_numpy(e), torch.from_numpy(ei), cam,
            torch.from_numpy(rel_cam).long())
        r = tvr.render_views({f: torch.from_numpy(c) for f, c in colors.items()},
                             torch.from_numpy(mask), torch.from_numpy(k),
                             torch.from_numpy(ik), depth, cam, sp, st,
                             torch.from_numpy(rel_cam), FRAMES,
                             do_intensity_align=align)
        proj = ((r.temporal_img * torch.from_numpy(cot_t)).sum()
                + (r.overlap_img * torch.from_numpy(cot_o)).sum())
        return proj, r

    (_, jr), jgrads = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(depth), jnp.asarray(cam))
    td = torch.tensor(depth, requires_grad=True)
    tc = torch.tensor(cam, requires_grad=True)
    proj, tr = tfn(td, tc)
    proj.backward()

    for field in ("temporal_img", "overlap_img"):
        _close(getattr(tr, field).detach().numpy(),
               np.asarray(getattr(jr, field)), 1e-4, field)
    for field in ("temporal_mask", "overlap_mask"):
        np.testing.assert_array_equal(getattr(tr, field).numpy(),
                                      np.asarray(getattr(jr, field)),
                                      err_msg=field)
    assert 0 < np.asarray(jr.overlap_mask).mean() < 1
    _close(td.grad.numpy(), np.asarray(jgrads[0]), 1e-4, "d depth")
    _close(tc.grad.numpy(), np.asarray(jgrads[1]), 1e-4, "d cam_T_cam")


def test_intensity_align_passes_through_empty_overlap():
    rng = np.random.RandomState(3)
    ref = rng.rand(2, 8, 8, 3).astype(np.float32)
    img = rng.rand(2, 8, 8, 3).astype(np.float32)
    ref_m = np.ones((2, 8, 8, 1), np.float32)
    w_m = rng.randint(0, 2, (2, 8, 8, 1)).astype(np.float32)
    w_m[1] = 0.0                                   # no overlap in sample 1
    args = [ref, ref_m, img, w_m]
    want = np.asarray(jvr.intensity_align(*[jnp.asarray(a) for a in args]))
    got = tvr.intensity_align(*[torch.from_numpy(a) for a in args]).numpy()
    _close(got, want, 1e-5, "aligned")
    np.testing.assert_array_equal(got[1], img[1])


def test_render_views_rejects_depth_synthesis():
    """The depth-synthesis branch needs the extrinsics, the rotated
    extrinsics and the rotated views' depth; without them it raises
    (tests/test_torch_synthesis_modules.py holds the branch against JAX)."""
    batch, rel_cam, depth, cam = _scene(4)
    with pytest.raises(ValueError, match="aug_depth"):
        tvr.render_views({f: torch.from_numpy(batch[f"color/{f}/0"])
                          for f in FRAMES}, torch.from_numpy(batch["mask"]),
                         torch.from_numpy(batch["K/0"]),
                         torch.from_numpy(batch["inv_K/0"]),
                         torch.from_numpy(depth), torch.from_numpy(cam),
                         None, None, torch.from_numpy(rel_cam), FRAMES,
                         aug_depth=True)
