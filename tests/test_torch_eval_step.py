"""The port's eval step against the JAX package's, on the CPU:
``VFDepthModel.forward(train=False, return_renders=True)`` against JAX
``forward(train=False, return_renders=True)`` (the body of
``build_eval_step``), jitted once, on the tiny config (``tpu.warp_window``
off) from the flax init with a pose-head bias of a real ego-motion and
BatchNorm running statistics of seeded random values (so that eval mode
reads something other than the identity), with JAX's tie-break noise handed
to the port.

Tolerances (all f32; the step tests' where they overlap):
* disparity, depth and the warped images: 1e-4 of their largest magnitude
  (sums in another order; the predict test's bound; measured 8e-7 and
  1e-5), the images where the two warped masks agree (a pixel whose mask
  flips holds a sample on one side only); poses 1e-5;
* the reprojection map where both auto-masks keep the pixel: 1e-3 of its
  largest value (SSIM amplifies the images' ~1e-6 differences some 30-fold,
  the step tests say; measured 2.2e-4);
* the warped masks (nearest picks) and the auto-mask: all but 0.05% of the
  pixels agree (a pick at a half-pixel, or a photometric tie, may fall
  either way; measured 1 of 147,456 and 8 of 73,728);
* loss and scalar logs: 2e-5 of their magnitude, 1e-3 for the four that
  average over the auto-mask;
* BatchNorm statistics: unchanged, exactly, on both sides.
``training/step.py eval_step`` is checked to give these outputs and the
scalar logs without a gradient.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers_torch_step import MASKED_LOGS, with_motion
from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.training import VFDepthModel, eval_step
from vfdepth_tpu_torch.weights import load_flax_params
from helpers_torch_threads import PORT_THREADS, port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
TINY = "configs/tiny_fake.yaml"
MASK_SHARE = 5e-4
RENDERS = ("temporal_img", "temporal_mask", "overlap_img", "overlap_mask",
           "reproj_map", "reproj_mask")


def _random_stats(stats):
    rng = np.random.RandomState(4)

    def draw(path, x):
        if jax.tree_util.keystr(path).endswith("'var']"):
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)
        return jnp.asarray(rng.normal(0.0, 0.1, x.shape), x.dtype)
    return jax.tree_util.tree_map_with_path(draw, stats)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jax_get_config(TINY), get_config(TINY)
    for cfg in (jcfg, tcfg):
        cfg.set("warp_window", False)
    ds = FakeDataset(num_samples=2, num_cams=jcfg.num_cams,
                     height=jcfg.height, width=jcfg.width,
                     fusion_level=jcfg.fusion_level, with_depth=True)
    batch = ds.batch([0, 1])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxModel(jcfg)
    params, stats = jm.init(jax.random.PRNGKey(0), jbatch)
    params, stats = with_motion(params), _random_stats(stats)
    rng = jax.random.PRNGKey(3)

    def fn(params, stats, batch, rng):
        outputs, (loss, logs), new_stats = jm.forward(
            params, stats, batch, rng, train=False, return_renders=True)
        key = jax.random.split(rng)[0]
        noise = []
        for _ in jm.scales:
            key, k1 = jax.random.split(key)
            noise.append(jax.random.normal(
                k1, (2, jm.num_cams, len(jm.frame_ids) - 1, jm.height,
                     jm.width, 1)))
        return (outputs, {k: v for k, v in logs.items() if v.ndim == 0},
                new_stats, jnp.stack(noise))

    want, jlogs, new_stats, noise = jax.tree_util.tree_map(
        np.asarray, jax.jit(fn)(params, stats, jbatch, rng))
    np_params, np_stats = jax.tree_util.tree_map(np.asarray, (params, stats))

    model = VFDepthModel(tcfg, device="cpu")
    load_flax_params(model, np_params, np_stats)
    before = {k: v.clone() for k, v in model.named_buffers()}
    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    try:
        with torch.no_grad():
            got, _, tlogs = model(batch, noise=torch.from_numpy(noise.copy()),
                                  train=False, return_renders=True)
    finally:
        torch.set_num_threads(threads)
    return dict(batch=batch, model=model, want=want, got=got, jlogs=jlogs,
                tlogs=tlogs, before=before, stats=(np_stats, new_stats))


def test_outputs_match_jax(pair):
    want, got = pair["want"], pair["got"]
    assert set(got) == {k for k, v in want.items() if v is not None}
    assert set(RENDERS) <= set(got)
    for key, w in want.items():
        g = got[key].numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), key
        if key.endswith("mask"):
            share = np.mean(g != w)
            assert share <= MASK_SHARE, (key, share)
            continue
        rel = 1e-4
        if key == "reproj_map":      # where both auto-masks keep the pixel
            keep = (got["reproj_mask"].numpy() > 0) & (
                want["reproj_mask"] > 0)
            g, w, rel = g * keep, w * keep, 1e-3
        elif key.endswith("_img"):   # where the two warped masks agree
            mask = key.replace("_img", "_mask")
            same = got[mask].numpy() == want[mask]
            g, w = g * same, w * same
        atol = 1e-5 if key == "cam_T_cam" else rel * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)


def test_logs_match_jax(pair):
    want = {k: float(v) for k, v in pair["jlogs"].items()}
    got = {k: float(v) for k, v in pair["tlogs"].items() if v.dim() == 0}
    assert set(got) == set(want)
    for key, w in want.items():
        tol = 1e-3 if key in MASKED_LOGS else 2e-5
        assert abs(got[key] - w) <= tol * max(abs(w), 1e-3), (key, got[key], w)


def test_batchnorm_statistics_untouched(pair):
    np_stats, new_stats = pair["stats"]
    for a, b in zip(jax.tree_util.tree_leaves(np_stats),
                    jax.tree_util.tree_leaves(new_stats)):
        assert np.array_equal(a, b)
    for name, value in pair["model"].named_buffers():
        assert torch.equal(value, pair["before"][name]), name


def test_eval_step(pair):
    model = pair["model"]
    outputs, logs = eval_step(model, pair["batch"],
                              torch.Generator().manual_seed(0),
                              return_renders=True)
    assert set(outputs) == set(pair["got"])
    assert all(v.dim() == 0 and not v.requires_grad for v in logs.values())
    assert not any(v.requires_grad for v in outputs.values())
    np.testing.assert_allclose(outputs["depth/0"].numpy(),
                               pair["got"]["depth/0"].numpy(), rtol=0,
                               atol=1e-6 * pair["got"]["depth/0"].abs().max()
                               .item())
    plain, _ = eval_step(model, pair["batch"], torch.Generator().manual_seed(0))
    assert not set(RENDERS) & set(plain)
    for name, value in model.named_buffers():
        assert torch.equal(value, pair["before"][name]), name
