"""The warp windows (``tpu.warp_window``, the JAX package's default) of the
JAX package and of the port, on the CPU.

JAX's ``tpu.warp_window: true`` sizes static windows around the pixels that
can see a neighbouring camera (``configure_warp_window``) and warps only
inside them. Here JAX sizes real windows and runs its windowed step once,
in a module fixture; the port runs, from the same weights, batch and
tie-break noise, its dense step (``warp_window: false``: C2, the dense loss
against JAX's windowed one) and its windowed step (windows sized by
``create_train_state`` from the batch, as JAX's are).

``presets.micro_config`` on ``FakeDataset``'s "nuscenes" rig at 128x256
and a focal-length scale of 15 (depths ~10 m, ego-motion 0.2-0.6 m): on
this canvas JAX sizes spatial windows of ((128, 128), (48, 64)) and
spatio-temporal ones of ((128, 192), (16, 64)), a fraction of the image
(at the micro config's own 32x64 every window is the whole image and JAX
warps densely). The step's ``warp_window_overflow`` is 0: no pixel that
sees a neighbour falls outside its window.

Tolerances, port against JAX, as tests/test_torch_three_cam.py holds the
same rig's dense step, for its reasons: the auto-masks agree on all but
0.2% of the pixels; loss and scalar logs 2e-5 of their magnitude, 3e-3 for
the four that average over the auto-mask; gradients, as a relative L2
error, 1e-2 (depth net) and 5e-2 (pose net); BatchNorm statistics 1e-5.
Window sizes, origins and the overflow are integers and equal exactly
(``compute_windows`` of both packages on the port step's own poses and
depth). The port's windowed step against its dense step (overflow 0): the
same pixels warp, only the window's grid offset rounds the coordinates
apart, so the loss and logs agree to 1e-6 of their magnitude and the
gradients to 1e-5 relative L2 (measured: the loss equal, 1.5e-6); the
nets' forward is the same, so the BatchNorm statistics are equal. The
same bounds hold, port only, unmerged, in bf16, under ``aug_depth`` and
``remat`` and in the 'interval' and 'dense' spatio-temporal modes.

A forced small ``warp_window_hw`` truncates: both packages' eager
``compute_windows`` and ``render_views(windows=...)`` (JAX's ``quad`` warp,
the port's plain K5) on the step's own inputs give the same overflow and
origins, and images 1e-4 of their magnitude with the masks equal, as
tests/test_torch_render.py holds the dense warps.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers_torch_step import (check_batchnorm, check_gradients, check_logs,
                                jax_step, port_step, with_motion)
from vfdepth_tpu import presets as jpresets
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.geometry import view_rendering as jvr
from vfdepth_tpu.geometry import warp_window as jww
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu.training.trainer import Trainer as JaxTrainer
from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.data import BatchLoader
from vfdepth_tpu_torch.data import FakeDataset as PortFake
from vfdepth_tpu_torch.geometry import projection as tproj
from vfdepth_tpu_torch.geometry import view_rendering as tvr
from vfdepth_tpu_torch.geometry import warp_window as tww
from vfdepth_tpu_torch.training import create_train_state
from vfdepth_tpu_torch.training import model as model_module
from vfdepth_tpu_torch.training.model import VFDepthModel
from vfdepth_tpu_torch.training.trainer import Trainer
from vfdepth_tpu_torch.weights import load_flax_params
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
SIZE = dict(height=128, width=256)
FORCED_HW = ((32, 64), (16, 64))      # far smaller than the overlaps
SELF_LOG_TOL, SELF_GRAD_TOL = 1e-6, 1e-5


def _cfg(module):
    cfg = module.micro_config(**SIZE)
    cfg.set("focal_length_scale", 15.0)
    return cfg


def _recording(fn, into):
    """``fn`` recording each call's arguments and result."""
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        into.append((args, kwargs, out))
        return out
    return run


def _numpy(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t


@pytest.fixture(scope="module")
def windowed():
    jcfg, tcfg = _cfg(jpresets), _cfg(presets)
    assert jcfg.get("warp_window", True)       # the JAX default
    assert tcfg.get("warp_window", True)
    batch = FakeDataset(num_samples=1, num_cams=jcfg.num_cams,
                        height=jcfg.height, width=jcfg.width,
                        fusion_level=jcfg.fusion_level,
                        rig="nuscenes").batch([0])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxModel(jcfg)
    jm.configure_warp_window(batch)
    params, stats = jm.init(jax.random.PRNGKey(0), jbatch)
    params = with_motion(params, (40.0, 20.0, 60.0))
    np_grads, logs, np_new_stats, noise, amask = jax_step(jm, params, stats,
                                                          jbatch)
    np_params, np_stats = jax.tree_util.tree_map(np.asarray, (params, stats))
    logs = {k: float(v) for k, v in logs.items()}
    overflow = logs.pop("warp_window_overflow", None)

    # the port, dense (C2)
    dense_cfg = _cfg(presets)
    dense_cfg.set("warp_window", False)
    model = VFDepthModel(dense_cfg, device="cpu")
    load_flax_params(model, np_params, np_stats)
    create_train_state(model, batch=batch)
    assert model.warp_window_hw is None
    tlogs, tmask = port_step(model, batch, noise)

    # the port, windowed: sized from the batch, as JAX's
    wmodel = VFDepthModel(tcfg, device="cpu")
    load_flax_params(wmodel, np_params, np_stats)
    create_train_state(wmodel, batch=batch)
    calls, renders = [], []
    real_cw, real_rv = model_module.compute_windows, model_module.render_views
    model_module.compute_windows = _recording(real_cw, calls)
    model_module.render_views = _recording(real_rv, renders)
    try:
        wlogs, wmask = port_step(wmodel, batch, noise)
    finally:
        model_module.compute_windows = real_cw
        model_module.render_views = real_rv
    return dict(jax_hw=(jm.warp_window, jm.warp_window_hw),
                port_hw=(wmodel.warp_window, wmodel.warp_window_hw),
                overflow=overflow,
                np_grads=np_grads, new_stats=np_new_stats, model=model,
                logs=logs, tlogs=tlogs, amask=(amask, tmask),
                windowed=dict(np_grads=np_grads, new_stats=np_new_stats,
                              model=wmodel, logs=logs,
                              tlogs=dict(wlogs), amask=(amask, wmask)),
                calls=calls, renders=renders, cfg=tcfg)


def test_jax_sizes_windows_and_none_overflows(windowed):
    on, (spatio_hw, st_hw) = windowed["jax_hw"]
    assert on and spatio_hw is not None and st_hw is not None
    area = SIZE["height"] * SIZE["width"]
    for hw in (spatio_hw, st_hw):
        assert sum(h * w for h, w in hw) < 0.9 * area, hw
    assert windowed["overflow"] == 0.0


def test_auto_masks_agree(windowed):
    want, got = windowed["amask"]
    assert got.shape == want.shape
    assert 0.05 < want.mean() < 0.95
    assert (got != want).sum() <= 2e-3 * want.size


def test_loss_and_scalar_logs(windowed):
    check_logs(windowed, masked_tol=3e-3)
    assert windowed["logs"]["spatio_loss"] > 0
    assert windowed["logs"]["spatio_tempo_loss"] > 0


@pytest.mark.parametrize("net,tol", [("depth_net", 1e-2), ("pose_net", 5e-2)])
def test_gradients(windowed, net, tol):
    check_gradients(windowed, net, tol)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_batchnorm_statistics(windowed, net):
    check_batchnorm(windowed, net)


# --- the port's windows -------------------------------------------------

def test_port_sizes_the_windows_jax_sizes(windowed):
    assert windowed["port_hw"] == windowed["jax_hw"]


def _jax_windows(args, kwargs, **over):
    """JAX's ``compute_windows``, eagerly, on the port call's inputs."""
    names = ("inv_k", "k", "spatio_pose", "st_pose", "rel_idx", "nbr_valid",
             "height", "width", "spatio_hw", "st_hw", "min_depth",
             "max_depth", "focal_length_scale")
    kw = dict(zip(names, args), **kwargs)
    kw.update(over)
    kw = {k: (jnp.asarray(_numpy(v)) if isinstance(v, torch.Tensor) else v)
          for k, v in kw.items()}
    return jww.compute_windows(**kw)


def test_port_windows_match_jax_exactly(windowed):
    """Origins (int32) and the overflow (an integer-valued f32) of the
    port's step equal JAX's ``compute_windows`` on the same inputs."""
    (args, kwargs, got), = windowed["calls"]
    want = _jax_windows(args, kwargs)
    for name in ("spatio_origin", "st_origin"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.int32 and w.dtype == np.int32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert (got.spatio_hw, got.st_hw) == (want.spatio_hw, want.st_hw)
    assert got.overflow.dtype == torch.float32 and got.overflow.dim() == 0
    assert float(got.overflow) == float(want.overflow) == 0.0
    assert windowed["windowed"]["tlogs"]["warp_window_overflow"] == 0.0


def test_windowed_auto_masks_agree(windowed):
    want, got = windowed["windowed"]["amask"]
    assert (got != want).sum() <= 2e-3 * want.size


def test_windowed_loss_and_scalar_logs(windowed):
    pair = dict(windowed["windowed"])
    pair["tlogs"] = {k: v for k, v in pair["tlogs"].items()
                     if k != "warp_window_overflow"}
    check_logs(pair, masked_tol=3e-3)


@pytest.mark.parametrize("net,tol", [("depth_net", 1e-2), ("pose_net", 5e-2)])
def test_windowed_gradients(windowed, net, tol):
    check_gradients(windowed["windowed"], net, tol)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_windowed_batchnorm_statistics(windowed, net):
    check_batchnorm(windowed["windowed"], net)


def test_windowed_equals_dense_without_overflow(windowed):
    """The port's windowed step against its dense step: the logs (the
    overflow aside) and the gradients of every parameter, and the same
    BatchNorm statistics."""
    dense, win = windowed["tlogs"], windowed["windowed"]["tlogs"]
    assert win["warp_window_overflow"] == 0.0
    assert set(win) == set(dense) | {"warp_window_overflow"}
    for key, d in dense.items():
        assert abs(win[key] - d) <= SELF_LOG_TOL * max(abs(d), 1e-3), (
            key, win[key], d)
    got = dict(windowed["windowed"]["model"].named_parameters())
    for name, p in windowed["model"].named_parameters():
        rel = (got[name].grad - p.grad).norm() / p.grad.norm()
        assert rel <= SELF_GRAD_TOL, (name, float(rel))
    bufs = dict(windowed["windowed"]["model"].named_buffers())
    for name, b in windowed["model"].named_buffers():
        assert torch.equal(bufs[name], b), name


def test_forced_small_windows_truncate_as_jax_does(windowed):
    """``warp_window_hw`` far below the overlaps: both packages' eager
    ``compute_windows`` and ``render_views(windows=...)`` on the step's own
    inputs give the same overflow (> 0), origins, images and masks."""
    (args, kwargs, _), = windowed["calls"]
    (rargs, rkw, _), = windowed["renders"]
    tw = tww.compute_windows(*args[:8], FORCED_HW, FORCED_HW, *args[10:],
                             **kwargs)
    jw = _jax_windows(args, kwargs, spatio_hw=FORCED_HW, st_hw=FORCED_HW)
    assert float(tw.overflow) == float(jw.overflow) > 0
    np.testing.assert_array_equal(tw.spatio_origin.numpy(),
                                  np.asarray(jw.spatio_origin))
    np.testing.assert_array_equal(tw.st_origin.numpy(),
                                  np.asarray(jw.st_origin))

    kw = {k: v for k, v in rkw.items() if k not in ("windows", "plain")}
    got = tvr.render_views(*rargs, windows=tw, **kw)
    jargs = [({f: jnp.asarray(_numpy(v)) for f, v in a.items()}
              if isinstance(a, dict) else
              jnp.asarray(_numpy(a)) if isinstance(a, torch.Tensor) else a)
             for a in rargs]
    jkw = {k: (jnp.asarray(_numpy(v)) if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    want = jvr.render_views(*jargs, windows=jw, warp_op="quad", **jkw)
    truncated = tvr.render_views(*rargs, **kw)   # dense, for contrast
    for name in ("overlap_img", "overlap_mask"):
        g = getattr(got, name).detach().numpy()
        w = np.asarray(getattr(want, name))
        scale = max(np.abs(w).max(), 1e-12)
        if name.endswith("mask"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                       err_msg=name)
        d = getattr(truncated, name).detach().numpy()
        assert np.abs(g - d).max() > 1e-2 * scale, name  # it truncated


def test_note_warp_overflow_follows_jax():
    """The port's ``_note_warp_overflow`` against JAX's, called on stub
    trainers with the same sequence of checkpoint overflows: the strikes,
    the fallback on the second in a row, the reset on a clean one."""
    seq = [0.0, 3.0, 0.0, 2.0, 0.0, 5.0, 1.0, 4.0, 0.0, 7.0, 9.0]

    def stub():
        return types.SimpleNamespace(is_main=True, model=types.SimpleNamespace(
            warp_window=True, warp_window_hw=((16, 64), (16, 64))))

    js, ts = stub(), stub()
    trace = []
    for ov in seq:
        fell = JaxTrainer._note_warp_overflow(js, ov)
        assert Trainer._note_warp_overflow(ts, ov) == fell, ov
        assert vars(ts.model) == vars(js.model), ov
        assert ts._overflow_strikes == js._overflow_strikes, ov
        trace.append(fell)
    assert trace.index(True) == 6 and trace.count(True) == 1
    assert not ts.model.warp_window and ts.model.warp_window_hw is None


def test_learn_falls_back_to_dense_after_two_overflows(tmp_path):
    """The port's ``Trainer.learn`` with boxes too small for the rig: each
    step is a log checkpoint, the first two overflow, the second turns the
    windows off, the third step warps densely and logs no overflow."""
    cfg = presets.micro_config()
    for key, value in (("warp_window_hw", [16, 32]), ("num_epochs", 1),
                       ("log_frequency", 1), ("log_path", str(tmp_path)),
                       ("save_weights_root", str(tmp_path / "models"))):
        cfg.set(key, value)
    model = VFDepthModel(cfg, device="cpu")
    trainer = Trainer(cfg, model, use_tb=False)
    notes, real = [], trainer._note_warp_overflow

    def note(overflow):
        fell = real(overflow)
        notes.append((overflow, fell, model.warp_window))
        return fell
    trainer._note_warp_overflow = note
    ds = PortFake(num_samples=3, num_cams=cfg.num_cams, height=cfg.height,
                  width=cfg.width, fusion_level=cfg.fusion_level,
                  rig="nuscenes")
    trainer.learn(BatchLoader(ds, 1, shuffle=False, num_workers=0))
    assert [n[1:] for n in notes] == [(False, True), (True, False),
                                      (False, False)]
    assert notes[0][0] > 0 and notes[1][0] > 0 and notes[2][0] == 0.0
    assert model.warp_window_hw is None


# --- the window arithmetic alone ----------------------------------------

def _masks():
    rng = np.random.RandomState(3)
    masks = {"random": rng.rand(2, 3, 20, 30) > 0.97,
             "empty": np.zeros((2, 3, 20, 30), bool),
             "full": np.ones((2, 3, 20, 30), bool)}
    one = np.zeros((2, 3, 20, 30), bool)
    one[0, 1, 19, 29] = one[1, 2, 0, 0] = True
    masks["corners"] = one
    return masks


@pytest.mark.parametrize("name", ["random", "empty", "full", "corners"])
@pytest.mark.parametrize("box", [(8, 16), (20, 30)])
def test_bbox_origin_matches_jax(name, box):
    """Origins (clipped to [0, size - box]) and spans, the empty case's
    (0, 0) and 0 included, equal JAX's ``_bbox_origin``."""
    inc = _masks()[name]
    got = tww._bbox_origin(torch.from_numpy(inc), 20, 30, *box)
    want = jww._bbox_origin(jnp.asarray(inc), 20, 30, *box)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_host_sizing_matches_jax(windowed):
    """``estimate_window_hw_multi`` (spatial and worst-case motion) and
    ``st_actual_hw`` of both packages on the rig of the fixture's step."""
    (args, _, _), = windowed["calls"]
    cfg = windowed["cfg"]
    rigs = [(args[1][0].numpy(), FakeDataset(
        num_samples=1, num_cams=cfg.num_cams, height=cfg.height,
        width=cfg.width, rig="nuscenes").batch([0])["extrinsics"][0])]
    rel = np.asarray(cfg.rel_cam_array)
    common = (np.maximum(rel, 0), rel >= 0, cfg.height, cfg.width,
              cfg.min_depth, cfg.max_depth, cfg.focal_length_scale)
    for motion in (False, True):
        got = tww.estimate_window_hw_multi(rigs, *common, with_motion=motion)
        assert got == jww.estimate_window_hw_multi(rigs, *common,
                                                   with_motion=motion)
        assert tww.st_actual_hw(got, cfg.height, cfg.width, 64, 16) == \
            jww.st_actual_hw(got, cfg.height, cfg.width, 64, 16)


def test_interval_mode_windows_match_jax(windowed):
    """Without the step's depth the spatio-temporal windows bound a
    worst-case motion interval per context frame ('interval' mode): equal
    to JAX's."""
    (args, kwargs, _), = windowed["calls"]
    hw = windowed["port_hw"][1][0]
    got = tww.compute_windows(*args[:9], hw, *args[10:])
    want = _jax_windows(args, {}, st_hw=hw)
    assert got.st_origin.shape == (1, 3, 2, 2, 2, 2)
    np.testing.assert_array_equal(got.st_origin.numpy(),
                                  np.asarray(want.st_origin))
    assert float(got.overflow) == float(want.overflow)


def test_project_coords_window_matches_dense(windowed):
    """A window's coordinates equal the dense ones on its pixels."""
    (args, kwargs, _), = windowed["calls"]
    (rargs, _, _), = windowed["renders"]
    depth = rargs[4].detach()[:, :, None].expand(-1, -1, 2, -1, -1, -1)
    inv_k = args[0][:, :, None].expand(-1, -1, 2, -1, -1)
    src_k = args[1][:, args[4]]
    pose = args[2]
    dense = tproj.project_coords(depth, pose, inv_k, src_k)
    origin = torch.tensor([5, 17], dtype=torch.int32).expand(1, 3, 2, 2)
    box = tvr._slice_boxes(depth, tvr._box_index(origin, *SIZE.values(),
                                                  16, 64), 16, 64)
    got = tproj.project_coords_window(box, origin, pose, inv_k, src_k,
                                      *SIZE.values())
    want = dense[:, :, :, 5:21, 17:81]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * want.abs().max().item())


def _port_step(over, windowed):
    """The port's step on the module's canvas with config keys ``over``,
    windows sized from the batch (``windowed``) or off: (scalar logs,
    gradients, window sizes)."""
    cfg = presets.micro_config(
        **SIZE, **{k: v for k, v in over.items()
                   if k in ("mixed_precision", "aug_depth")})
    cfg.set("focal_length_scale", 15.0)
    for key, value in over.items():
        cfg.set(key, value)
    cfg.set("warp_window", windowed)
    model = VFDepthModel(cfg, device="cpu")
    batch = PortFake(num_samples=1, num_cams=cfg.num_cams, height=cfg.height,
                     width=cfg.width, fusion_level=cfg.fusion_level,
                     rig="nuscenes").batch([0])
    create_train_state(model, batch=batch)
    gen = torch.Generator().manual_seed(0)
    noise = torch.randn(model.noise_shape(batch), generator=gen)
    aug_u = (torch.rand(model.aug_shape(batch), generator=gen)
             if model.aug_depth else None)
    model.train()
    _, loss, logs = model(batch, step=3, noise=noise, aug_u=aug_u)
    loss.backward()
    return ({k: float(v.detach()) for k, v in logs.items() if v.dim() == 0},
            {k: p.grad for k, p in model.named_parameters()},
            model.warp_window_hw)


@pytest.mark.parametrize("over", [
    dict(merge_backprojection=False), dict(mixed_precision=True),
    dict(aug_depth=True), dict(remat="all"),
    dict(st_window_mode="interval"), dict(st_window_mode="dense")],
    ids=["unmerged", "bf16", "aug_depth", "remat", "interval", "st_dense"])
def test_windowed_step_equals_dense_across_options(over):
    """The windowed step (overflow 0) against the dense one, unmerged, in
    bf16, under ``aug_depth`` and ``remat``, and in the other
    spatio-temporal modes: logs and gradients at the bounds above."""
    wlogs, wgrads, hw = _port_step(over, True)
    dlogs, dgrads, _ = _port_step(over, False)
    assert hw is not None and hw[0] is not None
    if over.get("st_window_mode") == "dense":
        assert hw[1] is None
    assert wlogs.pop("warp_window_overflow") == 0.0
    assert set(wlogs) == set(dlogs) and dlogs["spatio_loss"] > 0
    for key, d in dlogs.items():
        assert abs(wlogs[key] - d) <= SELF_LOG_TOL * max(abs(d), 1e-3), key
    for name, g in dgrads.items():
        rel = (wgrads[name] - g).norm() / g.norm().clamp_min(1e-30)
        assert rel <= SELF_GRAD_TOL, (name, float(rel))
