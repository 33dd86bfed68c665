"""The fsm (Monodepth2) baseline's modules in the port against the JAX
package, on the CPU: the "XYZ" Euler angles, the pose-consistency loss, the
Monodepth2 depth decoder and the two nets, in f32 and in bf16.

Tolerances, with their reasons:

* Euler angles: the same f32 ``asin`` / ``atan2`` of the same entries,
  1e-6 absolute (one ulp of an angle near pi is 2.4e-7); their gradient
  1e-5 of its magnitude, and at R02 = +-1 JAX's infinities (``ties.clip``
  passes half of the cotangent at the bound, and asin' is inf there).
  One f32 step beyond the bound JAX's derivative is nan (0 x inf in its
  clip's select) and the port's 0, as the reference's ``torch.clamp``
  gives: a nan is a fault, and the port does not copy it.
* Pose consistency: two 4x4 products per camera and frame, summed in
  another order by ``torch.einsum`` than by XLA; value 1e-5 and gradient
  1e-4 of their magnitudes. Where camera 0's alignment into its own frame
  is exact (rigs whose camera 0 extrinsics multiply without rounding, as
  both ``FakeDataset`` rigs'), some of its differences are exactly 0 and
  JAX's gradient through that camera's pose is nan: its norm's derivative
  at 0 is 0 x inf, which ``.at[0].set(0)`` does not stop. The reference
  skips camera 0, and the port's norm has derivative 0 there; so the port
  is held to JAX everywhere JAX is finite, and to be finite.
* Modules in f32 (eval mode, BatchNorm statistics randomised): the bounds
  of tests/test_torch_models.py, 1e-4 of the largest output, 2e-4 through
  a ResNet encoder (measured 3e-7 to 5e-7).
* Modules in bf16: tests/test_torch_mixed_modules.py's per-module bound,
  2e-2 relative L2 against flax bf16 (measured 4e-4 to 8e-3), and the
  port's distance from its own f32 module within 0.5x-2x flax's bf16-to-f32
  distance (the module computes in bf16). The casting-point ratio of that
  file is not held: through the decoder's ten convolutions it measures
  0.3 to 0.6, through the nets up to 0.9, as at ResNet-18's deepest
  levels there.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.geometry import se3 as jse3
from vfdepth_tpu.losses import composite as jcomp
from vfdepth_tpu.models import decoders as jdec
from vfdepth_tpu.models import nets as jnets
from vfdepth_tpu_torch.geometry import se3 as tse3
from vfdepth_tpu_torch.losses import composite as tcomp
from vfdepth_tpu_torch.models import decoders as tdec
from vfdepth_tpu_torch.models import nets as tnets
from vfdepth_tpu_torch.weights import load_flax_params

from test_torch_mixed_modules import _bf16, _check, _rel
from test_torch_models import _close, _nchw, _nhwc, _np_tree
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
BF = jnp.bfloat16
ENC_CH = (64, 64, 128, 256, 512)          # ResNet-18's levels


def _carry(flax_vars, module, seed):
    """flax's own init carried into ``module``, BatchNorm statistics
    randomised (variances kept positive). Unlike tests/test_torch_models.py
    the weights are not perturbed: 0.1 on every weight is 7x the init's
    spread at ResNet-18's widths, which through the decoder's ten
    unnormalised convolutions saturates every sigmoid and the pose head's
    clip, and leaves nothing to compare."""
    params = _np_tree(flax_vars["params"])
    stats = _np_tree(flax_vars.get("batch_stats", {}),
                     np.random.RandomState(seed))
    load_flax_params(module, params, stats)
    module.eval()
    return {"params": params, "batch_stats": stats}


def _rotations(n, seed):
    aa = np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    return np.array(jse3.axis_angle_to_matrix(jnp.asarray(aa)))


def _gimbal(sign):
    """Rotations whose R02 is +-1 exactly, and one f32 step beyond."""
    rot = _rotations(4, 7 if sign > 0 else 8)
    rot[:3, 0, 2] = sign
    rot[3, 0, 2] = sign * np.nextafter(np.float32(1), np.float32(2))
    return rot


@pytest.mark.parametrize("case", ["random", "R02=+1", "R02=-1"])
def test_euler_angles_and_gradient_match_jax(case):
    rot = {"random": lambda: _rotations(64, 3),
           "R02=+1": lambda: _gimbal(1.0),
           "R02=-1": lambda: _gimbal(-1.0)}[case]()
    w = np.random.RandomState(5).randn(len(rot), 3).astype(np.float32)

    def jloss(r):
        return jnp.sum(jse3.matrix_to_euler_angles_xyz(r) * w)
    want = np.asarray(jse3.matrix_to_euler_angles_xyz(jnp.asarray(rot)))
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(rot)))

    r = torch.from_numpy(rot).requires_grad_()
    got = tse3.matrix_to_euler_angles_xyz(r)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    g = r.grad.numpy()
    if case != "random":
        # at the bound JAX's and the port's are inf; beyond it JAX's is nan
        # and the port's 0 (see the module's docstring)
        d02, t02 = want_g[:, 0, 2], g[:, 0, 2]
        assert np.isinf(d02[:3]).all() and np.isnan(d02[3]), d02
        assert t02[3] == 0.0, t02
        want_g = want_g.copy()
        want_g[3, 0, 2] = 0.0
    finite = np.isfinite(want_g)
    np.testing.assert_array_equal(np.isfinite(g), finite)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(want_g))
    np.testing.assert_array_equal(g[np.isinf(want_g)],
                                  want_g[np.isinf(want_g)])
    np.testing.assert_allclose(g[finite], want_g[finite], rtol=0,
                               atol=1e-5 * np.abs(want_g[finite]).max())


@pytest.mark.parametrize("rig", ["exact", "rotated"])
def test_pose_consistency_loss_and_gradient_match_jax(rig):
    """``exact``: FakeDataset's rig, camera 0's alignment exact; ``rotated``:
    the same rig yawed by 0.1 rad, where nothing aligns exactly."""
    b, cams, n_ctx = 2, 6, 2
    ext = FakeDataset(num_samples=b, num_cams=cams, height=32, width=64,
                      fusion_level=2).batch([0, 1])["extrinsics"]
    if rig == "rotated":
        yaw = np.asarray(jse3.vec_to_matrix(jnp.asarray([0.0, 0.0, 0.1]),
                                            jnp.zeros(3)))
        ext = (yaw @ ext).astype(np.float32)
    ext_inv = np.linalg.inv(ext).astype(np.float32)
    rng = np.random.RandomState(11)
    aa = (0.05 * rng.randn(b, cams, n_ctx, 3)).astype(np.float32)
    tr = (0.5 * rng.randn(b, cams, n_ctx, 3)).astype(np.float32)
    cam = np.array(jse3.vec_to_matrix(jnp.asarray(aa), jnp.asarray(tr)))
    weights = np.arange(1.0, cams + 1, dtype=np.float32)

    percam = np.asarray(jcomp.pose_consistency_loss(jnp.asarray(cam), ext,
                                                    ext_inv))
    want_g = np.asarray(jax.grad(
        lambda c: jnp.sum(jcomp.pose_consistency_loss(c, ext, ext_inv)
                          * weights))(jnp.asarray(cam)))
    c = torch.from_numpy(cam).requires_grad_()
    got = tcomp.pose_consistency_loss(c, torch.from_numpy(ext),
                                      torch.from_numpy(ext_inv))
    assert got.shape == (cams,) and float(got[0]) == 0.0 == percam[0]
    assert (percam[1:] > 0).all()
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), percam, rtol=1e-5)
    g = c.grad.numpy()
    assert np.isfinite(g).all()
    nan = np.isnan(want_g)
    assert nan.any() == (rig == "exact")
    assert not nan[:, 1:].any()              # only camera 0's pose
    finite = want_g[~nan]
    assert np.abs(finite).max() > 0
    np.testing.assert_allclose(g[~nan], finite, rtol=0,
                               atol=1e-4 * np.abs(finite).max())


def _features(seed, n=2, h=32, w=48, dtype=np.float32):
    """Encoder-shaped inputs of the decoder: ResNet-18's channels at 1/2 to
    1/32 of an h x w image (here the level sizes of a 64 x 96 image)."""
    rng = np.random.RandomState(seed)
    return [rng.randn(n, h >> i, w >> i, c).astype(dtype)
            for i, c in enumerate(ENC_CH)]


def test_mono_depth_decoder_matches_flax():
    feats = _features(1)
    jmod = jdec.MonoDepthDecoder(num_ch_enc=ENC_CH)
    tmod = tdec.MonoDepthDecoder(ENC_CH)
    v = _carry(jmod.init(jax.random.PRNGKey(0),
                         [jnp.asarray(f) for f in feats]), tmod, 2)
    want = jmod.apply(v, [jnp.asarray(f) for f in feats])
    got = tmod([_nchw(f) for f in feats])
    assert set(got) == set(want) == {f"disp/{s}" for s in range(4)}
    for key, w in want.items():
        _close(_nhwc(got[key]), w)


def _bf16_check(got, got_f32, want, want_f32):
    """The port's bf16 output within 2e-2 relative L2 of flax bf16, and as
    far from the port's f32 output as flax bf16 is from flax f32 (0.5x-2x)."""
    _check(got, want, want_f32, ratio=None, dtype=jnp.float32)
    jax_gap, port_gap = _rel(want, want_f32), _rel(got, got_f32)
    assert 0.5 * jax_gap < port_gap < 2.0 * jax_gap, (port_gap, jax_gap)


def _pair(make, vars_, seed):
    """The port's module in bf16 and in f32, with the same weights."""
    mods = make(torch.bfloat16), make(None)
    for m in mods:
        _carry(vars_, m, seed)
    return mods


def test_mono_depth_decoder_bf16_matches_flax():
    feats = [_bf16(f) for f in _features(3)]
    jm, jf = (jdec.MonoDepthDecoder(num_ch_enc=ENC_CH, scales=(0, 2),
                                    dtype=dt) for dt in (BF, None))
    v = jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])
    tm, tf = _pair(lambda dt: tdec.MonoDepthDecoder(ENC_CH, scales=(0, 2),
                                                    dtype=dt), v, 4)
    v = _carry(v, tm, 4)
    want = jm.apply(v, [jnp.asarray(f).astype(BF) for f in feats])
    want_f32 = jf.apply(v, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tm([_nchw(f).bfloat16() for f in feats])
        got_f32 = tf([_nchw(f) for f in feats])
    assert set(got) == set(want) == {"disp/0", "disp/2"}
    for key, g in got.items():
        assert g.dtype == torch.float32          # the sigmoid in f32
        _bf16_check(_nhwc(g), _nhwc(got_f32[key]), want[key], want_f32[key])


def _images(seed, n=3, h=64, w=96):
    return np.random.RandomState(seed).rand(n, h, w, 3).astype(np.float32)


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16"])
def test_mono_depth_net_matches_flax(mixed):
    x = _images(5)
    jm = jnets.MonoDepthNet(scales=(0, 1), dtype=BF if mixed else None)
    v = jax.jit(jm.init, static_argnums=2)(jax.random.PRNGKey(0),
                                           jnp.asarray(x), False)
    tm, tf = _pair(lambda dt: tnets.MonoDepthNet(scales=(0, 1), dtype=dt),
                   v, 6)
    if not mixed:
        tm = tf
    v = _carry(v, tm, 6)
    want = jm.apply(v, jnp.asarray(x), False)
    want_f32 = jnets.MonoDepthNet(scales=(0, 1)).apply(v, jnp.asarray(x),
                                                       False)
    with torch.no_grad():
        got, got_f32 = tm(torch.from_numpy(x)), tf(torch.from_numpy(x))
    assert set(got) == set(want) == {"disp/0", "disp/1"}
    for key, w in want.items():
        g = got[key].numpy()
        assert g.dtype == np.float32 and g.shape == w.shape, key
        if mixed:
            _bf16_check(g, got_f32[key].numpy(), w, want_f32[key])
        else:
            _close(g, w, rel=2e-4)


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16"])
def test_mono_pose_net_matches_flax(mixed):
    cur, nxt = _images(7), _images(8)
    jm = jnets.MonoPoseNet(dtype=BF if mixed else None)
    args = (jnp.asarray(cur), jnp.asarray(nxt))
    v = jax.jit(jm.init, static_argnums=3)(jax.random.PRNGKey(0), *args,
                                           False)
    tm, tf = _pair(lambda dt: tnets.MonoPoseNet(dtype=dt), v, 9)
    if not mixed:
        tm = tf
    v = _carry(v, tm, 9)
    want = jm.apply(v, *args, False)
    want_f32 = jnets.MonoPoseNet().apply(v, *args, False)
    targs = (torch.from_numpy(cur), torch.from_numpy(nxt))
    with torch.no_grad():
        got, got_f32 = tm(*targs), tf(*targs)
    for g, gf, w, f in zip(got, got_f32, want, want_f32):
        g = g.numpy()
        assert g.dtype == np.float32 and g.shape == w.shape == (3, 1, 1, 3)
        if mixed:
            _bf16_check(g, gf.numpy(), w, f)
        else:
            _close(g, w, rel=2e-4)


def test_mono_pose_net_clips_translation_as_jax():
    """Head biases of +-10 m and of 1 m: the translation is clipped to +-4 m
    as JAX clips it, and no gradient passes the clip."""
    cur, nxt = _images(10, n=2), _images(11, n=2)
    jm, tm = jnets.MonoPoseNet(), tnets.MonoPoseNet()
    args = (jnp.asarray(cur), jnp.asarray(nxt))
    v = _carry(jax.jit(jm.init, static_argnums=3)(
        jax.random.PRNGKey(0), *args, False), tm, 12)
    head = v["params"]["pose_decoder"]["pose_2"]
    head["bias"] = np.array([0, 0, 0, 1000.0, -1000.0, 100.0], np.float32)
    head["kernel"] = np.zeros_like(head["kernel"])   # the head is its bias
    with torch.no_grad():
        tm.pose_decoder.pose_2.bias.copy_(torch.from_numpy(head["bias"]))
        tm.pose_decoder.pose_2.weight.zero_()

    def jtr(p):
        return jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                        *args, False)[1]
    want = np.asarray(jtr(v["params"]))
    want_g = jax.grad(lambda p: jnp.sum(jtr(p)))(v["params"])
    _, tr = tm(torch.from_numpy(cur), torch.from_numpy(nxt))
    np.testing.assert_array_equal(tr.detach().numpy(), want)
    assert (np.abs(want[..., :2]) == 4.0).all()
    tr.sum().backward()
    np.testing.assert_allclose(
        tm.pose_decoder.pose_2.bias.grad.numpy(),
        np.asarray(want_g["pose_decoder"]["pose_2"]["bias"]), rtol=1e-6)
