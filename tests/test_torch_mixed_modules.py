"""Modules of the port with ``dtype=torch.bfloat16`` against their flax
twins with ``dtype=jnp.bfloat16``, on the CPU.

Each flax module is applied eagerly (op by op, each op rounding to bf16
where its program says; the jitted CPU program may keep f32 values across
fused casts) to the same bf16 inputs and weights as the port's. Two checks
each:

* agreement: outputs of the same dtype as flax's, within a tolerance of a
  few bf16 steps (one step is 2^-7 of a magnitude; most values agree
  exactly, a few round to the other neighbour where the two frameworks'
  f32 accumulations differ by an ulp);
* the casting points: the port's distance to flax bf16, over flax bf16's
  distance to flax f32 (relative L2), stays below 0.02 for a module of one
  stage (measured 0 to 0.0012) and below 0.2 for one of several (measured
  0.06 to 0.10). A port computing in f32 sits at 1. One cast that differs
  from flax's moves the port by a bf16-sized error: LeakyReLU's slope
  taken as an f32 0.1, where JAX multiplies by bf16(0.1) = 0.10009765625,
  measured 0.075 to 0.09 on the one-stage modules and 0.23 on the frustum
  projection, and fails both bounds.

The per-camera rows of the 3-camera rig (kernel K1b) meet the fusion as
JAX sums them. ``fuse_depth`` adds each overlap group camera by camera in
bf16 and the two groups' sums in bf16; only voxels seen by one or two
cameras reach its MLPs, so at most two non-zero rows meet in a sum that
counts and every order rounds alike (ratio measured 0, with the sums taken
in f32 too). The pose branch's camera mean takes ``jnp.sum`` over all
cameras (f32 accumulation, one rounding) and divides in bf16 by the bf16
count; through BEVFold and the reduction conv it is held with the ratio of
several stages (0.2; measured 0.08, 0.01 after BEVFold alone), which a
camera-by-camera bf16 sum fails (measured 0.72).

A bf16 network deepens the spread: one flipped rounding changes the next
layer's sums, which flip more (tests/test_torch_mixed_model.py). In
ResNet-18 the fraction of differing values grows from 0 at the first level
to a third at the last, where the ratio reaches ~0.6 (measured 0.001,
0.002, 0.10, 0.39, 0.58 over the five levels); the ratio check (0.2) is
made on the first three levels, and every level is held to 2e-2 relative
L2.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.models import blocks as jblocks
from vfdepth_tpu.models import decoders as jdec
from vfdepth_tpu.models import resnet as jresnet
from vfdepth_tpu.models import vfnet as jvfnet
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.models import blocks as tblocks
from vfdepth_tpu_torch.models import decoders as tdec
from vfdepth_tpu_torch.models import resnet as tresnet
from vfdepth_tpu_torch.models import vfnet as tvfnet
from vfdepth_tpu_torch.training.model import VFDepthModel
from vfdepth_tpu_torch.weights import load_flax_params

from test_torch_models import _carry, _nchw, _nhwc, _np_tree

jax.config.update("jax_platforms", "cpu")
BF = jnp.bfloat16
TINY = "configs/tiny_fake.yaml"


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, as f32 (the inputs both frameworks see)."""
    return np.asarray(jnp.asarray(x).astype(BF).astype(jnp.float32))


def _rel(a, b) -> float:
    a = np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)
    b = np.asarray(jnp.asarray(b).astype(jnp.float32), np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check(got, want_bf16, want_f32, tol=2e-2, ratio=0.02, dtype=BF):
    """``got`` (numpy f32 of the port's output) against flax's bf16 and f32
    outputs: flax's dtype, the tolerance, and the casting-point ratio."""
    assert want_bf16.dtype == dtype
    err, gap = _rel(got, want_bf16), _rel(want_bf16, want_f32)
    assert gap > 0
    assert err <= tol, (err, tol)
    if ratio is not None:
        assert err < ratio * gap, (err, gap)
    return err / gap


def _t(x):
    return x.detach().float()


@pytest.mark.parametrize("kernel,stride,nonlin,norm,train", [
    (3, 1, "LRU", False, False), (3, 2, "ELU", True, False),
    (3, 2, "ELU", True, True), (1, 1, None, False, False)])
def test_conv_block_bf16_matches_flax(kernel, stride, nonlin, norm, train):
    x = _bf16(np.random.RandomState(0).randn(2, 16, 24, 32))
    kw = dict(stride=stride, nonlin=nonlin, norm=norm, fast_pad=False)
    jm, jf = jblocks.ConvBlock(48, kernel, dtype=BF, **kw), \
        jblocks.ConvBlock(48, kernel, **kw)
    tm = tblocks.ConvBlock(32, 48, kernel, stride=stride, nonlin=nonlin,
                           norm=norm, dtype=torch.bfloat16)
    v = _carry(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False), tm, 1)
    tm.train(train)
    outs = []
    for mod, dt in ((jm, BF), (jf, jnp.float32)):
        xin = jnp.asarray(x).astype(dt)
        if train:
            y, new = mod.apply(v, xin, True, mutable=["batch_stats"])
        else:
            y, new = mod.apply(v, xin, False), None
        outs += [y, new]
    got = tm(_nchw(x).bfloat16())
    assert got.dtype == torch.bfloat16
    _check(_nhwc(_t(got)), outs[0], outs[2])
    if train:      # the running statistics: f32, from f32 batch statistics
        for name, leaf in (("running_mean", "mean"), ("running_var", "var")):
            buf = getattr(tm.bn, name)
            assert buf.dtype == torch.float32
            np.testing.assert_allclose(
                buf.numpy(), np.asarray(outs[1]["batch_stats"]["BatchNorm_0"]
                                        [leaf]), rtol=1e-5, atol=1e-6)


def test_pointwise_block_bf16_matches_flax():
    x = _bf16(np.random.RandomState(2).randn(3, 500, 33))
    jm, jf = jblocks.PointwiseBlock(16, dtype=BF), jblocks.PointwiseBlock(16)
    tm = tblocks.PointwiseBlock(33, 16, dtype=torch.bfloat16)
    v = _carry(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), tm, 3)
    got = tm(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    _check(_t(got), jm.apply(v, jnp.asarray(x).astype(BF)),
           jf.apply(v, jnp.asarray(x)))


def test_resnet_encoder_bf16_matches_flax():
    """f32 input (normalised in f32, then cast); levels as described."""
    x = np.random.RandomState(4).rand(2, 64, 96, 3).astype(np.float32)
    jm, jf = jresnet.ResnetEncoder(18, 1, dtype=BF), \
        jresnet.ResnetEncoder(18, 1)
    tm = tresnet.ResnetEncoder(18, 1, dtype=torch.bfloat16)
    v = _carry(jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(x), False), tm, 5)
    want = jm.apply(v, jnp.asarray(x), False)
    want_f32 = jf.apply(v, jnp.asarray(x), False)
    with torch.no_grad():
        got = tm(_nchw(x))
    assert len(got) == 5
    for level, (g, w, f) in enumerate(zip(got, want, want_f32)):
        assert g.dtype == torch.bfloat16
        _check(_nhwc(_t(g)), w, f, ratio=0.2 if level < 3 else None)


def test_fusion_depth_decoder_bf16_matches_flax():
    x = _bf16(np.random.RandomState(6).randn(6, 8, 12, 128))
    jm = jdec.FusionDepthDecoder(level_in=2, num_ch_enc=(64, 64, 128),
                                 dtype=BF)
    jf = jdec.FusionDepthDecoder(level_in=2, num_ch_enc=(64, 64, 128))
    tm = tdec.FusionDepthDecoder(2, (64, 64, 128), dtype=torch.bfloat16)
    v = _carry(jm.init(jax.random.PRNGKey(0), [jnp.asarray(x)]), tm, 7)
    want = jm.apply(v, [jnp.asarray(x).astype(BF)])["disp/0"]
    with torch.no_grad():
        got = tm([_nchw(x).bfloat16()])["disp/0"]
    assert got.dtype == torch.float32          # sigmoid in f32
    _check(_nhwc(got), want, jf.apply(v, [jnp.asarray(x)])["disp/0"],
           ratio=0.2, dtype=jnp.float32)


def test_pose_decoder_bf16_matches_flax():
    x = _bf16(np.random.RandomState(8).randn(4, 12, 12, 128))
    jm, jf = jdec.PoseDecoder(1, stride=2, dtype=BF), jdec.PoseDecoder(
        1, stride=2)
    tm = tdec.PoseDecoder(128, 1, stride=2, dtype=torch.bfloat16)
    v = _carry(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), tm, 9)
    want = jm.apply(v, jnp.asarray(x).astype(BF))
    want_f32 = jf.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_nchw(x).bfloat16())
    for g, w, f in zip(got, want, want_f32):
        assert g.dtype == torch.float32        # the head's mean in f32
        _check(g.numpy(), w, f, ratio=0.2, dtype=jnp.float32)


@pytest.mark.parametrize("groups", [1, 2])
def test_bev_fold_bf16_matches_flax(groups):
    vz, vy, vx, gc = 4, 16, 16, 8
    x = _bf16(np.random.RandomState(10).randn(2, vy * vx * vz,
                                              groups * gc + 1))
    jm = jvfnet.BEVFold(out_ch=32, gc=gc, vz=vz, vy=vy, vx=vx, dtype=BF)
    jf = jvfnet.BEVFold(out_ch=32, gc=gc, vz=vz, vy=vy, vx=vx)
    tm = tvfnet.BEVFold(32, gc, vz, vy, vx, dtype=torch.bfloat16)
    v = _carry(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), groups, False),
               tm, 11)
    want = jm.apply(v, jnp.asarray(x).astype(BF), groups, False)
    got = tm(torch.from_numpy(x).bfloat16(), groups=groups)
    assert got.dtype == torch.bfloat16
    _check(_nhwc(_t(got)), want, jf.apply(v, jnp.asarray(x), groups, False))
    # dtype None computes in the input's dtype (``self.dtype or x.dtype``)
    tm.dtype = None
    assert tm(torch.from_numpy(x).bfloat16(), groups=groups).dtype == \
        torch.bfloat16


@pytest.fixture(scope="module")
def depth_nets():
    """The tiny config's JAX depth net, bf16 and f32, and the port's bf16
    depth net with the same (perturbed) weights."""
    cfg = jax_get_config(TINY)
    batch = FakeDataset(num_samples=1, height=cfg.height, width=cfg.width,
                        fusion_level=cfg.fusion_level).batch([0])
    params, stats = JaxModel(cfg).init(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.RandomState(12)
    params, stats = _np_tree(params, rng), _np_tree(stats, rng)
    jnets, jpose = {}, {}
    for mixed in (False, True):
        jcfg = jax_get_config(TINY)
        jcfg.set("mixed_precision", mixed)
        jnets[mixed] = JaxModel(jcfg).depth_net
        jpose[mixed] = JaxModel(jcfg).pose_net
    tcfg = get_config(TINY)
    tcfg.set("mixed_precision", True)
    tm = VFDepthModel(tcfg, device="cpu")
    load_flax_params(tm, params, stats)
    v = {"params": params["depth_net"], "batch_stats": stats["depth_net"]}
    vp = {"params": params["pose_net"], "batch_stats": stats["pose_net"]}
    return jnets, v, tm.depth_net, batch, (jpose, vp, tm.pose_net)


def test_fuse_depth_and_frustum_projection_bf16_match_flax(depth_nets):
    """``fuse_depth`` (bf16 masks and MLPs) and ``project_voxel_into_image``
    (K3 on the bf16 volume, then the bf16 reduction convs), each from the
    same bf16 input."""
    jnets, v, tnet, batch, _ = depth_nets
    rng = np.random.RandomState(13)
    n = int(np.prod(jax_get_config(TINY).voxel_size))
    feat = _bf16(rng.randn(1, 2, n, 33))
    count = rng.randint(0, 3, (1, n)).astype(np.float32)

    def fuse(mdl, f, c):
        return mdl.fusion_net.fuse_depth(f, c, grouped=True)

    def proj(mdl, vox):
        return mdl.fusion_net.project_voxel_into_image(
            vox, jnp.asarray(batch["inv_K/3"]),
            jnp.asarray(batch["extrinsics"]), False)

    fused = {m: jnets[m].apply(v, jnp.asarray(feat).astype(dt),
                               jnp.asarray(count).astype(dt), method=fuse)
             for m, dt in ((True, BF), (False, jnp.float32))}
    with torch.no_grad():
        got = tnet.fusion_net.fuse_depth(torch.from_numpy(feat).bfloat16(),
                                         torch.from_numpy(count).bfloat16())
    assert got.dtype == torch.bfloat16
    _check(_t(got), fused[True], fused[False])

    vox = np.asarray(fused[True].astype(jnp.float32))
    projected = {m: jnets[m].apply(v, jnp.asarray(vox).astype(dt),
                                   method=proj)
                 for m, dt in ((True, BF), (False, jnp.float32))}
    with torch.no_grad():
        got = tnet.fusion_net.project_voxel_into_image(
            torch.from_numpy(vox).bfloat16(),
            torch.from_numpy(batch["inv_K/3"]),
            torch.from_numpy(batch["extrinsics"]))
    assert got.dtype == torch.bfloat16
    want = projected[True]
    _check(_nhwc(_t(got)).reshape(want.shape), want, projected[False],
           ratio=0.2)


def _per_camera(seed, cams, n, c):
    """Per-camera back-projected rows as K1b gives them: bf16 features
    where the camera sees the voxel, exact zeros elsewhere, and the bf16
    count of cameras that see each voxel (0-3 here)."""
    rng = np.random.RandomState(seed)
    valid = (rng.rand(1, cams, n) < 0.35).astype(np.float32)
    feat = _bf16(rng.randn(1, cams, n, c)) * valid[..., None]
    return feat, valid.sum(1)


def test_per_camera_fusion_bf16_matches_flax(depth_nets):
    """``fuse_depth(grouped=False)``: the overlap groups ((0, 3, 4), (1, 2,
    5)) summed camera by camera in bf16."""
    jnets, v, tnet, _, _ = depth_nets
    n = int(np.prod(jax_get_config(TINY).voxel_size))
    feat, count = _per_camera(14, 6, n, 33)

    def fuse(mdl, f, c):
        return mdl.fusion_net.fuse_depth(f, c, grouped=False)
    fused = {m: jnets[m].apply(v, jnp.asarray(feat).astype(dt),
                               jnp.asarray(count).astype(dt), method=fuse)
             for m, dt in ((True, BF), (False, jnp.float32))}
    with torch.no_grad():
        got = tnet.fusion_net.fuse_depth(torch.from_numpy(feat).bfloat16(),
                                         torch.from_numpy(count).bfloat16(),
                                         grouped=False)
    assert got.dtype == torch.bfloat16
    _check(_t(got), fused[True], fused[False])


def test_per_camera_pose_bev_bf16_matches_flax(depth_nets):
    """``pose_voxel_to_bev(grouped=False)``: the camera mean (an f32 sum
    rounded once, divided in bf16 by the bf16 count), then BEVFold and the
    reduction conv."""
    jpose, vp, tpose = depth_nets[4]
    n = int(np.prod(jax_get_config(TINY).voxel_size))
    feat, count = _per_camera(15, 6, n, 33)

    def bev(mdl, f, c):
        return mdl.fusion_net.pose_voxel_to_bev(f, c, train=False,
                                                grouped=False)
    outs = {m: jpose[m].apply(vp, jnp.asarray(feat).astype(dt),
                              jnp.asarray(count).astype(dt), method=bev)
            for m, dt in ((True, BF), (False, jnp.float32))}
    with torch.no_grad():
        got = tpose.fusion_net.pose_voxel_to_bev(
            torch.from_numpy(feat).bfloat16(),
            torch.from_numpy(count).bfloat16(), grouped=False)
    assert got.dtype == torch.bfloat16
    _check(_nhwc(_t(got)), outs[True], outs[False], ratio=0.2)
