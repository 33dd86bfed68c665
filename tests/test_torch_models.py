"""Networks of the PyTorch port against the flax modules, eval mode, CPU.

Each flax module is initialised at a small size; its parameters (and
BatchNorm statistics, randomised so normalisation is not the identity) go
through ``weights.load_flax_params`` into the port's module, and both run
the same numpy inputs. Tolerance: f32 convolutions through XLA and oneDNN
sum in different orders, and the error grows with depth; outputs agree to
1e-4 of their largest magnitude (ResNet: 2e-4 after its 20 conv layers).
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

jax.config.update("jax_platforms", "cpu")
TINY = "configs/tiny_fake.yaml"


def _np_tree(tree, rng=None):
    """flax tree -> nested dict of numpy arrays; with ``rng``, every leaf is
    perturbed (variances kept positive) so each parameter matters."""
    def leaf(path, x):
        x = np.array(x, np.float32)
        if rng is None:
            return x
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + 0.1 * rng.randn(*x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(
        lambda x: x, dict(tree)))


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _carry(flax_vars, module, seed):
    rng = np.random.RandomState(seed)
    params = _np_tree(flax_vars["params"], rng)
    stats = _np_tree(flax_vars.get("batch_stats", {}), rng)
    load_flax_params(module, params, stats)
    module.eval()
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("kernel,stride,nonlin,norm", [
    (3, 1, "LRU", False), (3, 2, "ELU", True), (1, 1, None, False)])
def test_conv_block_matches_flax(kernel, stride, nonlin, norm):
    x = np.random.RandomState(0).randn(2, 9, 12, 5).astype(np.float32)
    jmod = jblocks.ConvBlock(7, kernel, stride=stride, nonlin=nonlin,
                             norm=norm, fast_pad=False)
    tmod = tblocks.ConvBlock(5, 7, kernel, stride=stride, nonlin=nonlin,
                             norm=norm)
    v = _carry(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), False), tmod, 1)
    want = jmod.apply(v, jnp.asarray(x), False)
    _close(_nhwc(tmod(_nchw(x))), want)


def test_pointwise_block_matches_flax():
    x = np.random.RandomState(2).randn(3, 50, 9).astype(np.float32)
    jmod = jblocks.PointwiseBlock(6)
    tmod = tblocks.PointwiseBlock(9, 6)
    v = _carry(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), tmod, 3)
    _close(tmod(torch.from_numpy(x)).detach().numpy(),
           jmod.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("num_layers,n_img", [(18, 1), (18, 2), (50, 1)])
def test_resnet_encoder_matches_flax(num_layers, n_img):
    x = np.random.RandomState(4).rand(2, 64, 96, 3 * n_img).astype(np.float32)
    jmod = jresnet.ResnetEncoder(num_layers, n_img)
    tmod = tresnet.ResnetEncoder(num_layers, n_img)
    v = _carry(jax.jit(jmod.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(x), False), tmod, 5)
    want = jax.jit(lambda v, x: jmod.apply(v, x, False))(v, jnp.asarray(x))
    got = tmod(_nchw(x))
    assert len(got) == 5
    for g, w in zip(got, want):
        _close(_nhwc(g), w, rel=2e-4)


def test_fusion_depth_decoder_matches_flax():
    x = np.random.RandomState(6).randn(2, 4, 6, 128).astype(np.float32)
    jmod = jdec.FusionDepthDecoder(level_in=2, num_ch_enc=(64, 64, 128))
    tmod = tdec.FusionDepthDecoder(2, (64, 64, 128))
    v = _carry(jmod.init(jax.random.PRNGKey(0), [jnp.asarray(x)]), tmod, 7)
    want = jmod.apply(v, [jnp.asarray(x)])
    got = tmod([_nchw(x)])
    assert set(got) == set(want) == {"disp/0"}
    _close(_nhwc(got["disp/0"]), want["disp/0"])


def test_pose_decoder_matches_flax():
    x = np.random.RandomState(8).randn(2, 6, 8, 128).astype(np.float32)
    jmod = jdec.PoseDecoder(1, stride=2)
    tmod = tdec.PoseDecoder(128, 1, stride=2)
    v = _carry(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), tmod, 9)
    want = jmod.apply(v, jnp.asarray(x))
    got = tmod(_nchw(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 1, 1, 3)
        _close(g.detach().numpy(), w)


@pytest.mark.parametrize("groups", [1, 2])
def test_bev_fold_matches_flax(groups):
    vz, vy, vx, gc = 3, 6, 8, 4
    x = np.random.RandomState(10).randn(2, vy * vx * vz,
                                        groups * gc + 1).astype(np.float32)
    jmod = jvfnet.BEVFold(out_ch=16, gc=gc, vz=vz, vy=vy, vx=vx)
    tmod = tvfnet.BEVFold(16, gc, vz, vy, vx)
    v = _carry(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), groups, False),
               tmod, 11)
    want = jmod.apply(v, jnp.asarray(x), groups, False)
    _close(_nhwc(tmod(torch.from_numpy(x), groups=groups)), want)


@pytest.fixture(scope="module")
def nets():
    """The tiny config's JAX model and its flax variables, and the port's
    model with the same weights."""
    cfg = jax_get_config(TINY)
    jm = JaxModel(cfg)
    ds = FakeDataset(num_samples=1, height=cfg.height, width=cfg.width,
                     fusion_level=cfg.fusion_level)
    batch = ds.batch([0])
    params, stats = jm.init(jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.RandomState(12)
    params, stats = _np_tree(params, rng), _np_tree(stats, rng)
    tm = VFDepthModel(get_config(TINY), device="cpu")
    load_flax_params(tm, params, stats)
    return jm, params, stats, tm, batch


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _jvars(params, stats, net):
    return {"params": params[net], "batch_stats": stats[net]}


def test_fused_depth_net_matches_flax(nets):
    jm, params, stats, tm, batch = nets
    v = _jvars(params, stats, "depth_net")
    img = batch["color_aug/0/0"]
    jfeats, jagg = jm.depth_net.apply(v, jnp.asarray(img), False,
                                      method="encode_aggregate")
    tfeats, tagg = tm.depth_net.encode_aggregate(torch.from_numpy(img))
    _close(tagg.detach().numpy(), jagg, rel=2e-4)

    rng = np.random.RandomState(13)
    n = int(np.prod(jm.cfg.voxel_size))
    feat = rng.randn(1, 2, n, jm.cfg.fusion_feat_in_dim + 1).astype(np.float32)
    count = rng.randint(0, 3, (1, n)).astype(np.float32)
    skips = [jfeats[i] for i in range(jm.fusion_level)]
    want = jm.depth_net.apply(
        v, jnp.asarray(feat), jnp.asarray(count), skips,
        jnp.asarray(batch["inv_K/3"]), jnp.asarray(batch["extrinsics"]),
        train=False, grouped=True, method="decode_from_backprojection")
    got = tm.depth_net.decode_from_backprojection(
        torch.from_numpy(feat), torch.from_numpy(count),
        tfeats[:tm.fusion_level], torch.from_numpy(batch["inv_K/3"]),
        torch.from_numpy(batch["extrinsics"]))
    _close(got["disp/0"].detach().numpy(), want["disp/0"])


def test_fused_pose_net_matches_flax(nets):
    jm, params, stats, tm, batch = nets
    v = _jvars(params, stats, "pose_net")
    curs = np.concatenate([batch["color_aug/-1/0"], batch["color_aug/0/0"]])
    nxts = np.concatenate([batch["color_aug/0/0"], batch["color_aug/1/0"]])
    want_agg = jm.pose_net.apply(v, jnp.asarray(curs), jnp.asarray(nxts),
                                 False, 2, method="encode_aggregate")
    got_agg = tm.pose_net.encode_aggregate(torch.from_numpy(curs),
                                           torch.from_numpy(nxts), n_ctx=2)
    assert got_agg.shape[-1] == 2 * jm.cfg.fusion_feat_in_dim
    _close(got_agg.detach().numpy(), want_agg, rel=2e-4)

    rng = np.random.RandomState(14)
    n = int(np.prod(jm.cfg.voxel_size))
    feat = rng.randn(1, 2, n, got_agg.shape[-1] + 1).astype(np.float32)
    count = rng.randint(0, 3, (1, n)).astype(np.float32)
    want = jm.pose_net.apply(v, jnp.asarray(feat), jnp.asarray(count), False,
                             2, True, method="pose_from_backprojection")
    got = tm.pose_net.pose_from_backprojection(
        torch.from_numpy(feat), torch.from_numpy(count), n_ctx=2)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 1, 1, 3)
        _close(g.detach().numpy(), w)


def test_load_flax_params_is_complete(nets):
    """Every flax leaf lands on a port tensor and every port parameter and
    buffer is set; a missing or a stray leaf raises."""
    _, params, stats, _, _ = nets
    tm = VFDepthModel(get_config(TINY), device="cpu", seed=1)
    load_flax_params(tm, params, stats)       # raises on any gap
    for name, t in tm.state_dict().items():
        if name.endswith("running_var"):
            np.testing.assert_array_equal(
                t.numpy(), _leaf(stats, name.replace(".bn.", ".BatchNorm_0.")
                                 .split(".")[:-1] + ["var"]))
    pruned = {k: dict(v) for k, v in params.items()}
    pruned["pose_net"] = {k: v for k, v in pruned["pose_net"].items()
                          if k != "pose_decoder"}
    with pytest.raises(ValueError, match="left unset"):
        load_flax_params(tm, pruned, stats)
    stray = {k: dict(v) for k, v in params.items()}
    stray["depth_net"]["extra"] = {"kernel": np.zeros((3, 3, 1, 1),
                                                      np.float32)}
    with pytest.raises(ValueError, match="without a port tensor"):
        load_flax_params(tm, stray, stats)
