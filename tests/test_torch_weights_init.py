"""ImageNet encoder init of the port (``model.weights_init: true``,
``vfdepth_tpu_torch/models/torchvision_init.py``) against the JAX
package's (``vfdepth_tpu/models/torchvision_init.py``), on the CPU.

No ImageNet file is in the repository and nothing is fetched: each test
writes a synthetic state dict in torchvision's layout (seeded numpy, with
the downsample branches, the running statistics, ``num_batches_tracked``
and the ``fc`` head the loaders skip) as ``.npz`` and as ``.pth``, and
names it by ``VFDEPTH_RESNET_WEIGHTS``.

* Every encoder tensor of the fusion and the fsm nets (depth net of one
  image, pose net of two, its conv1 tiled and halved), parameters and
  BatchNorm statistics, equals JAX's loaded tree exactly, from either
  file; so do standalone ResNet-18, 34 and 50 encoders.
* ``predict`` from the loaded encoders (the other weights carried over
  from the flax init) matches JAX's at the f32 tolerances of
  ``tests/test_torch_model.py`` (1e-4 of the magnitude, poses 1e-5).
* With no file: a warning, and the random init unchanged.
* A truncated file, one that lacks a tensor or one with a misshapen
  tensor raises (JAX warns or raises there; the port never trains from a
  silently random encoder).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.models import torchvision_init as jax_tvi
from vfdepth_tpu.models.resnet import ResnetEncoder as JaxEncoder
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.models import torchvision_init as tvi
from vfdepth_tpu_torch.models.resnet import ResnetEncoder
from vfdepth_tpu_torch.training.model import VFDepthModel

from helpers_torch_step import by_port_name
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
TINY = "configs/tiny_fake.yaml"
ENV = "VFDEPTH_RESNET_WEIGHTS"
BLOCKS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3]}


def torchvision_state(num_layers: int, seed: int = 0):
    """A ResNet state dict in torchvision's names and shapes (OIHW convs,
    BatchNorm weight / bias / running_mean / running_var /
    num_batches_tracked, the fc head), seeded numpy values."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = (rng.standard_normal((cout, cin, k, k))
                                / np.sqrt(cin * k * k)).astype(np.float32)

    def bn(name, ch):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, ch).astype(np.float32)
        sd[f"{name}.bias"] = (rng.standard_normal(ch) * 0.1).astype(
            np.float32)
        sd[f"{name}.running_mean"] = (rng.standard_normal(ch) * 0.1).astype(
            np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 2.0, ch).astype(
            np.float32)
        sd[f"{name}.num_batches_tracked"] = np.asarray(100, np.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    bottleneck = num_layers == 50
    cin = 64
    for stage, (n_blocks, width) in enumerate(zip(BLOCKS[num_layers],
                                                  [64, 128, 256, 512])):
        out = width * (4 if bottleneck else 1)
        for blk in range(n_blocks):
            t = f"layer{stage + 1}.{blk}"
            stride = 2 if stage > 0 and blk == 0 else 1
            if bottleneck:
                conv(f"{t}.conv1", width, cin, 1)
                conv(f"{t}.conv2", width, width, 3)
                conv(f"{t}.conv3", out, width, 1)
                for k in (1, 2, 3):
                    bn(f"{t}.bn{k}", out if k == 3 else width)
            else:
                conv(f"{t}.conv1", width, cin, 3)
                conv(f"{t}.conv2", width, width, 3)
                bn(f"{t}.bn1", width)
                bn(f"{t}.bn2", width)
            if stride != 1 or cin != out:
                conv(f"{t}.downsample.0", out, cin, 1)
                bn(f"{t}.downsample.1", out)
            cin = out
    sd["fc.weight"] = rng.standard_normal((1000, cin)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


def write(sd, path):
    if str(path).endswith(".npz"):
        np.savez(path, **sd)
    else:
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   path)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("resnet")
    sd = torchvision_state(18)
    return {"sd": sd, "npz": write(sd, root / "resnet18.npz"),
            "pth": write(sd, root / "resnet18.pth")}


def _cfgs(pair):
    jcfg, tcfg = jax_get_config(TINY), get_config(TINY)
    for cfg in (jcfg, tcfg):
        cfg.set("weights_init", True)
        cfg.set("depth_model", pair)
        cfg.set("pose_model", pair)
        cfg.set("warp_window", False)
    return jcfg, tcfg


def _batch(cfg):
    return FakeDataset(num_samples=1, num_cams=cfg.num_cams,
                       height=cfg.height, width=cfg.width,
                       fusion_level=cfg.fusion_level).batch([0])


@pytest.fixture(scope="module", params=["fusion", "fsm"])
def loaded(request, files):
    """JAX's init with the .npz file (jitted predict of it), and the port's
    models built with either file; one JAX init per pair."""
    pair = request.param
    jcfg, tcfg = _cfgs(pair)
    batch = _batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    old = os.environ.get(ENV)
    try:
        os.environ[ENV] = files["npz"]
        jm = JaxModel(jcfg)
        params, stats = jm.init(jax.random.PRNGKey(0), jbatch)
        ports = {}
        for fmt in ("npz", "pth"):
            os.environ[ENV] = files[fmt]
            ports[fmt] = VFDepthModel(tcfg, device="cpu")
    finally:
        if old is None:
            os.environ.pop(ENV, None)
        else:
            os.environ[ENV] = old

    def run(p, s, b):
        if jm._can_merge_backproject():
            cam, disps, *_ = jm.predict_pose_depth(
                p, s, b, jax.random.PRNGKey(1), False)
        else:
            cam, _ = jm.predict_pose(p["pose_net"], s["pose_net"], b, False)
            disps, *_ = jm.predict_depth(p["depth_net"], s["depth_net"], b,
                                         jax.random.PRNGKey(1), False)
        return cam, disps[0], jm.to_depth(disps[0], b["K/0"])
    fn = jax.jit(run).lower(params, stats, jbatch).compile()
    want = [np.asarray(a) for a in fn(params, stats, jbatch)]
    tree = {**by_port_name(jax.tree_util.tree_map(np.asarray, params)),
            **by_port_name(jax.tree_util.tree_map(np.asarray, stats))}
    return dict(pair=pair, batch=batch, tree=tree, ports=ports, want=want)


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_encoders_equal_jax_loaded_tree(loaded, files, fmt):
    model = loaded["ports"][fmt]
    state = model.state_dict()
    names = [k for k in loaded["tree"] if ".encoder." in k]
    # ResNet-18 a net: conv1 and bn1 (5 tensors), 8 blocks of 2 convs and
    # 2 BatchNorms (80), 3 downsample branches (15)
    assert len(names) == 2 * 100, len(names)
    for net in ("depth_net", "pose_net"):
        mine = {k for k in state if k.startswith(f"{net}.encoder.")
                and not k.endswith("num_batches_tracked")}
        assert mine == {k for k in names if k.startswith(f"{net}.")}, net
    for name in names:
        got = state[name].numpy()
        want = loaded["tree"][name]
        assert got.shape == want.shape, name
        assert np.array_equal(got, want), name
    # the file's own values: the depth conv1 as is, the pose conv1 tiled
    # over its two frames and halved, every BatchNorm statistic
    sd = files["sd"]
    assert np.array_equal(state["depth_net.encoder.conv1.weight"].numpy(),
                          sd["conv1.weight"])
    assert np.array_equal(state["pose_net.encoder.conv1.weight"].numpy(),
                          np.concatenate([sd["conv1.weight"]] * 2, 1) / 2)
    assert np.array_equal(
        state["pose_net.encoder.layer3_0.downsample_bn.bn.running_var"]
        .numpy(), sd["layer3.0.downsample.1.running_var"])


def test_predict_from_loaded_encoders_matches_jax(loaded):
    """The port's loaded encoders, the rest of the nets carried over from
    the flax init, serve what JAX serves."""
    model = loaded["ports"]["pth"]
    rest = {k: torch.from_numpy(np.array(v)) for k, v in
            loaded["tree"].items() if ".encoder." not in k}
    missing, unexpected = model.load_state_dict(rest, strict=False)
    assert not unexpected
    assert all(".encoder." in k or k.endswith("num_batches_tracked")
               for k in missing)
    got = model.predict(loaded["batch"])
    for key, w in zip(("cam_T_cam", "disp/0", "depth/0"), loaded["want"]):
        g = got[key].numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), key
        atol = 1e-5 if key == "cam_T_cam" else 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("num_layers", [18, 34, 50])
def test_encoder_depths_match_jax(tmp_path, num_layers):
    """Standalone encoders of every supported depth, one and two images:
    the port's loader writes exactly JAX's loaded tree."""
    sd = torchvision_state(num_layers, seed=num_layers)
    path = write(sd, tmp_path / f"resnet{num_layers}.pth")
    for n_imgs in (1, 2):
        variables = jax.jit(JaxEncoder(num_layers, n_imgs).init,
                            static_argnames=("train",))(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3 * n_imgs)),
            train=False)
        p, s = jax_tvi.load_resnet_encoder_params(
            dict(variables["params"]), dict(variables["batch_stats"]),
            num_layers=num_layers, num_input_images=n_imgs,
            weights_path=path)
        want = {**by_port_name(jax.tree_util.tree_map(np.asarray, p)),
                **by_port_name(jax.tree_util.tree_map(np.asarray, s))}
        enc = ResnetEncoder(num_layers, n_imgs)
        assert tvi.load_resnet_encoder_params(enc, num_layers, n_imgs, path)
        state = {k: v for k, v in enc.state_dict().items()
                 if not k.endswith("num_batches_tracked")}
        assert set(state) == set(want)
        for name, w in want.items():
            assert np.array_equal(state[name].numpy(), w), name


def test_no_file_warns_and_keeps_random_init(monkeypatch, tmp_path):
    _, tcfg = _cfgs("fusion")
    monkeypatch.setenv(ENV, str(tmp_path / "absent.pth"))
    assert tvi.find_resnet_weights(18) is None
    with pytest.warns(UserWarning, match="no pretrained ResNet weights"):
        model = VFDepthModel(tcfg, device="cpu")
    tcfg.set("weights_init", False)
    plain = VFDepthModel(tcfg, device="cpu")
    for (name, a), b in zip(model.state_dict().items(),
                            plain.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("fault", ["truncated-npz", "truncated-pth",
                                   "missing-key", "misshapen"])
def test_broken_file_raises(monkeypatch, tmp_path, files, fault):
    _, tcfg = _cfgs("fusion")
    sd = dict(files["sd"])
    if fault.startswith("truncated"):
        fmt = fault.split("-")[1]
        data = open(files[fmt], "rb").read()
        path = tmp_path / f"cut.{fmt}"
        path.write_bytes(data[:len(data) // 2])
        err, match = ValueError, "could not load"
    elif fault == "missing-key":
        del sd["layer3.1.bn2.running_var"]
        path = write(sd, tmp_path / "missing.npz")
        err, match = KeyError, "layer3.1.bn2.running_var"
    else:
        key = "layer2.0.downsample.0.weight"
        sd[key] = sd[key][:64]
        path = write(sd, tmp_path / "misshapen.pth")
        err, match = ValueError, "does not fit"
    monkeypatch.setenv(ENV, str(path))
    with pytest.raises(err, match=match):
        VFDepthModel(tcfg, device="cpu")
