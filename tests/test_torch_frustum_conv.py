"""The depth decode's frustum convolution ``VFNet.reduce_dim_1`` as one
convolution call an image (``models/blocks.py ConvBlock(per_image=True)``;
no JAX).

On the card, cuDNN's heuristics pick FFT tiling for the whole batch of a
decode (8,320 launches a call, f32) and an implicit GEMM for one image.
The route is taken where cuDNN runs the conv (``runs_cudnn``); these tests
stand in for the card by patching that test, except the one that holds
the CPU to one call a batch (bit for bit the whole-batch block). The two
routes compute the same function: the per-image route is held against the
whole-batch one on the same values, forward and gradients, within its
summation order's rounding (f32 1e-5 of the largest magnitude; bf16 one
bf16 step, 2^-7, as each output is rounded once). Gradients are compared
without the activation, whose kink a rounding can cross.
``ConvBlock.per_image_calls`` counts the per-image forwards: 1 a depth
decode, 2 under ``aug_depth``, 0 on the pose path and in the fsm nets.
"""
import numpy as np
import pytest
import torch

from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.data.fake import FakeDataset
from vfdepth_tpu_torch.models import blocks
from vfdepth_tpu_torch.models.blocks import ConvBlock
from vfdepth_tpu_torch.training.model import VFDepthModel

from helpers_torch_threads import port_threads  # noqa: F401

BOUND = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.fixture
def as_on_card(monkeypatch):
    """The per-image route taken as where cuDNN runs the convs."""
    monkeypatch.setattr(blocks, "runs_cudnn", lambda x: True)


def _cfg(**over):
    cfg = presets.micro_config(**over)
    cfg.set("warp_window", False)
    return cfg


def _batch(cfg):
    return FakeDataset(num_samples=1, num_cams=cfg.num_cams,
                       height=cfg.height, width=cfg.width,
                       fusion_level=cfg.fusion_level,
                       rig="nuscenes").batch([0])


@pytest.fixture(scope="module")
def micro_models():
    """The micro fusion model in f32 and under mixed precision (bf16), and
    a batch of its rig."""
    cfg = _cfg()
    return {torch.float32: VFDepthModel(cfg, device="cpu"),
            torch.bfloat16: VFDepthModel(_cfg(mixed_precision=True),
                                         device="cpu")}, _batch(cfg)


def _close(got, want, dtype, what):
    got, want = got.detach().float(), want.detach().float()
    scale = want.abs().max().clamp_min(1e-30)
    err = float((got - want).abs().max() / scale)
    assert err <= BOUND[dtype], f"{what}: {err:.3g} > {BOUND[dtype]:.3g}"


@pytest.mark.parametrize("layer", ["reduce_dim_0", "reduce_dim_1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_block_per_image_matches_batch(micro_models, as_on_card, dtype,
                                            layer):
    """Forward, input gradient, weight and bias gradients of the block one
    image a call against the block on the whole batch, at the micro
    config's frustum convs' channels and pixels."""
    net = micro_models[0][torch.float32].depth_net.fusion_net
    conv = getattr(net, layer).conv
    cin, cout = conv.in_channels, conv.out_channels
    torch.manual_seed(3)
    compute = None if dtype == torch.float32 else dtype
    block = ConvBlock(cin, cout, 3, dtype=compute)
    x = torch.randn(3, cin, net.img_h, net.img_w).to(dtype)

    def run(per_image, nonlin):
        block.per_image, block.nonlin = per_image, nonlin
        inp = x.clone().requires_grad_(True)
        return inp, block(inp)

    before = ConvBlock.per_image_calls
    _, y = run(True, "LRU")
    assert ConvBlock.per_image_calls == before + 1
    _, want = run(False, "LRU")
    assert ConvBlock.per_image_calls == before + 1
    assert y.shape == want.shape and y.dtype == want.dtype == dtype
    _close(y, want, dtype, "forward")
    g = torch.randn(want.shape).to(dtype)
    params = [block.conv.weight, block.conv.bias]
    grads = {}
    for per_image in (True, False):
        inp, out = run(per_image, None)
        grads[per_image] = torch.autograd.grad(out, [inp] + params, g)
    for what, a, b in zip(("input", "weight", "bias"), grads[True],
                          grads[False]):
        _close(a, b, dtype, f"{what} gradient")


def _frustum(model, batch, seed):
    net = model.depth_net.fusion_net
    lev = model.fusion_level + 1
    n = int(np.prod(net.voxel_size))
    gen = torch.Generator().manual_seed(seed)
    vox = torch.randn(1, n, net.reduce_dim_0.conv.in_channels
                      // net.proj_d_bins, generator=gen)
    return (net, vox, torch.from_numpy(batch[f"inv_K/{lev}"]),
            torch.from_numpy(batch["extrinsics"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_project_voxel_into_image_per_image(micro_models, as_on_card,
                                            monkeypatch, dtype):
    """A decode runs ``reduce_dim_1`` one image a call (1 counted), hands
    the decoder NCHW [cams, feat_out_dim, h, w], and gives the whole-batch
    route's output and volume gradient."""
    models, batch = micro_models
    net, vox, inv_k, ext = _frustum(models[dtype], batch, 5)
    vox = vox.to(dtype).requires_grad_(True)
    assert net.reduce_dim_1.per_image and not net.reduce_dim_0.per_image
    before = ConvBlock.per_image_calls
    out = net.project_voxel_into_image(vox, inv_k, ext, plain=True)
    assert ConvBlock.per_image_calls == before + 1
    assert out.shape == (inv_k.shape[1], net.reduce_dim_1.conv.out_channels,
                         net.img_h, net.img_w)
    assert out.dtype == dtype
    g = torch.randn(out.shape).to(dtype)
    (gv,) = torch.autograd.grad(out, vox, g)
    monkeypatch.setattr(net.reduce_dim_1, "per_image", False)
    want = net.project_voxel_into_image(vox, inv_k, ext, plain=True)
    assert ConvBlock.per_image_calls == before + 1
    (wv,) = torch.autograd.grad(want, vox, g)
    _close(out, want, dtype, "output")
    _close(gv, wv, dtype, "volume gradient")


def test_per_image_calls_per_decode_and_pose(micro_models, as_on_card):
    """1 a predict (one decode of the frame's cameras), 2 with the
    depth-synthesis branch's rotated decode, 0 through
    ``pose_voxel_to_bev``."""
    models, batch = micro_models
    model = models[torch.float32]
    before = ConvBlock.per_image_calls
    model.predict(batch)
    assert ConvBlock.per_image_calls == before + 1
    pose = model.pose_net.fusion_net
    n = int(np.prod(pose.voxel_size))
    gen = torch.Generator().manual_seed(6)
    feat = torch.randn(1, 2, n, pose.reduce_dim_0.gc + 1, generator=gen)
    count = torch.randint(0, 3, (1, n), generator=gen).float()
    with torch.no_grad():
        pose.pose_voxel_to_bev(feat, count)
    assert ConvBlock.per_image_calls == before + 1
    aug = VFDepthModel(_cfg(aug_depth=True), device="cpu")
    aug_u = torch.rand(aug.aug_shape(batch), generator=gen)
    aug.predict(batch, aug_u=aug_u)
    assert ConvBlock.per_image_calls == before + 3


def test_fsm_nets_take_no_per_image_route(as_on_card):
    cfg = _cfg(depth_model="fsm", pose_model="fsm", height=64, width=128)
    model = VFDepthModel(cfg, device="cpu")
    assert not any(m.per_image for m in model.modules()
                   if isinstance(m, ConvBlock))
    before = ConvBlock.per_image_calls
    model.predict(_batch(cfg))
    assert ConvBlock.per_image_calls == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_runs_the_whole_batch(dtype):
    """Off the card a per-image block is the whole-batch block, bit for bit,
    forward and gradients, and counts nothing."""
    torch.manual_seed(7)
    compute = None if dtype == torch.float32 else dtype
    block = ConvBlock(256, 16, 3, dtype=compute, per_image=True)
    x = torch.randn(4, 256, 6, 10).to(dtype)
    g = torch.randn(4, 16, 6, 10).to(dtype)
    outs = []
    before = ConvBlock.per_image_calls
    for per_image in (True, False):
        block.per_image = per_image
        inp = x.clone().requires_grad_(True)
        y = block(inp)
        outs.append((y,) + torch.autograd.grad(
            y, [inp, block.conv.weight, block.conv.bias], g))
    assert ConvBlock.per_image_calls == before
    for a, b in zip(*outs):
        assert torch.equal(a, b)
