"""Depth synthesis (``training.aug_depth``) in the port against the plain
reference of the benchmark (``benchmark/reference/synthesis.py``) on the
CPU.

The published augdepth configuration at the benchmark's micro size (6
cameras at 64x96, a 24x24x8 voxel grid), with ``focal_length_scale`` 30:
at 96 pixels' width the published 300 puts every depth under
``min_depth``, where the warp masks every pixel and the consistency term
reads 0. The port and the reference get the same seeded weights, batch,
tie-break noise and rotation draw ``aug_u``, and run one training forward
(BatchNorm on batch statistics). Compared: the rotated views' disparity
and depth, the port's depth warp (``render_views``' ``tform_depth`` /
``tform_mask``, as the step computed them) against the reference's
``warp_depth`` on the same inputs, and the step's ``depth_con_loss`` /
``depth_sm_loss`` logs against the reference's ``depth_synthesis_loss``
on its own decode and warp.
"""
import pytest
import torch

from benchmark import micro, program, scene
from benchmark import weights as weights_mod
from benchmark.augdepth_probe import augdepth
from benchmark.reference.geometry import invert
from benchmark.reference.model import RefModel, draw
from benchmark.reference.synthesis import (augment_extrinsics,
                                           depth_synthesis_loss, warp_depth)
from vfdepth_tpu_torch.training import model as model_mod
from helpers_torch_threads import fixed_threads, port_threads  # noqa: F401

SEED = 2 ** 33 + 11     # larger than 32 bits, as the benchmark's are


def _config() -> dict:
    cfg = augdepth(micro.config("vfdepth_ddad_fusion"))
    cfg["training"]["focal_length_scale"] = 30
    return cfg


def _warp(ref, x, depth, depth_aug, ext_aug):
    """The reference's warp of every camera's neighbours' depths and its
    own into its rotated view, as its loss builds it."""
    rel = ref.rel_cam_rows
    cams = rel.shape[0]
    idx = torch.cat([torch.clamp(rel, min=0), torch.arange(cams)[:, None]], 1)
    valid = torch.cat([rel >= 0, torch.ones(cams, 1, dtype=torch.bool)], 1)
    n = idx.shape[1]

    def bc(t):
        return t[:, :, None].expand(t.shape[:2] + (n,) + t.shape[2:])
    rel_pose = torch.einsum("bcij,bcnjk->bcnik", invert(ext_aug),
                            x["extrinsics"][:, idx])
    td, tm = warp_depth(depth[:, idx], x["mask"][:, idx],
                        x["inv_K/0"][:, idx], x["K/0"][:, idx],
                        bc(depth_aug), bc(x["inv_K/0"]), rel_pose,
                        ref.min_depth, ref.max_depth)
    return td, tm * valid.float()[None, :, :, None, None, None]


def _forwards() -> dict:
    """(port outputs, port logs, the port's render_views call (args,
    kwargs, result), the reference's inputs, rotated extrinsics, depths
    and rotated disparities and depths, the reference model)."""
    cfg = _config()
    port = program.build_model(cfg, SEED, "cpu")
    ref = RefModel.on(cfg, "cpu")
    weights_mod.load(ref, weights_mod.make(program.param_spec(cfg), SEED,
                                           "cpu"))
    batch = scene.collate(scene.make_framesets(2, SEED, cfg, "cpu"))
    drawn = draw(ref, batch, torch.Generator().manual_seed(3))
    calls = []
    render = model_mod.render_views

    def spy(*args, **kwargs):
        out = render(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    model_mod.render_views = spy
    try:
        with fixed_threads(), torch.no_grad():
            outputs, _, logs = port.forward(batch, noise=drawn["noise"],
                                            aug_u=drawn["aug_u"], train=True)
    finally:
        model_mod.render_views = render
    ref.train()
    x = ref.inputs(batch, "cpu")
    ext_aug = augment_extrinsics(drawn["aug_u"], x["extrinsics"],
                                 ref.aug_angle)
    with fixed_threads(), torch.no_grad():
        _, disps, disps_aug = ref._predict(x, ext_aug)
    depth = ref.to_depth(disps[0], x["K/0"])
    depth_aug = ref.to_depth(disps_aug[0], x["K/0"])
    assert len(calls) == 1      # one scale
    return dict(outputs=outputs, logs=logs, call=calls[0], x=x,
                ext_aug=ext_aug, depth=depth, disp_aug=disps_aug[0],
                depth_aug=depth_aug, ref=ref)


@pytest.fixture(scope="module")
def runs():
    return _forwards()


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got - want).abs() / want.abs()).max())


def test_rotated_views_disparity_and_depth(runs):
    # both float32; the frustum samplers sum their taps in other orders
    # (the serving check's bound, test_bench_reference.py). bf16 rounds at
    # 2^-8 relative, ~400 times over it
    got = runs["outputs"]
    assert got["disp/0/aug"].shape == runs["disp_aug"].shape
    assert _rel(got["disp/0/aug"], runs["disp_aug"]) < 1e-5
    assert _rel(got["depth/0/aug"], runs["depth_aug"]) < 1e-5
    # the rotation moved the views: the test is not of the main decode
    assert _rel(got["disp/0/aug"], got["disp/0"]) > 1e-2


def test_depth_warp(runs):
    args, kwargs, out = runs["call"]
    td, tm = _warp(runs["ref"], runs["x"], args[4], kwargs["depth_aug"],
                   kwargs["extrinsics_aug"])
    assert out.tform_depth.shape == td.shape
    assert float(tm.sum()) > 0.05 * tm.numel(), "the warp masks it all"
    # the same inputs and float32 arithmetic in another order: a target
    # pixel whose coordinate lands within rounding of a source pixel's
    # nearest tie, or a depth within rounding of a range bound, may flip
    # its mask. No pixel does here; bf16 coordinates (2^-8 of a 96-pixel
    # width) would move many
    assert torch.equal(out.tform_depth_mask, tm)
    on = tm > 0
    # bilinear samples of the same depths at coordinates equal to float32
    # rounding; bf16 depths would sit 2^-8 relative away
    assert _rel(out.tform_depth[on], td[on]) < 1e-5


def test_synthesis_loss_terms(runs):
    r = runs
    td, tm = _warp(r["ref"], r["x"], r["depth"], r["depth_aug"],
                   r["ext_aug"])
    con, sm = depth_synthesis_loss(r["depth_aug"], td, tm, r["disp_aug"])
    logs = r["logs"]
    assert float(con.mean()) > 0
    # each chain (decode, depth, warp, loss) in float32 on its own: the
    # terms are means over thousands of pixels, each within 1e-5 of the
    # other side's; a bf16 chain moves them by ~1e-3 relative
    assert abs(float(logs["depth_con_loss"]) - float(con.mean())) \
        < 1e-4 * float(con.mean())
    assert abs(float(logs["depth_sm_loss"]) - float(sm.mean())) \
        < 1e-4 * float(sm.mean())
