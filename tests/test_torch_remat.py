"""Activation checkpointing (``tpu.remat``) in the port's training step, on
the CPU (the tiny config, plain kernel versions).

``VFDepthModel`` runs each net's train-mode calls under
``torch.utils.checkpoint`` where JAX's ``_remat_for`` says so (False,
True / 'all', 'depth_net', 'pose_net'), its recompute under
``models/blocks.py recomputing()``. For every value, merged and unmerged
back-projection and under ``aug_depth`` (BatchNorm moves twice a step in
the depth net's ``reduce_dim`` convs and decoder there, main then rotated
decode, as flax does):

* the recompute ran for the nets ``_remat_for`` names and no other
  (BatchNorm calls counted in the backward pass);
* the remat step equals the plain step: loss, scalar logs and every
  gradient within 1e-6 relative (measured: equal bit for bit on the CPU,
  the recompute repeats the same operations);
* the BatchNorm running statistics moved exactly once: equal to the plain
  step's, and moved from the init.

And ``remat: 'all'`` against JAX's remat step (``jax.checkpoint`` around
every ``_apply``; ``helpers_torch_step.jax_step``, one jit) at the bounds
of ``tests/test_torch_train_step.py``: logs 2e-5 of their magnitude (1e-3
for those that average over the auto-mask), gradients 5e-3 / 5e-2
relative L2 for the depth / pose net, BatchNorm statistics 1e-5.
"""
import numpy as np
import jax
import pytest
import torch

from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.data import FakeDataset
from vfdepth_tpu_torch.models import blocks
from vfdepth_tpu_torch.training.model import VFDepthModel

from helpers_torch_step import (check_batchnorm, check_gradients, check_logs,
                                step_pair)
from helpers_torch_threads import PORT_THREADS, port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
TINY = "configs/tiny_fake.yaml"
REMATS = [False, True, "all", "depth_net", "pose_net"]
LAYOUTS = ["merged", "unmerged", "aug"]


def _cfg(remat, layout):
    cfg = get_config(TINY)
    cfg.set("remat", remat)
    cfg.set("warp_window", False)
    cfg.set("merge_backprojection", layout != "unmerged")
    cfg.set("aug_depth", layout == "aug")
    return cfg


def _run(remat, layout):
    """One training forward and backward from the seeded init: (loss, scalar
    logs, gradients, buffers, BatchNorm calls in the forward, recomputed
    BatchNorm calls in the backward by net)."""
    cfg = _cfg(remat, layout)
    model = VFDepthModel(cfg, device="cpu", seed=3)
    batch = FakeDataset(num_samples=1, num_cams=cfg.num_cams,
                        height=cfg.height, width=cfg.width,
                        fusion_level=cfg.fusion_level).batch([0])
    noise = torch.randn(model.noise_shape(batch),
                        generator=torch.Generator().manual_seed(5))
    aug_u = (torch.rand(model.aug_shape(batch),
                        generator=torch.Generator().manual_seed(6))
             if layout == "aug" else None)
    calls = {"forward": 0, "depth_net": 0, "pose_net": 0}
    owner = {m: net for net in ("depth_net", "pose_net")
             for m in getattr(model, net).modules()}
    real = blocks.BatchNorm.forward

    def counted(bn, x):
        if blocks._RECOMPUTING.get():
            calls[owner[bn]] += 1
        else:
            calls["forward"] += 1
        return real(bn, x)

    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    blocks.BatchNorm.forward = counted
    try:
        _, loss, logs = model(batch, step=3, noise=noise, aug_u=aug_u)
        loss.backward()
    finally:
        blocks.BatchNorm.forward = real
        torch.set_num_threads(threads)
    return dict(
        loss=float(loss.detach()),
        logs={k: float(v.detach()) for k, v in logs.items() if v.dim() == 0},
        grads={k: p.grad.clone() for k, p in model.named_parameters()},
        buffers={k: b.clone() for k, b in model.named_buffers()},
        calls=calls)


@pytest.fixture(scope="module", params=LAYOUTS)
def plain(request):
    return request.param, _run(False, request.param)


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("remat", REMATS, ids=[str(r) for r in REMATS])
def test_remat_step_equals_plain_step(plain, remat):
    layout, want = plain
    got = _run(remat, layout)
    on = {net: remat in (True, "all", net) for net in ("depth_net",
                                                       "pose_net")}
    assert got["calls"]["forward"] == want["calls"]["forward"]
    for net, ran in on.items():
        # the recompute ran (every BatchNorm of the net once more, the
        # early stop of non-reentrant checkpoint aside) or did not run
        assert (got["calls"][net] > 0) == ran, (net, got["calls"])
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    assert set(got["logs"]) == set(want["logs"])
    for key, w in want["logs"].items():
        assert abs(got["logs"][key] - w) <= 1e-6 * max(abs(w), 1e-6), key
    for name, w in want["grads"].items():
        assert _rel(got["grads"][name], w) <= 1e-6, name
    moved = 0
    for name, w in want["buffers"].items():
        assert torch.equal(got["buffers"][name], w), name
        if name.endswith("running_mean"):
            moved += int(w.abs().max() > 0)
    assert moved > 0


@pytest.fixture(scope="module")
def jax_pair():
    jcfg, tcfg = jax_get_config(TINY), get_config(TINY)
    for cfg in (jcfg, tcfg):
        cfg.set("remat", "all")
        cfg.set("warp_window", False)
    batch = FakeDataset(num_samples=1, num_cams=tcfg.num_cams,
                        height=tcfg.height, width=tcfg.width,
                        fusion_level=tcfg.fusion_level).batch([0])
    return step_pair(jcfg, tcfg, batch)


def test_remat_all_logs_match_jax_remat_step(jax_pair):
    assert jax_pair["model"]._remat_for(jax_pair["model"].depth_net)
    check_logs(jax_pair, masked_tol=1e-3)


@pytest.mark.parametrize("net,tol", [("depth_net", 5e-3), ("pose_net", 5e-2)])
def test_remat_all_gradients_match_jax_remat_step(jax_pair, net, tol):
    check_gradients(jax_pair, net, tol)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_remat_all_batchnorm_matches_jax_remat_step(jax_pair, net):
    check_batchnorm(jax_pair, net)


def test_unknown_remat_raises():
    with pytest.raises(ValueError, match="remat"):
        VFDepthModel(_cfg("encoder", "merged"), device="cpu")
