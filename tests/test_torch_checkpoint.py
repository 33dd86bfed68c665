"""The port's checkpoints (``vfdepth_tpu_torch/training/checkpoint.py``) on
the CPU: PyTorch files in the reference's ``weights_<epoch>`` layout.

Exact comparisons throughout (no tolerance): a save and a load copy the
tensors, so parameters, BatchNorm statistics, Adam's moments and the step
count come back bit for bit. A checkpoint written on the card and read on
the CPU (and back) is checked on the card, in ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py``; here the loader is held to pass the
model's device as ``map_location`` for every file it reads.
"""
import os

import pytest
import torch

from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.data import FakeDataset
from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                        load_checkpoint, save_checkpoint,
                                        train_step)
from vfdepth_tpu_torch.training import checkpoint as ckpt
from helpers_torch_threads import port_threads  # noqa: F401

STEPS = 2


def _trained(seed=0, **over):
    """A micro model and its optimizer after ``STEPS`` steps (Adam's moments
    and the BatchNorm statistics moved)."""
    cfg = presets.micro_config(**over)
    model = VFDepthModel(cfg, device="cpu", seed=seed)
    opt = create_train_state(model, steps_per_epoch=4)
    ds = FakeDataset(num_samples=STEPS, num_cams=cfg.num_cams,
                     height=cfg.height, width=cfg.width,
                     fusion_level=cfg.fusion_level, rig="nuscenes")
    gen = torch.Generator().manual_seed(seed)
    for step in range(STEPS):
        train_step(model, opt, ds.batch([step]), step, gen)
    return model, opt


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _assert_same_optimizer(a, b):
    pa = [p for g in a.param_groups for p in g["params"]]
    pb = [p for g in b.param_groups for p in g["params"]]
    assert len(pa) == len(pb)
    for x, y in zip(pa, pb):
        sx, sy = a.state[x], b.state[y]
        assert sx.keys() == sy.keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k in sx:
            assert torch.equal(sx[k], sy[k]), k
        assert sy["step"].device.type == "cpu"


def test_round_trip_is_bit_exact(tmp_path):
    model, opt = _trained()
    path = save_checkpoint(str(tmp_path), 3, model, opt, step=STEPS)
    assert path == os.path.join(str(tmp_path), "weights_3")
    assert sorted(os.listdir(path)) == ["adam.pth", "depth_net.pth",
                                        "pose_net.pth"]
    fresh = VFDepthModel(model.cfg, device="cpu", seed=7)
    fresh_opt = create_train_state(fresh, steps_per_epoch=4)
    assert load_checkpoint(path, fresh, fresh_opt) == STEPS
    _assert_same_state(model, fresh)
    _assert_same_optimizer(opt, fresh_opt)
    # the live optimizer keeps its own schedule
    for g, h in zip(opt.param_groups, fresh_opt.param_groups):
        assert {k: v for k, v in g.items() if k != "params"} == \
            {k: v for k, v in h.items() if k != "params"}
    # one more step from both gives the same bits
    ds = FakeDataset(num_samples=1, num_cams=model.cfg.num_cams,
                     height=model.cfg.height, width=model.cfg.width,
                     fusion_level=model.cfg.fusion_level, rig="nuscenes")
    for m, o in ((model, opt), (fresh, fresh_opt)):
        train_step(m, o, ds.batch([0]), STEPS, torch.Generator().manual_seed(5))
    _assert_same_state(model, fresh)


def test_partial_load_leaves_other_nets(tmp_path):
    model, opt = _trained()
    path = save_checkpoint(str(tmp_path), 0, model, opt, step=STEPS)
    other = VFDepthModel(model.cfg, device="cpu", seed=3)
    pose_before = {k: v.clone() for k, v in other.pose_net.state_dict().items()}
    other_opt = create_train_state(other)
    assert load_checkpoint(path, other, other_opt,
                           models_to_load=["depth_net"],
                           load_optimizer=False) is None
    assert not other_opt.state                 # the optimizer untouched
    for k, v in other.depth_net.state_dict().items():
        assert torch.equal(v, model.depth_net.state_dict()[k]), k
    for k, v in other.pose_net.state_dict().items():
        assert torch.equal(v, pose_before[k]), k
    assert any(not torch.equal(v, model.pose_net.state_dict()[k])
               for k, v in pose_before.items())


def test_optimizer_from_another_config_falls_back(tmp_path, capsys):
    """The nets load; an Adam state saved for other shapes leaves a fresh
    optimizer, with the JAX package's message, and no step."""
    model, opt = _trained()
    path = save_checkpoint(str(tmp_path), 0, model, opt, step=STEPS)
    wide, wide_opt = _trained(fusion_feat_in_dim=24)
    torch.save({"optimizer": wide_opt.state_dict(), "step": 9},
               os.path.join(path, ckpt.OPTIMIZER_FILE))
    fresh = VFDepthModel(model.cfg, device="cpu", seed=4)
    fresh_opt = create_train_state(fresh)
    assert load_checkpoint(path, fresh, fresh_opt) is None
    assert "Cannot load optimizer state" in capsys.readouterr().out
    assert not fresh_opt.state
    _assert_same_state(model, fresh)


def test_key_mismatch_warns(tmp_path, capsys):
    model, opt = _trained()
    path = save_checkpoint(str(tmp_path), 0, model, opt, step=STEPS)
    sd = torch.load(os.path.join(path, "pose_net.pth"), weights_only=True)
    sd["renamed.weight"] = sd.pop(next(iter(sd)))
    torch.save(sd, os.path.join(path, "pose_net.pth"))
    load_checkpoint(path, VFDepthModel(model.cfg, device="cpu"),
                    load_optimizer=False)
    assert "key mismatch for 'pose_net'" in capsys.readouterr().out


def test_loads_onto_the_models_device(tmp_path, monkeypatch):
    model, opt = _trained()
    path = save_checkpoint(str(tmp_path), 0, model, opt, step=STEPS)
    seen = []
    real_load = torch.load

    def recording(f, *args, **kwargs):
        seen.append((os.path.basename(f), kwargs.get("map_location"),
                     kwargs.get("weights_only")))
        return real_load(f, *args, **kwargs)
    monkeypatch.setattr(ckpt.torch, "load", recording)
    fresh = VFDepthModel(model.cfg, device="cpu", seed=1)
    load_checkpoint(path, fresh, create_train_state(fresh))
    assert sorted(seen) == [(name, fresh.device, True) for name in
                            ("adam.pth", "depth_net.pth", "pose_net.pth")]


def test_missing_checkpoint_raises(tmp_path):
    model = VFDepthModel(presets.micro_config(), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "weights_0"), model)
