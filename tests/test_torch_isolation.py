"""The port stands alone: it imports no JAX and nothing of ``vfdepth_tpu``,
and it never falls back to the CPU silently."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.data import FakeDataset
from vfdepth_tpu_torch.training.model import VFDepthModel
from helpers_torch_threads import port_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "vfdepth_tpu_torch"
# the training slice's modules, the evaluation / training loop's and the
# data parallelism's, named so a lost module fails loudly
TRAINING_MODULES = ("geometry.view_rendering", "losses.primitives",
                    "losses.composite", "ops.warp", "ops.ties",
                    "training.step", "utils.metrics", "utils.visualize",
                    "utils.logger", "data.synthetic_scene", "data.factory",
                    "data.loader", "training.checkpoint", "training.trainer",
                    "eval", "train", "data.depth_projection", "native",
                    "data.transforms", "data.ddad", "data.nuscenes",
                    "ops.grid_sample", "training.synthesis",
                    "parallel", "parallel.distributed", "parallel.mesh",
                    "parallel.data_parallel")
# files outside both packages that import JAX: the JAX package's own entry
# points and scripts, and the one converter that carries its checkpoints
# into the port
JAX_SIDE_FILES = {
    "__graft_entry__.py", "bench.py", "eval.py", "train.py",
    *(f"scripts/{name}.py" for name in (
        "cold_start_diag", "cold_start_multiseed", "dump_tail_ops",
        "op_rooflines", "smoke_forward", "time_gs3d", "time_gs3d_packed",
        "time_kernels", "time_sweep", "time_warp_mxu", "tpu_ablate",
        "tpu_bench_all", "tpu_learn_probe", "tpu_profile"))}
BLOCK_JAX = ("import sys\n"
             "for name in ('jax', 'jaxlib', 'flax', 'optax', 'vfdepth_tpu'):\n"
             "    sys.modules[name] = None\n")
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|vfdepth_tpu)\b",
                       re.M)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_without_jax():
    """Every module of the port imports with jax, flax, optax and the JAX
    package blocked."""
    code = (
        BLOCK_JAX + "import pkgutil, importlib\n"
        "import vfdepth_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                               pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print('imported', ' '.join(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout
    imported = set(res.stdout.split())
    for name in TRAINING_MODULES:
        assert f"vfdepth_tpu_torch.{name}" in imported, name


def test_no_jax_imports_in_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_only_the_converter_joins_the_two_packages():
    """Outside the two packages, the files that import JAX are the JAX
    package's own entry points and scripts, and the checkpoint converter;
    none of the port's."""
    files = sorted(ROOT.glob("*.py")) + sorted((ROOT / "scripts").glob("*.py"))
    importers = {str(p.relative_to(ROOT)) for p in files
                 if FORBIDDEN.search(p.read_text())}
    assert importers - JAX_SIDE_FILES == {"scripts/convert_jax_checkpoint.py"}
    assert "chip_smoke.py" not in importers


@pytest.mark.parametrize("cli", ["eval", "train"])
def test_port_clis_show_help_without_jax(cli):
    code = (BLOCK_JAX + "import runpy\n"
            f"sys.argv = ['vfdepth_tpu_torch.{cli}', '--help']\n"
            f"runpy.run_module('vfdepth_tpu_torch.{cli}', run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "--config_file" in res.stdout and "--cpu" in res.stdout


def test_loop_and_clis_need_cuda_unless_cpu_is_asked(monkeypatch):
    """``resolve_device`` stays the default of the loader's prefetch, the
    trainer (through its model) and both command lines."""
    from vfdepth_tpu_torch import eval as eval_cli
    from vfdepth_tpu_torch import train as train_cli
    from vfdepth_tpu_torch.data import device_prefetch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(device_prefetch(iter([{"x": [1.0]}])))
    assert next(device_prefetch(iter([{"x": [1.0]}]), device="cpu"))["x"] \
        .device.type == "cpu"
    args = ["--config_file", "configs/tiny_fake.yaml"]
    for cli in (eval_cli, train_cli):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args)


def test_model_needs_cuda_unless_cpu_is_asked(monkeypatch):
    cfg = get_config("configs/tiny_fake.yaml")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VFDepthModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        VFDepthModel(cfg, device="cuda")
    assert VFDepthModel(cfg, device="cpu").device.type == "cpu"


def _cfg_with(**over):
    cfg = get_config("configs/tiny_fake.yaml")
    for key, value in over.items():
        cfg.set(key, value)
    return cfg


def test_configs_build_and_misshapen_draws_raise():
    """Every single-device option builds: ``sampler_3d: gather`` under
    mixed precision with the fusion depth net (the gather-bf16 forms; it
    serves a request here), unbatched pose frames, mixed precision on the
    3-camera rig (the bf16 forms of K1b and K2b), ``merge_backprojection:
    false``, mixed precision on the 6-camera rig and the depth-synthesis
    branch, whose ``predict`` and ``forward`` need the rotated views' draw
    ``aug_u`` of ``aug_shape`` (a missing or misshapen draw raises, as a
    missing noise does)."""
    cfg = _cfg_with(mixed_precision=True, sampler_3d="gather")
    model = VFDepthModel(cfg, device="cpu")
    assert model.sampler_3d == "gather" and model.depth_net.fusion_net.gather
    out = model.predict(FakeDataset(
        num_samples=1, num_cams=cfg.num_cams, height=cfg.height,
        width=cfg.width, fusion_level=cfg.fusion_level).batch([0]))
    assert out["depth/0"].dtype == torch.float32
    assert bool(torch.isfinite(out["depth/0"]).all())
    model = VFDepthModel(_cfg_with(batch_pose_frames=False), device="cpu")
    assert len(model.frame_ids) == 3 and not model.batch_pose_frames
    assert not model._can_merge_backproject()
    assert VFDepthModel(_cfg_with(mixed_precision=True),
                        device="cpu").compute_dtype == torch.bfloat16
    three = VFDepthModel(presets.micro_config(mixed_precision=True),
                         device="cpu")
    assert three.compute_dtype == torch.bfloat16 and not three.grouped
    assert VFDepthModel(_cfg_with(batch_pose_frames=False, frame_ids=[0, 1]),
                        device="cpu")._can_merge_backproject()
    cfg = _cfg_with(aug_depth=True)
    model = VFDepthModel(cfg, device="cpu")
    assert model.aug_depth
    batch = FakeDataset(num_samples=1, num_cams=cfg.num_cams,
                        height=cfg.height, width=cfg.width,
                        fusion_level=cfg.fusion_level).batch([0])
    assert model.aug_shape(batch) == (1, cfg.num_cams, 3)
    for aug_u in (None, torch.rand(1, cfg.num_cams, 2)):
        with pytest.raises(ValueError, match="aug_u"):
            model(batch, step=0, noise=torch.zeros(model.noise_shape(batch)),
                  aug_u=aug_u)
        with pytest.raises(ValueError, match="aug_u"):
            model.predict(batch, aug_u=aug_u)
    out = model.predict(batch, aug_u=torch.rand(model.aug_shape(batch)))
    assert {"disp/0/aug", "depth/0/aug"} <= set(out)


@pytest.mark.parametrize("depth_model,pose_model", [
    ("fsm", "fsm"), ("fusion", "fsm"), ("fsm", "fusion")])
def test_fsm_pairs_build_and_never_merge(depth_model, pose_model):
    """Every pair with an fsm net builds (in f32, and in bf16 with
    ``sampler_3d: gather``, which a fusion depth net samples with the
    gather-bf16 forms) and never takes the merged back-projection, even
    with it on."""
    from vfdepth_tpu_torch.models import (FusedDepthNet, FusedPoseNet,
                                          MonoDepthNet, MonoPoseNet)
    for over in ({}, {"mixed_precision": True, "sampler_3d": "gather"}):
        model = VFDepthModel(_cfg_with(depth_model=depth_model,
                                       pose_model=pose_model,
                                       merge_backprojection=True, **over),
                             device="cpu")
        assert isinstance(model.depth_net, MonoDepthNet if depth_model ==
                          "fsm" else FusedDepthNet)
        assert isinstance(model.pose_net, MonoPoseNet if pose_model ==
                          "fsm" else FusedPoseNet)
        assert model.merge_backproject and not model._can_merge_backproject()
        if over and depth_model == "fusion":
            assert model.depth_net.fusion_net.gather
    with pytest.raises(ValueError, match="depth_model"):
        VFDepthModel(_cfg_with(depth_model="mono"), device="cpu")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(cwd),
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"},
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """Without CUDA, or alone in a directory, chip_smoke.py exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_kernel_build_needs_nvcc_and_keys_by_source(tmp_path, monkeypatch):
    """Without nvcc the build raises (no silent fallback); a library's
    name changes with its source, so an edited kernel is never stale."""
    from vfdepth_tpu_torch.ops import _build

    assert _build.kernel_names() == [
        "backproject_sample", "backproject_sample_bwd", "sample3d",
        "sample3d_bwd", "warp_image_mask"]
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = csrc / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path("k")
    src.write_text("// v2\n")
    assert _build.library_path("k") != first
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(FileNotFoundError, match="nvcc"):
        _build.build(["k"])
