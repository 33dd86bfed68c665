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

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "vfdepth_tpu_torch"
# the training slice's modules, named so a lost module fails loudly
TRAINING_MODULES = ("geometry.view_rendering", "losses.primitives",
                    "losses.composite", "ops.warp", "ops.ties",
                    "training.step")
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
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'vfdepth_tpu'):\n"
        "    sys.modules[name] = None\n"
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


def test_model_needs_cuda_unless_cpu_is_asked(monkeypatch):
    cfg = get_config("configs/tiny_fake.yaml")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VFDepthModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        VFDepthModel(cfg, device="cuda")
    assert VFDepthModel(cfg, device="cpu").device.type == "cpu"


def test_unported_configs_raise():
    """What is not ported raises: the fsm nets, ``sampler_3d: gather``
    under mixed precision and the depth-synthesis branch (in ``forward``
    and in ``predict``). Unbatched pose
    frames and mixed precision on the 3-camera rig (the bf16 forms of K1b
    and K2b) build, as do ``merge_backprojection: false`` and mixed
    precision on the 6-camera rig."""
    def cfg_with(**over):
        cfg = get_config("configs/tiny_fake.yaml")
        for key, value in over.items():
            cfg.set(key, value)
        return cfg

    for over in ({"depth_model": "fsm"}, {"pose_model": "fsm"},
                 {"mixed_precision": True, "sampler_3d": "gather"}):
        with pytest.raises(NotImplementedError):
            VFDepthModel(cfg_with(**over), device="cpu")
    model = VFDepthModel(cfg_with(batch_pose_frames=False), device="cpu")
    assert len(model.frame_ids) == 3 and not model.batch_pose_frames
    assert not model._can_merge_backproject()
    assert VFDepthModel(cfg_with(mixed_precision=True),
                        device="cpu").compute_dtype == torch.bfloat16
    three = VFDepthModel(presets.micro_config(mixed_precision=True),
                         device="cpu")
    assert three.compute_dtype == torch.bfloat16 and not three.grouped
    assert VFDepthModel(cfg_with(batch_pose_frames=False, frame_ids=[0, 1]),
                        device="cpu")._can_merge_backproject()
    cfg = cfg_with(aug_depth=True)
    model = VFDepthModel(cfg, device="cpu")
    batch = FakeDataset(num_samples=1, num_cams=cfg.num_cams,
                        height=cfg.height, width=cfg.width,
                        fusion_level=cfg.fusion_level).batch([0])
    with pytest.raises(NotImplementedError, match="depth-synthesis"):
        model(batch, step=0, noise=torch.zeros(model.noise_shape(batch)))
    # serving too: JAX's forward(train=False) returns the depth-synthesis
    # outputs, which the port cannot give
    with pytest.raises(NotImplementedError, match="depth-synthesis"):
        model.predict(batch)


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
