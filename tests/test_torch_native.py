"""The port's native image resize (``vfdepth_tpu_torch.native``) against the
JAX package's (``vfdepth_tpu.native.resize_batch``), on the CPU.

Both compile the same ``image_ops.cpp`` with the same g++ flags, so their
outputs are equal, bit for bit, on f32 and uint8 frames, at a small size
and at DDAD's native 1216x1936 -> 384x640. The port builds its library
under the gitignored ``build/native/``, never beside the source, and
raises when the build fails (the JAX package warns and falls back).
JAX's side runs from the library ``helpers_jax_native`` builds (its own
in-place build races under ``-n 6``).
"""
import os
from pathlib import Path

import numpy as np
import pytest

from vfdepth_tpu import native as jnative
from vfdepth_tpu_torch import native
import helpers_jax_native
from helpers_jax_native import jax_native  # noqa: F401
from helpers_torch_threads import port_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("shape,out_hw", [((3, 37, 53, 3), (24, 40)),
                                          ((2, 1216, 1936, 3), (384, 640)),
                                          ((1, 8, 8, 2), (8, 8))],
                         ids=["small", "ddad", "identity"])
def test_resize_equals_jax(jax_native, dtype, shape, out_hw):
    rng = np.random.RandomState(0)
    imgs = rng.rand(*shape).astype(np.float32)
    if dtype == "uint8":
        imgs = (imgs * 255).astype(np.uint8)
    want = jnative.resize_batch(imgs, out_hw, n_threads=2)
    assert want is not None                     # JAX's library built
    got = native.resize_batch(imgs, out_hw, n_threads=2)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_library_lives_in_the_build_directory():
    path = native.build()
    assert path.parent == ROOT / "build" / "native" and path.is_file()
    assert not list((ROOT / "vfdepth_tpu_torch").rglob("*.so"))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails, or none at all, raises; nothing falls back."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", "false")
    frames = np.zeros((1, 4, 4, 3), np.float32)
    with pytest.raises(RuntimeError, match="native image_ops"):
        native.resize_batch(frames, (2, 2))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.resize_batch(frames, (2, 2))
    assert not (tmp_path / "build").exists() or not list(
        (tmp_path / "build").iterdir())


def test_library_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    first = native.library_path()
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-DVARIANT",))
    assert native.library_path() != first
    src = tmp_path / "image_ops.cpp"
    src.write_text(native.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.library_path().name != first.name


def test_jax_library_is_built_privately(jax_native):
    """JAX's loader reads the helper's library: under the gitignored
    ``build/jax_native/``, moved into place whole (no temporary file is
    left), never the one JAX builds beside its source."""
    path = helpers_jax_native.library()
    assert path.parent == ROOT / "build" / "jax_native" and path.is_file()
    assert jnative._LIB == str(path) and jnative.get_lib() is jax_native
    assert not list(path.parent.glob(f"{path.name}.{os.getpid()}.tmp"))
