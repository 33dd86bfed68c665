"""The JAX package's native image resize, built privately for the port's
parity tests (``tests/test_torch_readers.py``, ``test_torch_native.py``).

``vfdepth_tpu.native.get_lib`` compiles ``libimage_ops.so`` at first use
beside its source, with ``g++ -o`` straight onto the final path. Under
``pytest -n 6`` two workers can race there: one loads the other's
half-written file ("file too short"), and from then on JAX's readers fall
back to PIL's resize without a word, so every sample differs from the
port's. Here the same source is compiled with JAX's own flags into the
gitignored ``build/jax_native/``, under a temporary name that
``os.replace`` then moves into place (a loader sees no file or a whole
one), once per process. The ``jax_native`` fixture points JAX's loader at
that library (its module's ``_LIB``, ``_lib`` and ``_tried``, restored
after the test) and asserts it loads, so a fallback shows as this error
and not as mismatched pixels. No file of the JAX package changes.
"""
import hashlib
import os
import subprocess
from pathlib import Path

import pytest

from vfdepth_tpu import native as jnative

BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "jax_native"
# vfdepth_tpu/native/__init__.py _build's flags
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_built = {}


def _run(cmd, **kwargs) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True,
                          timeout=120, **kwargs).stdout


def library() -> Path:
    """JAX's ``image_ops.cpp`` compiled with its flags, once per process,
    into a path keyed by the source, the flags and the instruction set
    ``-march=native`` selects here."""
    if "path" not in _built:
        src = Path(jnative._SRC)
        target = _run(["g++", *FLAGS[:2], "-dM", "-E", "-x", "c++", "-"],
                      input="")
        h = hashlib.sha256(" ".join(FLAGS).encode())
        h.update(src.read_bytes())
        h.update(target.encode())
        path = BUILD_DIR / f"libimage_ops-{h.hexdigest()[:16]}.so"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        _run(["g++", *FLAGS, "-o", str(tmp), str(src), "-lpthread"])
        os.replace(tmp, path)
        _built["path"] = path
    return _built["path"]


@pytest.fixture
def jax_native(monkeypatch):
    """JAX's loader on the private library for the test; fails if it does
    not load (JAX would fall back to PIL)."""
    monkeypatch.setattr(jnative, "_LIB", str(library()))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.get_lib() is not None, (
        "JAX's native image_ops did not load: its readers would fall back "
        "to PIL's resize")
    yield jnative.get_lib()
