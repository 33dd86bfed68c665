"""The host-side C++ image resize of the data pipeline, bound with ctypes
(port of ``vfdepth_tpu/native/__init__.py``).

``image_ops.cpp`` (a copy of the JAX package's) holds the threaded
half-pixel bilinear resize of [N, H, W, C] frames, f32 -> f32 and
uint8 -> f32 with the /255 folded in. It is compiled with ``g++`` at first
use, with the JAX package's flags, into ``<repo>/build/native/``
(gitignored). The library's file name carries a hash of the source, the
flags and the instruction set ``-march=native`` selects on this machine, so
an edited source is rebuilt and a library built for another CPU is never
loaded. Nothing prebuilt is committed, and nothing is written beside the
source.

A deliberate difference from the JAX package: a failed build or load
raises. The JAX loader warns and returns None, and its ``transforms``
then falls back to PIL's uint8 bilinear or to numpy nearest, so its
samples would change without a word; the port has no such fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "image_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

# loaded libraries by (compiler, build directory): the key's hash is taken
# once per process, not per call
_loaded: Dict[Tuple[str, Path], ctypes.CDLL] = {}


def _run(cmd, **kwargs) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120, **kwargs)
    except OSError as e:
        raise RuntimeError(f"native image_ops: cannot run {cmd[0]!r} "
                           f"({e})") from e


def library_path() -> Path:
    """The library's path, keyed by the source, the flags and the target
    ``-march=native`` resolves to (the compiler's predefined macros)."""
    target = _run([CXX, *FLAGS[:2], "-dM", "-E", "-x", "c++", "-"], input="")
    if target.returncode != 0:
        raise RuntimeError(f"native image_ops: {CXX} exited "
                           f"{target.returncode}\n{target.stderr}")
    h = hashlib.sha256(" ".join((CXX,) + FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(target.stdout.encode())
    return BUILD_DIR / f"libimage_ops-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; raises with the compiler's
    output when the compile fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    res = _run([CXX, *FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"])
    if res.returncode != 0:
        raise RuntimeError(f"native image_ops build failed: {CXX} exited "
                           f"{res.returncode}\n{res.stdout}{res.stderr}")
    os.replace(tmp, path)      # atomic: concurrent builders agree
    return path


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    key = (CXX, BUILD_DIR)
    lib = _loaded.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build()))
        args = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7
        for name in ("bilinear_resize_batch_f32", "u8_to_f32_resize_batch"):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = None
        _loaded[key] = lib
    return lib


def resize_batch(images: np.ndarray, out_hw: Tuple[int, int],
                 n_threads: int = 4) -> np.ndarray:
    """Bilinear (half-pixel) resize of [N, H, W, C] float32 or uint8 frames
    to [N, out_h, out_w, C] float32; uint8 frames are normalised to [0, 1]
    in the same pass. Other dtypes are taken as float32."""
    if images.ndim != 4:
        raise ValueError(f"expected [N, H, W, C] frames, got {images.shape}")
    lib = get_lib()
    n, in_h, in_w, c = images.shape
    out_h, out_w = (int(v) for v in out_hw)
    dst = np.empty((n, out_h, out_w, c), np.float32)
    if images.dtype == np.uint8:
        fn, src = lib.u8_to_f32_resize_batch, np.ascontiguousarray(images)
    else:
        fn = lib.bilinear_resize_batch_f32
        src = np.ascontiguousarray(images, np.float32)
    fn(src.ctypes.data, dst.ctypes.data, n, in_h, in_w, out_h, out_w, c,
       n_threads)
    return dst
