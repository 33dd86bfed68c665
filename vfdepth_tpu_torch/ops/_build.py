"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes), under ``<repo>/build/kernels/`` (gitignored). A library's file name
carries a hash of its source, the shared headers and the flags, so an edited
source is rebuilt and a stale library is never loaded. Several sources build
in parallel, one ``nvcc`` each. Nothing prebuilt is committed.

Wrappers receive tensor pointers and the current stream as Python ints
(``tensor.data_ptr()``, ``torch.cuda.current_stream().cuda_stream``); every
C entry point returns ``cudaGetLastError()`` after its launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = "arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float    # 0.0 when the library was already built
    log: str          # nvcc's output (ptxas register / shared-memory report)


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels are built from source at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, BuildResult]:
    """Compile the named kernels (all by default) that are not built yet,
    one nvcc process per source, all started together. Raises on a failed
    compile, with nvcc's output."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = []
    for name in names:
        path = library_path(name)
        if path.exists():
            results[name] = BuildResult(name, path, 0.0, "")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, path, tmp, proc, time.perf_counter()))
    failed = []
    for name, path, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        results[name] = BuildResult(name, path, seconds, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name].path
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def function(lib: str, name: str, argtypes):
    """The C entry point ``name`` of kernel library ``lib``, its argument
    types set and its result the int CUDA error code; the library is built
    and loaded first if needed."""
    fn = getattr(load(lib), name)   # ctypes keeps one object per name
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn
