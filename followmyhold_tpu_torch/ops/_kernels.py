"""Builds the CUDA kernels under ``csrc/`` and loads them through ctypes.

The sources have a plain C interface, so ``nvcc`` needs seconds, not minutes:
one ``nvcc -c`` per source, all started together, then one link into a single
shared library under ``build/`` beside the package. The library's name carries
a hash of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded. Nothing here runs at import time: ``nvcc`` and
``ctypes.CDLL`` are touched only by ``load_library()``, which the wrappers call
right before their first launch.

Each wrapper adds one to its entry of ``LAUNCH_COUNTS`` where it launches its
kernel, and nowhere else, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC"]
# per-source extra flags. The rasterizer is compiled without fused
# multiply-adds so that its per-pixel arithmetic rounds exactly as the plain
# PyTorch version's separate multiplies and adds do (see raster_common.cuh).
_SOURCES = {
    "flash_attention_fwd.cu": [],
    "raster_fwd.cu": ["-fmad=false"],
    "raster_bwd.cu": ["-fmad=false"],
}
_HEADERS = ["raster_common.cuh"]

LAUNCH_COUNTS = {"flash_attention_fwd": 0, "raster_fwd": 0, "raster_bwd": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCH_COUNTS)


def build_dir() -> Path:
    """``build/`` beside the package: inside the checkout, ignored by git."""
    return _CSRC.parent.parent / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use "
                       "and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha1()
    for name in sorted(list(_SOURCES) + _HEADERS):
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(repr((_ARCH_FLAGS, _SOURCES)).encode())
    return h.hexdigest()[:16]


def build_library(verbose: bool = False) -> Path:
    """Compile every source (in parallel) and link; returns the library path."""
    out_dir = build_dir()
    lib_path = out_dir / f"libfmh_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src, flags in _SOURCES.items():
        obj = out_dir / (Path(src).stem + f".{os.getpid()}.o")
        cmd = [nvcc, *_ARCH_FLAGS, *flags, *extra, "-c", str(_CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, failed = [], []
    for src, obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
        elif verbose and log.strip():
            print(f"[nvcc {src}]\n{log.strip()}")
        objs.append(obj)
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib_path


def load_library(verbose: bool = False):
    """The kernels' library, built at first use; argtypes set for every entry."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library(verbose=verbose)))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fmh_flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, p]
    lib.fmh_flash_attention_fwd.restype = i
    lib.fmh_raster_fwd.argtypes = [p, p, p, p, p, p, i, i, i, f, f, f, p]
    lib.fmh_raster_fwd.restype = i
    lib.fmh_raster_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, p]
    lib.fmh_raster_bwd.restype = i
    _lib = lib
    return lib


def check_launch(code: int, name: str) -> None:
    """Raise if the C entry point reported a refused launch."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} did not launch (error code {code})")
