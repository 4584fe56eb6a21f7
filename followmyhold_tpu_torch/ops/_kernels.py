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
from typing import Dict, Tuple

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC"]
# per-source extra flags. The rasterizer is compiled without fused
# multiply-adds so that its per-pixel arithmetic rounds exactly as the plain
# PyTorch version's separate multiplies and adds do (see raster_common.cuh).
_SOURCES = {
    "flash_attention_fwd.cu": [],
    "flash_attention_bwd.cu": [],
    "raster_fwd.cu": ["-fmad=false"],
    "raster_bwd.cu": ["-fmad=false"],
    "scatter_rows.cu": [],
    "qk_norm_rope.cu": [],
}
_HEADERS = ["hopper_common.cuh", "raster_common.cuh"]

LAUNCH_COUNTS = {"flash_attention_fwd": 0, "flash_attention_bwd": 0, "raster_chunk_plan": 0,
                 "raster_fwd": 0, "raster_bwd": 0, "scatter_rows_add": 0, "qk_norm_rope": 0}

# The C signature of every entry point, parameter by parameter: "p" a pointer
# (or the stream), "i" an int, "f" a float; each returns an int error code.
# tests/test_torch_kernels_abi.py holds this table against the sources'
# `extern "C"` declarations, so a changed signature cannot go unbound.
ENTRY_POINTS = {
    "fmh_flash_attention_fwd": "pppppiiiifp",
    "fmh_flash_attention_bwd": "pppppppppiiiifp",
    "fmh_raster_chunk_plan": "ppiip",
    "fmh_raster_fwd": "ppppppppiiiiiiffffp",
    "fmh_raster_bwd": "pppppppppiiiiiiffp",
    "fmh_scatter_rows_add": "ppppiiip",
    "fmh_qk_norm_rope": "ppppppppppiiiiiiiifp",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

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


def build_library(verbose: bool = False) -> Tuple[Path, Dict[str, str]]:
    """Compile every source (in parallel) and link. Returns the library path
    and, for a verbose build, each source's compiler report (ptxas -v); none
    when the library was already built."""
    out_dir = build_dir()
    lib_path = out_dir / f"libfmh_kernels_{_digest()}.so"
    reports: Dict[str, str] = {}
    if lib_path.exists():
        return lib_path, reports
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
            reports[src] = log
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
    return lib_path, reports


def load_library():
    """The kernels' library, built at first use; argtypes set for every entry."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()[0]))
    for name, signature in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = [_CTYPES[c] for c in signature]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check_launch(code: int, name: str) -> None:
    """Raise if the C entry point reported a refused launch."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} did not launch (error code {code})")
