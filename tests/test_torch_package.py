"""The PyTorch port stands alone: no source of it, nor chip_smoke.py, imports
jax, flax, optax or the JAX package.

A source scan, because this environment imports jax at interpreter start, so
``sys.modules`` proves nothing.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "followmyhold_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "followmyhold_tpu"}


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_has_sources():
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert "chip_smoke.py" in names
    assert "followmyhold_tpu_torch/ops/attention.py" in names
    assert "followmyhold_tpu_torch/diffusion/guidance.py" in names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_source_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_kernel_sources_exist_and_are_not_built_at_import():
    csrc = PORT / "csrc"
    for name in ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "raster_fwd.cu",
                 "raster_bwd.cu", "raster_common.cuh"):
        assert (csrc / name).is_file(), name
    # importing the wrappers must not need nvcc, ctypes libraries or a GPU
    from followmyhold_tpu_torch.ops import _kernels, attention, rasterizer  # noqa: F401

    assert _kernels._lib is None


def test_launch_counters_reset():
    from followmyhold_tpu_torch.ops import _kernels

    assert set(_kernels.launch_counts()) == {"flash_attention_fwd", "flash_attention_bwd",
                                             "raster_chunk_plan", "raster_fwd", "raster_bwd",
                                             "scatter_rows_add"}
    _kernels.LAUNCH_COUNTS["raster_fwd"] += 3
    _kernels.reset_launch_counts()
    assert all(v == 0 for v in _kernels.launch_counts().values())
