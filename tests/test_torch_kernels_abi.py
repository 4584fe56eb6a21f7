"""The ctypes binding of the CUDA kernels against their C declarations.

``ops/_kernels.load_library`` sets each entry point's argtypes from the table
``_kernels.ENTRY_POINTS``; the sources under ``csrc/`` declare the same entry
points as ``extern "C"`` functions. ctypes cannot check one against the other,
so a parameter added on one side only (a scratch pointer, say) would shift every
argument after it without an error. This reads the declarations from the
sources and holds the table against them, parameter by parameter, and checks
that every file under ``csrc/`` is an input of the build. No nvcc, library or
GPU is needed.
"""

import pathlib
import re

import pytest

from followmyhold_tpu_torch.ops import _kernels

CSRC = pathlib.Path(_kernels.__file__).resolve().parent.parent / "csrc"
_DECL = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _kind(param: str) -> str:
    """'p', 'i' or 'f' for one C parameter declaration."""
    decl = " ".join(param.split())
    if "*" in decl:
        return "p"
    ctype = decl.rsplit(" ", 1)[0]
    return {"int": "i", "float": "f"}[ctype]


def _declared() -> dict:
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in _DECL.findall(src.read_text()):
            assert name not in found, f"{name} is declared twice"
            found[name] = "".join(_kind(p) for p in params.split(","))
    return found


def test_every_declared_entry_point_is_bound():
    assert sorted(_declared()) == sorted(_kernels.ENTRY_POINTS)


@pytest.mark.parametrize("name", sorted(_kernels.ENTRY_POINTS))
def test_argtypes_match_the_declaration(name):
    declared = _declared()[name]
    bound = _kernels.ENTRY_POINTS[name]
    assert bound == declared, (f"{name}: csrc declares {len(declared)} parameters "
                               f"{declared!r}, ENTRY_POINTS binds {len(bound)} {bound!r}")
    assert set(bound) <= set(_kernels._CTYPES)


@pytest.mark.parametrize("pattern, listed", [("*.cu", _kernels._SOURCES),
                                             ("*.cuh", _kernels._HEADERS)],
                         ids=["sources", "headers"])
def test_every_kernel_file_is_a_build_input(pattern, listed):
    """Every source is compiled, and every header is hashed into the library's
    name: a file left out of either would let an edited kernel run from a
    stale library."""
    assert sorted(p.name for p in CSRC.glob(pattern)) == sorted(listed)


def test_every_included_header_is_a_build_input():
    included = {name for src in CSRC.iterdir()
                for name in re.findall(r'#include\s+"([^"]+)"', src.read_text())}
    assert included and included <= set(_kernels._HEADERS)


def test_parameter_kinds_are_read_from_the_declaration():
    assert [_kind(p) for p in ("const void* q", "void *dq", "int BH", "float  scale",
                               "void* stream")] == ["p", "p", "i", "f", "p"]
    with pytest.raises(KeyError):
        _kind("double x")
