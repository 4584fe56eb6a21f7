"""Parameters for the port's modules: a reader for the converted parameter
files, the bridge from a Flax parameter tree, and a seeded random
initialisation for full-size models on the device.

A converted checkpoint is ``<assets>/params/<name>.msgpack``, the bytes of
``flax.serialization.to_bytes``: msgpack maps, arrays, strings, numbers,
booleans and nil, with three extension types (1: an array, packed as the
msgpack triple (shape, dtype name, raw bytes); 2: a complex number; 3: a
numpy scalar, packed as an array); an array over 2^30 bytes is a map
``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` of flat
pieces, and a list is a map with keys "0", "1", ... ``read_params_file``
decodes it in pure Python (no msgpack or flax package) over one private
memory map of the file: each array is a ``torch.frombuffer`` view of its
bytes, so a multi-GB file is not copied on the host before its tensors are
copied into a module. ``load_or_init`` loads the file where it exists and
draws the seeded random weights where it does not, as the JAX package's
``load_or_init`` does.

The port's modules keep the Flax modules' names, so the bridge is mechanical:

- ``Dense`` ``kernel [in,out]`` -> ``Linear.weight [out,in]``; ``bias`` as is;
- ``Conv`` ``kernel [kh,kw,in,out]`` (HWIO) -> ``Conv2d.weight [out,in,kh,kw]``;
- ``ConvTranspose`` ``kernel [kh,kw,in,out]`` -> ``ConvTranspose2d.weight
  [in,out,kh,kw]``, flipped in space: Flax's transposed convolution applies its
  kernel flipped (a 2x2/2 kernel K spreads a single one into K[::-1, ::-1]),
  torch's as it is. The rule goes by the torch module's type, since a square
  layer's kernel fits either rule's shape;
- ``LayerNorm`` / ``RMSNorm`` / ``GroupNorm`` ``scale`` -> ``weight``; ``bias`` as is;
- ``Embed`` ``embedding [num, features]`` -> ``Embedding.weight``, as is;
- a scan-stacked block (``<name>/block/...``, or HaMeR head's
  ``<name>/layer/...``, with a leading depth axis) -> ``<name>.<i>....``, one
  module per layer.

The tree is given as nested dicts of numpy arrays or tensors (this package
imports no JAX). Every module parameter must be filled and every tree leaf
used, or the bridge raises.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn

from followmyhold_tpu_torch.configs.paths import assets_root


# the names the Flax modules give the body of an ``nn.scan`` over layers
_SCAN_SCOPES = ("block", "layer")

# the dtype names numpy (and ml_dtypes, for bfloat16) give the arrays of a file
_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "bool": torch.bool, "complex64": torch.complex64, "complex128": torch.complex128,
}
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Decoder:
    """msgpack over a buffer, from ``pos``: binaries come back as memoryview
    slices of the buffer (no copy), strings as str."""

    def __init__(self, buf: memoryview, pos: int = 0):
        self.buf, self.pos = buf, pos

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"truncated msgpack: {n} bytes wanted at offset {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self._unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):                      # bin 8/16/32
            return self._take(self._unpack((">B", ">H", ">I")[b - 0xC4]))
        if b in (0xC7, 0xC8, 0xC9):                      # ext 8/16/32
            n = self._unpack((">B", ">H", ">I")[b - 0xC7])
            return self._ext(self._unpack(">b"), n)
        if b in (0xCA, 0xCB):
            return self._unpack(">f" if b == 0xCA else ">d")
        if 0xCC <= b <= 0xD3:                            # uint / int 8-64
            return self._unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:                            # fixext 1-16
            code = self._unpack(">b")
            return self._ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):                      # str 8/16/32
            return str(self._take(self._unpack((">B", ">H", ">I")[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} at offset {self.pos - 1} is not valid")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if out.get(_CHUNKED) is True:
            return _unchunk(out)
        return out

    def _ext(self, code: int, n: int) -> Any:
        end = self.pos + n
        inner = _Decoder(self.buf[:end], self.pos)
        self.pos = end
        if code == _EXT_COMPLEX:
            real, imag = inner.value()
            return complex(real, imag)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, name, raw = inner.value()
            tensor = _tensor(raw, name, shape)
            return tensor.reshape(()) if code == _EXT_NPSCALAR else tensor
        raise ValueError(f"msgpack extension type {code} is not one flax writes")


def _tensor(raw, name, shape) -> torch.Tensor:
    """The array bytes ``raw`` as a tensor of ``shape`` (a view, no copy)."""
    if name not in _DTYPES:
        raise ValueError(f"array of dtype {name!r}: the reader knows {sorted(_DTYPES)}")
    dtype = _DTYPES[name]
    if len(raw) == 0:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(raw, dtype=dtype).reshape(tuple(shape))


def _unchunk(data: dict) -> torch.Tensor:
    """flax's chunked form of a large array -> the array (one copy: the
    pieces lie apart in the file)."""
    shape = tuple(data["shape"][str(i)] for i in range(len(data["shape"])))
    chunks = [data["chunks"][str(i)] for i in range(len(data["chunks"]))]
    return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)


def read_params_file(path: str) -> Any:
    """The tree of a file that ``flax.serialization.to_bytes`` wrote: nested
    dicts with tensor leaves (views of one private, copy-on-write memory map
    of the file, which lives as long as they do)."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            raise ValueError(f"{path} is empty")
        buf = mmap.mmap(f.fileno(), size, access=mmap.ACCESS_COPY)
    dec = _Decoder(memoryview(buf))
    tree = dec.value()
    if dec.pos != size:
        raise ValueError(f"{path}: {size - dec.pos} bytes follow the msgpack object")
    return tree


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, Any]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def _as_tensor(value) -> torch.Tensor:
    """A leaf as a tensor: tensors as they are, numpy arrays without a copy
    where they are contiguous."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


def flax_to_torch(params: Mapping, module: nn.Module) -> nn.Module:
    """Load a Flax parameter tree (numpy or tensor leaves) into ``module`` in
    place, each leaf cast to its parameter's device and type."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    own = dict(module.named_parameters())
    transposed = {name for name, m in module.named_modules()
                  if isinstance(m, nn.ConvTranspose2d)}
    loaded = set()

    def assign(name: str, value: torch.Tensor, where: str) -> None:
        if name not in own:
            raise KeyError(f"Flax leaf {where} maps to {name!r}, which the module does not "
                           f"have")
        target = own[name]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"Flax leaf {where} -> {name}: shape {tuple(value.shape)} does "
                             f"not fit {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(value)
        loaded.add(name)

    for path, value in _flatten(params).items():
        where = "/".join(str(p) for p in path)
        value = _as_tensor(value)
        *scope, leaf = path
        depth_at = next((i for i, name in enumerate(scope) if name in _SCAN_SCOPES), None)
        if leaf == "kernel" and depth_at is None and ".".join(scope) in transposed:
            leaf = "weight"          # transposed conv: HWIO, flipped -> IOHW
            value = value.flip(0, 1).permute(2, 3, 0, 1)
        elif leaf == "kernel" and value.dim() == 4 and depth_at is None:
            leaf = "weight"          # conv: HWIO -> OIHW
            value = value.permute(3, 2, 0, 1)
        elif leaf == "kernel":
            leaf = "weight"
            value = value.transpose(-1, -2)
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        if depth_at is not None:  # scan-stacked: the leading axis is the layer
            for i in range(value.shape[0]):
                assign(".".join([*scope[:depth_at], str(i), *scope[depth_at + 1:], leaf]),
                       value[i], where)
        else:
            assign(".".join([*scope, leaf]), value, where)

    missing = sorted(set(own) - loaded)
    if missing:
        raise KeyError(f"the Flax tree fills no value for: {missing}")
    return module


def init_random_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights, drawn on the module's device: matrices from
    N(0, 1/fan_in), norm scales one, biases zero. For smoke runs and timing;
    real weights come through a converter."""
    for index, (name, p) in enumerate(module.named_parameters()):
        gen = torch.Generator(device=p.device)
        gen.manual_seed(seed * 1_000_003 + index)
        with torch.no_grad():
            if p.dim() >= 2:
                std = 1.0 / float(p.shape[1]) ** 0.5
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device,
                                    dtype=torch.float32) * std)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)
    return module


def params_path(name: str) -> str:
    """Where a converted checkpoint ``name`` lives:
    ``<assets>/params/<name>.msgpack``, as in the JAX package."""
    return os.path.join(assets_root(), "params", f"{name}.msgpack")


def has_params(name: str) -> bool:
    """Whether a converted checkpoint ``name`` exists (it decides a stage's
    backend, as in the JAX package)."""
    return os.path.exists(params_path(name))


def load_params(name: str, module: nn.Module) -> nn.Module:
    """Load the converted checkpoint ``name`` into ``module`` in place. A
    leaf the module lacks, a parameter the file leaves empty or a leaf of
    another shape raises, naming the file and the key."""
    path = params_path(name)
    tree = read_params_file(path)
    if not isinstance(tree, Mapping):
        raise ValueError(f"{path} holds no parameter tree but a {type(tree).__name__}")
    try:
        return flax_to_torch(tree, module)
    except (KeyError, ValueError) as e:
        raise ValueError(f"{path} does not fit {type(module).__name__}: {e}") from e


def load_or_init(name: str, module: nn.Module,
                 init: Callable[[nn.Module], Any]) -> nn.Module:
    """``module`` with the converted checkpoint ``name`` where its file
    exists (``load_params``), else with ``init(module)``'s seeded random
    weights: the JAX package's ``load_or_init``."""
    if has_params(name):
        return load_params(name, module)
    init(module)
    return module


def scheduler_config(name: str = "hunyuan_scheduler") -> dict:
    """The checkpoint's scheduler config (``<assets>/params/<name>.json``, e.g.
    {"shift": 1.0}), or {} without one."""
    import json

    path = os.path.join(assets_root(), "params", f"{name}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def scheduler_shift() -> float:
    """The checkpoint's sigma shift (1.0 without a config): the original
    pipeline applies it to the explicitly passed linspace(0, 1) sigmas too."""
    return float(scheduler_config().get("shift", 1.0))
