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
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from followmyhold_tpu_torch.configs.paths import assets_root
from followmyhold_tpu_torch.utils.device import DeviceLike


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


# ---- the writer ---------------------------------------------------------- #

# flax.serialization.MAX_CHUNK_SIZE: an array of more bytes is written in pieces
MAX_CHUNK_SIZE = 2 ** 30
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}


def _sized(n: int, small: Tuple[int, int], codes: Tuple[int, int, int]) -> bytes:
    """A msgpack length header: the fix form ``small`` = (base, limit) where
    it fits, else the 8/16/32-bit form of ``codes`` (0 where there is none)."""
    base, limit = small
    if n < limit:
        return bytes([base | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack cannot hold a length of {n}")


def _int(n: int) -> bytes:
    """msgpack's shortest form of an integer, as the msgpack package packs it."""
    if 0 <= n < 0x80 or -0x20 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (-0x80, -1, 0xD0, ">b"),
                              (0, 0xFFFF, 0xCD, ">H"), (-0x8000, -1, 0xD1, ">h"),
                              (0, 0xFFFFFFFF, 0xCE, ">I"), (-0x80000000, -1, 0xD2, ">i"),
                              (0, 2 ** 64 - 1, 0xCF, ">Q"), (-2 ** 63, -1, 0xD3, ">q")):
        if lo <= n <= hi:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _str(text: str) -> bytes:
    raw = text.encode("utf-8")
    return _sized(len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + raw


def _bin_header(n: int) -> bytes:
    return _sized(n, (0, 0), (0xC4, 0xC5, 0xC6))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else _sized(n, (0, 0), (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code)


def _host_bytes(value) -> Tuple[tuple, str, np.ndarray, int]:
    """(shape, dtype name, the C-order bytes as a flat uint8 array, item
    size): the bytes are a view of the array's own buffer where it is
    contiguous on the host."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "meta":
            raise ValueError("a meta tensor holds no values to write")
        t = value.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor of dtype {t.dtype}: the writer knows {sorted(_DTYPES)}")
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        return tuple(t.shape), _NAMES[t.dtype], arr.reshape(-1).view(np.uint8), t.element_size()
    arr = np.asarray(value, order="C")
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured arrays cannot be written")
    return arr.shape, arr.dtype.name, arr.reshape(-1).view(np.uint8), arr.dtype.itemsize


class _Encoder:
    """msgpack onto a binary file, as ``flax.serialization.to_bytes`` lays it
    out, for the trees a converter writes: dicts (in their order) of arrays
    and numpy scalars. An array is extension 1 holding (shape, dtype name,
    raw bytes), a numpy scalar extension 3, an array over ``MAX_CHUNK_SIZE``
    bytes flax's chunked map; ints and strings make the chunked map's
    header. Array bytes go from the array's buffer to the file."""

    def __init__(self, out):
        self.out = out

    def value(self, x) -> None:
        if isinstance(x, Mapping):
            self._map(x)
        elif isinstance(x, (torch.Tensor, np.ndarray)):
            self._array(x, _EXT_NDARRAY)
        elif isinstance(x, np.generic):
            self._array(np.asarray(x), _EXT_NPSCALAR)
        elif isinstance(x, int) and not isinstance(x, bool):
            self.out.write(_int(x))
        elif isinstance(x, str):
            self.out.write(_str(x))
        else:
            raise TypeError(f"cannot write a {type(x).__name__} into a parameter file")

    def _map(self, tree: Mapping) -> None:
        keys = [str(k) for k in tree]
        if len(set(keys)) != len(keys):
            raise ValueError(f"dict keys have no unique string form: {keys}")
        self.out.write(_sized(len(keys), (0x80, 16), (0, 0xDE, 0xDF)))
        for key, value in zip(keys, tree.values()):
            self.out.write(_str(key))
            if isinstance(value, (torch.Tensor, np.ndarray)) and _nbytes(value) > MAX_CHUNK_SIZE:
                self._chunked(value)
            else:
                self.value(value)

    def _chunked(self, value) -> None:
        """flax's ``_chunk``: {"__msgpack_chunked_array__": True, "shape":
        {"0": n0, ...}, "chunks": {"0": flat[0:c], ...}}."""
        shape, name, raw, itemsize = _host_bytes(value)
        per = max(1, int(MAX_CHUNK_SIZE / itemsize)) * itemsize
        pieces = [raw[i:i + per] for i in range(0, len(raw), per)]
        w = self.out.write
        w(b"\x83" + _str(_CHUNKED) + b"\xc3" + _str("shape"))
        self._map({str(i): int(n) for i, n in enumerate(shape)})
        w(_str("chunks") + _sized(len(pieces), (0x80, 16), (0, 0xDE, 0xDF)))
        for i, piece in enumerate(pieces):
            w(_str(str(i)))
            self._raw((len(piece) // itemsize,), name, piece, _EXT_NDARRAY)

    def _array(self, value, code: int) -> None:
        shape, name, raw, _ = _host_bytes(value)
        self._raw(shape, name, raw, code)

    def _raw(self, shape: tuple, name: str, raw: np.ndarray, code: int) -> None:
        head = (b"\x93" + _sized(len(shape), (0x90, 16), (0, 0xDC, 0xDD))
                + b"".join(_int(int(n)) for n in shape) + _str(name) + _bin_header(len(raw)))
        self.out.write(_ext_header(code, len(head) + len(raw)) + head)
        self.out.write(raw)


def _nbytes(value) -> int:
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return value.size * value.dtype.itemsize


def save_params(name: str, params: Any) -> str:
    """Write ``params`` (nested dicts of tensors or numpy arrays) to
    ``<assets>/params/<name>.msgpack`` in the bytes that
    ``flax.serialization.to_bytes`` gives the same tree, so both packages'
    ``load_or_init`` read it; -> the path. The inverse of
    ``read_params_file``."""
    path = params_path(name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            _Encoder(f).value(params)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


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
    place, each leaf moved to the module's device, laid out there and cast to
    its parameter's type."""
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

    # each leaf (a scan-stacked one, each layer) goes to the module's device as
    # it lies in the file and is laid out there: a host-side transpose of a
    # multi-GB leaf is a slow copy, and one layer at a time bounds the card's
    # transient to a layer where the whole stack would be several GB in f32
    device = next(iter(own.values())).device if own else torch.device("cpu")
    for path, value in _flatten(params).items():
        where = "/".join(str(p) for p in path)
        value = _as_tensor(value)
        *scope, leaf = path
        depth_at = next((i for i, name in enumerate(scope) if name in _SCAN_SCOPES), None)
        layout: Callable[[torch.Tensor], torch.Tensor] = lambda v: v
        if leaf == "kernel" and depth_at is None and ".".join(scope) in transposed:
            leaf = "weight"          # transposed conv: HWIO, flipped -> IOHW
            layout = lambda v: v.flip(0, 1).permute(2, 3, 0, 1)
        elif leaf == "kernel" and value.dim() == 4 and depth_at is None:
            leaf = "weight"          # conv: HWIO -> OIHW
            layout = lambda v: v.permute(3, 2, 0, 1)
        elif leaf == "kernel":
            leaf = "weight"
            layout = lambda v: v.transpose(-1, -2)
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        if depth_at is not None:  # scan-stacked: the leading axis is the layer
            for i in range(value.shape[0]):
                assign(".".join([*scope[:depth_at], str(i), *scope[depth_at + 1:], leaf]),
                       layout(value[i].to(device)), where)
        else:
            assign(".".join([*scope, leaf]), layout(value.to(device)), where)

    missing = sorted(set(own) - loaded)
    if missing:
        raise KeyError(f"the Flax tree fills no value for: {missing}")
    return module


def _scan_scope(list_name: str) -> str:
    """The Flax name of the body of the ``nn.scan`` a ModuleList stands for:
    HaMeR head's ``layers/layer``, else ``<name>/block``."""
    return "layer" if list_name == "layers" else "block"


def flax_slot(module: nn.Module, name: str) -> Tuple[tuple, Any, Callable]:
    """Where the parameter ``name`` of ``module`` lies in the Flax tree:
    (path under "params", its layer in a scan-stacked leaf or None, the map
    of its value into the Flax layout). The inverse of ``flax_to_torch``'s
    rules."""
    parts = name.split(".")
    path, layer, owner = [], None, module
    for i, part in enumerate(parts[:-1]):
        if isinstance(owner, nn.ModuleList):
            if layer is not None:
                raise ValueError(f"{name}: a ModuleList inside a ModuleList has no Flax form")
            layer = int(part)
            path.append(_scan_scope(parts[i - 1]))
        else:
            path.append(part)
        owner = owner._modules[part]
    leaf, tf = parts[-1], (lambda v: v)
    if leaf == "weight":
        if isinstance(owner, nn.Linear):
            leaf, tf = "kernel", lambda v: v.transpose(-1, -2)
        elif isinstance(owner, nn.ConvTranspose2d):       # IOHW -> HWIO, flipped
            leaf, tf = "kernel", lambda v: v.permute(2, 3, 0, 1).flip(0, 1)
        elif isinstance(owner, nn.Conv2d):                  # OIHW -> HWIO
            leaf, tf = "kernel", lambda v: v.permute(2, 3, 1, 0)
        elif isinstance(owner, nn.Embedding):
            leaf = "embedding"
        else:                                               # a norm's scale
            leaf = "scale"
    return tuple(path + [leaf]), layer, tf


def _nest(leaves: Dict[tuple, Any]) -> Dict[str, Any]:
    """{path: leaf} -> nested dicts, every level's keys sorted as a JAX tree's."""
    tree: Dict[str, Any] = {}
    for path in sorted(leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaves[path]
    return tree


def torch_to_flax(module: nn.Module) -> Dict[str, Any]:
    """The Flax parameter tree {"params": ...} of ``module``: the inverse of
    ``flax_to_torch``. ``weight`` becomes a ``kernel`` (Linear: transposed;
    Conv2d: HWIO; ConvTranspose2d: HWIO flipped in space), an ``embedding``
    (Embedding) or a ``scale`` (a norm); a ModuleList's layers are stacked on
    a leading axis under ``<name>/block`` (``layers/layer``). Leaves are new
    contiguous float32 tensors (the JAX models' ``param_dtype``) on the
    module's device: a module on the meta device
    gives the shapes and dtypes alone, the template of a converter."""
    leaves: Dict[tuple, Any] = {}
    stacked: Dict[tuple, Dict[int, torch.Tensor]] = {}
    for name, p in module.named_parameters():
        path, layer, tf = flax_slot(module, name)
        value = tf(p.detach()).to(dtype=torch.float32,
                                   memory_format=torch.contiguous_format, copy=True)
        if layer is None:
            leaves[path] = value
        else:
            stacked.setdefault(path, {})[layer] = value
    for path, layers in stacked.items():
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"{'/'.join(path)}: layers {sorted(layers)} are not 0..n-1")
        leaves[path] = torch.stack([layers[i] for i in range(len(layers))])
    return {"params": _nest(leaves)}


def random_parameter(name: str, shape, index: int, seed: int = 0,
                     device: DeviceLike = "cpu") -> torch.Tensor:
    """The float32 value ``init_random_`` gives the ``index``-th parameter
    ``name`` of ``shape``, drawn on ``device``."""
    shape = tuple(shape)
    if len(shape) >= 2:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1_000_003 + index)
        std = 1.0 / float(shape[1]) ** 0.5
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std
    if name.endswith("bias"):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return torch.ones(shape, dtype=torch.float32, device=device)


def init_random_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights, drawn on the module's device: matrices from
    N(0, 1/fan_in), norm scales one, biases zero. For smoke runs and timing;
    real weights come through a converter."""
    for index, (name, p) in enumerate(module.named_parameters()):
        with torch.no_grad():
            p.copy_(random_parameter(name, p.shape, index, seed, p.device))
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


def save_scheduler_config(cfg: dict, name: str = "hunyuan_scheduler") -> str:
    """Write the checkpoint's scheduler config where ``scheduler_config``
    reads it (``<assets>/params/<name>.json``); -> the path."""
    import json

    path = os.path.join(assets_root(), "params", f"{name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def scheduler_shift() -> float:
    """The checkpoint's sigma shift (1.0 without a config): the original
    pipeline applies it to the explicitly passed linspace(0, 1) sigmas too."""
    return float(scheduler_config().get("shift", 1.0))
