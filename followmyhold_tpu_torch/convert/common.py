"""Shared torch -> Flax-layout conversion primitives (the port's copy of the
reference's ``convert/common.py``).

Layout rules encoded once:
- torch nn.Linear weight [out, in]  -> Dense kernel [in, out] (transpose)
- torch nn.Conv2d weight [out, in, kh, kw] -> Conv kernel [kh, kw, in, out]
- torch LayerNorm weight/bias -> scale/bias
- packed qkv stays packed (both sides use one matrix here)

A converter's template is ``utils.params.torch_to_flax(Model(cfg,
device="meta"))``: the Flax tree of the port module's shapes and dtypes,
without values. ``put`` fills its leaves from the checkpoint; ``filled``
gives the leaves the checkpoint lacks (listed in ``missing_src``) the port
module's ``init_random_`` values, drawing only those. Values are torch
tensors on the host; a state dict may hold tensors or numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from followmyhold_tpu_torch.utils.params import flax_slot, random_parameter


def as_tensor(value) -> torch.Tensor:
    """A state-dict value (tensor or numpy array) as a host tensor, without a
    copy where it can be had."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    arr = np.asarray(value)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def load_checkpoint(path: str, weights_only: bool = True) -> Any:
    """``torch.load`` onto the host; a zip-format file is memory-mapped, so a
    multi-GB checkpoint is read as its tensors are converted."""
    import zipfile

    return torch.load(path, map_location="cpu", weights_only=weights_only,
                      mmap=zipfile.is_zipfile(path))


def dense_kernel(w) -> torch.Tensor:
    w = as_tensor(w)
    return w.permute(*reversed(range(w.dim())))


def conv_kernel(w) -> torch.Tensor:
    return as_tensor(w).permute(2, 3, 1, 0)


@dataclass
class ConversionReport:
    mapped: List[str] = field(default_factory=list)
    missing_src: List[str] = field(default_factory=list)
    unused_src: List[str] = field(default_factory=list)

    def summary(self) -> str:
        return (f"mapped {len(self.mapped)} tensors; "
                f"{len(self.missing_src)} missing, {len(self.unused_src)} unused")


def put(params: Dict[str, Any], flax_path: str, value, report: ConversionReport) -> None:
    """Set params['params']['a']['b']...['kernel'] = value, checking the
    shape and casting to the template's dtype (one contiguous host tensor)."""
    node = params
    keys = flax_path.split("/")
    for k in keys[:-1]:
        node = node[k]
    old = node[keys[-1]]
    value = as_tensor(value)
    if tuple(old.shape) != tuple(value.shape):
        raise ValueError(
            f"{flax_path}: shape mismatch {tuple(old.shape)} vs {tuple(value.shape)}")
    if value.dtype != old.dtype or not value.is_contiguous():
        value = torch.empty(value.shape, dtype=old.dtype).copy_(value)
    node[keys[-1]] = value
    report.mapped.append(flax_path)


def filled(params: Dict[str, Any], model: nn.Module) -> Dict[str, Any]:
    """``params`` with every leaf that no ``put`` reached (still a meta
    tensor) holding the value ``init_random_(model, 0)`` gives it on the
    host; the other leaves are left as they are."""
    root = params["params"]

    def leaf(path):
        node = root
        for key in path[:-1]:
            node = node[key]
        return node, path[-1]

    fresh: Dict[tuple, torch.Tensor] = {}
    for index, (name, p) in enumerate(model.named_parameters()):
        path, layer, tf = flax_slot(model, name)
        node, key = leaf(path)
        if node[key].device.type != "meta" and path not in fresh:
            continue
        if path not in fresh:
            fresh[path] = torch.empty(node[key].shape, dtype=node[key].dtype)
        value = tf(random_parameter(name, p.shape, index, 0))
        (fresh[path] if layer is None else fresh[path][layer]).copy_(value)
    for path, value in fresh.items():
        node, key = leaf(path)
        node[key] = value
    return params
